"""NCMRWF NCUM ("NCMR") weather model.

Counterpart of ``raider_tpu/wx/ncmr.py``. The fetcher downloads from the
NCMRWF server with the credentials in ~/.ncmrlogin; the reader takes the
raw h/q/p/t netCDF written at fetch time (levels bottom up, not flipped)
and puts its fields on the model's device.
"""

import datetime as dt
import urllib.request
from pathlib import Path
from typing import Tuple

import numpy as np

from raider_tpu_torch.geodesy import Geographic
from raider_tpu_torch.io import read_nc
from raider_tpu_torch.logger import logger
from raider_tpu_torch.wx.base import TIME_RES, WeatherModel, host_to_device
from raider_tpu_torch.wx.gmao import write_weather_vars
from raider_tpu_torch.wx.levels import LEVELS_137_HEIGHTS


def read_NCMR_loginInfo(filepath: str = None) -> Tuple[str, str, str]:
    """Read url/username/password from ~/.ncmrlogin."""
    if filepath is None:
        filepath = str(Path.home() / '.ncmrlogin')
    lines = Path(filepath).read_text().splitlines()
    if len(lines) < 3:
        raise ValueError('The login file must have at least three lines')

    def parse_line(line, expected_key):
        parts = line.strip().split(': ')
        if len(parts) != 2 or parts[0] != expected_key:
            raise ValueError(f"Improperly formatted login file: expected '{expected_key}: <value>'")
        return parts[1]

    return (parse_line(lines[0], 'url'), parse_line(lines[1], 'username'),
            parse_line(lines[2], 'password'))


def _show_progress(block_num: int, block_size: int, total_size: int) -> None:
    """urlretrieve reporthook: log download progress every ~10%."""
    if total_size <= 0:
        return
    done = block_num * block_size
    pct = int(100 * done / total_size)
    prev = int(100 * (done - block_size) / total_size)
    if pct // 10 != prev // 10:
        logger.info('NCMR download: %d%%', min(pct, 100))


class NCMR(WeatherModel):
    """NCUM global model: 0.117 x 0.176 degrees, 137-level height ladder."""

    def __init__(self) -> None:
        super().__init__()
        self._humidityType = 'q'
        self._model_level_type = 'ml'
        self._classname = 'ncmr'
        self._dataset = 'ncmr'
        self._Name = 'NCMR'
        self._time_res = TIME_RES['NCMR']
        self._valid_range = (
            dt.datetime(2015, 12, 1, tzinfo=dt.timezone.utc),
            dt.datetime.now(dt.timezone.utc),
        )
        self._lag_time = dt.timedelta(hours=6)

        self._k1 = 0.776
        self._k2 = 0.233
        self._k3 = 3.75e3

        self._lon_res = 0.17578125
        self._lat_res = 0.11718750
        self._x_res = 0.17578125
        self._y_res = 0.11718750

        self._zlevels = np.flipud(LEVELS_137_HEIGHTS)
        self._proj = Geographic()

    def _fetch(self, out) -> None:
        self._download_ncmr_file(out, self._time, self._ll_bounds)

    def _download_ncmr_file(self, out, date_time, bounding_box) -> None:
        """Download the day's analysis file and crop to the bbox."""
        from scipy.io import netcdf_file

        url, username, password = read_NCMR_loginInfo()
        filename = f'ncum_ana_ml_{date_time.strftime("%Y%m%d")}.nc'
        remote = f'{url}/{date_time.strftime("%Y%m%d")}/{filename}'
        local = Path(str(out)).parent / filename

        if not local.exists():
            password_mgr = urllib.request.HTTPPasswordMgrWithDefaultRealm()
            password_mgr.add_password(None, remote, username, password)
            handler = urllib.request.HTTPBasicAuthHandler(password_mgr)
            opener = urllib.request.build_opener(handler)
            urllib.request.install_opener(opener)
            logger.info('Downloading %s', remote)
            urllib.request.urlretrieve(remote, str(local), _show_progress)

        with netcdf_file(str(local), 'r', maskandscale=True) as f:
            lats_full = f.variables['latitude'][:].copy()
            lons_full = f.variables['longitude'][:].copy()

            lat_min_ind = int((bounding_box[0] - (-89.94141)) / self._lat_res)
            lat_max_ind = int((bounding_box[1] - (-89.94141)) / self._lat_res)
            if bounding_box[2] < 0:
                lon_min_ind = int((bounding_box[2] + 360.0 - 0.087890625) / self._lon_res)
            else:
                lon_min_ind = int((bounding_box[2] - 0.087890625) / self._lon_res)
            if bounding_box[3] < 0:
                lon_max_ind = int((bounding_box[3] + 360.0 - 0.087890625) / self._lon_res)
            else:
                lon_max_ind = int((bounding_box[3] - 0.087890625) / self._lon_res)

            ml_min, ml_max = 1, 70  # skip lowest (below 20 m) level
            t = f.variables['air_temperature'][ml_min:ml_max + 1,
                                               lat_min_ind:lat_max_ind + 1,
                                               lon_min_ind:lon_max_ind + 1].copy()
            q = f.variables['specific_humidity'][ml_min:ml_max + 1,
                                                 lat_min_ind:lat_max_ind + 1,
                                                 lon_min_ind:lon_max_ind + 1].copy()
            p = f.variables['air_pressure'][ml_min:ml_max + 1,
                                            lat_min_ind:lat_max_ind + 1,
                                            lon_min_ind:lon_max_ind + 1].copy()
            h = f.variables['height_levels'][ml_min:ml_max + 1,
                                             lat_min_ind:lat_max_ind + 1,
                                             lon_min_ind:lon_max_ind + 1].copy()
            lats = lats_full[lat_min_ind:lat_max_ind + 1]
            lons = lons_full[lon_min_ind:lon_max_ind + 1]

        lons = np.where(lons > 180, lons - 360, lons)
        lon_grid, lat_grid = np.meshgrid(lons, lats)
        write_weather_vars(lat_grid, lon_grid, h, q, p, t, date_time, self._proj, out)

    def load_weather(self, f=None, *args, **kwargs) -> None:
        f = self.files[0] if f is None else f
        self._makeDataCubes(f)

    def _makeDataCubes(self, filename) -> None:
        """Raw h/q/p/t file (levels bottom up) -> (y, x, z) cubes on the device."""
        ds = read_nc(filename)
        lats2 = np.asarray(ds['latitude'].data, dtype=np.float64)
        lons2 = np.asarray(ds['longitude'].data, dtype=np.float64)
        lats = lats2[:, 0] if lats2.ndim == 2 else lats2
        lons = lons2[0, :] if lons2.ndim == 2 else lons2
        h, q, p, t = (host_to_device(np.asarray(ds[k].data), self._device).permute(1, 2, 0)
                      for k in ('h', 'q', 'p', 't'))
        self._p, self._q, self._t, zs = p, q, t, h

        _lons, _lats = np.meshgrid(lons, lats)
        self._lats = _lats
        self._lons = _lons
        self._xs = _lons.copy()
        self._ys = _lats.copy()
        self._zs = zs
