"""NASA MERRA-2 reanalysis via OpenDAP + EarthData login.

Counterpart of ``raider_tpu/wx/merra2.py``. Raw files store the levels top
down; the reader flips them.
"""

import datetime as dt

import numpy as np

from raider_tpu_torch.geodesy import Geographic
from raider_tpu_torch.io import read_nc
from raider_tpu_torch.logger import logger
from raider_tpu_torch.utils.timeutils import round_date
from raider_tpu_torch.wx.base import WeatherModel, host_to_device
from raider_tpu_torch.wx.gmao import _earthdata_credentials, _restack, write_weather_vars


class MERRA2(WeatherModel):
    """MERRA-2: 72 levels, 0.5 x 0.625 degrees, valid from 1980."""

    def __init__(self) -> None:
        super().__init__()
        self._humidityType = 'q'
        self._model_level_type = 'ml'
        self._classname = 'merra2'
        self._dataset = 'merra2'
        self._Name = 'MERRA2'
        self._time_res = 3

        self._valid_range = (
            dt.datetime(1980, 1, 1, tzinfo=dt.timezone.utc),
            dt.datetime.now(dt.timezone.utc),
        )
        self._lag_time = dt.timedelta(days=35)

        self._k1 = 0.776
        self._k2 = 0.233
        self._k3 = 3.75e3

        self._lat_res = 0.5
        self._lon_res = 0.625
        self._x_res = 0.625
        self._y_res = 0.5

        self._proj = Geographic()

    def _fetch(self, out) -> None:
        """OpenDAP download."""
        from pydap.cas.urs import setup_session
        from pydap.client import open_url

        time = round_date(self._time, dt.timedelta(hours=self._time_res))
        if time != self._time:
            logger.warning('Rounded given datetime from %s to %s', self._time, time)

        lat_min, lat_max, lon_min, lon_max = self._ll_bounds
        lat_min_ind = int((lat_min + 90.0) / self._lat_res)
        lat_max_ind = int((lat_max + 90.0) / self._lat_res)
        lon_min_ind = int((lon_min + 180.0) / self._lon_res)
        lon_max_ind = int((lon_max + 180.0) / self._lon_res)

        # MERRA-2 production stream by era:
        # 100 for 1980-1991, 200 for 1992-2000, 300 for 2001-2010, 400 since
        if time.year < 1992:
            stream = 100
        elif time.year < 2001:
            stream = 200
        elif time.year < 2011:
            stream = 300
        else:
            stream = 400
        url = (
            f'https://goldsmr5.gesdisc.eosdis.nasa.gov/opendap/MERRA2/M2I3NVASM.5.12.4/'
            f'{time.year}/{time.month:02d}/MERRA2_{stream}.inst3_3d_asm_Nv.{time.strftime("%Y%m%d")}.nc4'
        )
        session = setup_session(*_earthdata_credentials(), check_url=url)
        ds = open_url(url, session=session)

        time_ind = int(time.hour / self._time_res)
        ml_min, ml_max = 0, 71
        q = ds['QV'][time_ind, ml_min:ml_max + 1,
                     lat_min_ind:lat_max_ind + 1, lon_min_ind:lon_max_ind + 1].data.squeeze()
        p = ds['PL'][time_ind, ml_min:ml_max + 1,
                     lat_min_ind:lat_max_ind + 1, lon_min_ind:lon_max_ind + 1].data.squeeze()
        t = ds['T'][time_ind, ml_min:ml_max + 1,
                    lat_min_ind:lat_max_ind + 1, lon_min_ind:lon_max_ind + 1].data.squeeze()
        h = ds['H'][time_ind, ml_min:ml_max + 1,
                    lat_min_ind:lat_max_ind + 1, lon_min_ind:lon_max_ind + 1].data.squeeze()

        lats = np.arange(-90 + lat_min_ind * self._lat_res,
                         -90 + (lat_max_ind + 1) * self._lat_res, self._lat_res)
        lons = np.arange(-180 + lon_min_ind * self._lon_res,
                         -180 + (lon_max_ind + 1) * self._lon_res, self._lon_res)
        lon_grid, lat_grid = np.meshgrid(lons, lats)
        write_weather_vars(lat_grid, lon_grid, h, q, p, t, time, self._proj, out)

    def load_weather(self, f=None, *args, **kwargs) -> None:
        f = self.files[0] if f is None else f
        self._load_model_level(f)

    def _load_model_level(self, filename) -> None:
        """Raw h/q/p/t file (levels top down) -> (y, x, z) cubes on the device."""
        ds = read_nc(filename)
        lats2 = np.asarray(ds['latitude'].data, dtype=np.float64)
        lons2 = np.asarray(ds['longitude'].data, dtype=np.float64)
        lats = lats2[:, 0] if lats2.ndim == 2 else lats2
        lons = lons2[0, :] if lons2.ndim == 2 else lons2
        h, q, p, t = (host_to_device(np.asarray(ds[k].data), self._device) for k in ('h', 'q', 'p', 't'))
        self._p, self._q, self._t, zs = (_restack(a) for a in (p, q, t, h))

        _lons, _lats = np.meshgrid(lons, lats)
        self._lats = _lats
        self._lons = _lons
        self._xs = _lons.copy()
        self._ys = _lats.copy()
        self._zs = zs
