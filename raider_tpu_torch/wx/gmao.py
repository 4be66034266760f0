"""NASA GEOS-5 FP (GMAO) weather model via OpenDAP.

Counterpart of ``raider_tpu/wx/gmao.py``. The fetcher needs the pydap
client, imported inside it; a raw file is parsed on the host and its fields
go to the model's device.
"""

import datetime as dt

import numpy as np
import torch

from raider_tpu_torch.geodesy import Geographic
from raider_tpu_torch.io import Dataset, Variable, read_nc, write_nc
from raider_tpu_torch.logger import logger
from raider_tpu_torch.utils.timeutils import round_date
from raider_tpu_torch.wx.base import TIME_RES, WeatherModel, host_to_device


def write_weather_vars(lat, lon, h, q, p, t, datetime, crs, outName) -> None:
    """Write raw h/q/p/t cubes."""
    attrs = {
        'datetime': datetime.strftime('%Y_%m_%dT%H_%M_%S'),
        'date_created': dt.datetime.now().strftime('%Y_%m_%dT%H_%M_%S'),
        'NoDataValue': -9999,
    }
    variables = {
        'latitude': Variable(('y', 'x'), np.asarray(lat), {}),
        'longitude': Variable(('y', 'x'), np.asarray(lon), {}),
        'h': Variable(('z', 'y', 'x'), np.asarray(h), {'standard_name': 'mid_layer_heights', 'units': 'm'}),
        'q': Variable(('z', 'y', 'x'), np.asarray(q), {'standard_name': 'specific_humidity', 'units': 'kg kg-1'}),
        'p': Variable(('z', 'y', 'x'), np.asarray(p), {'standard_name': 'mid_level_pressure', 'units': 'Pa'}),
        't': Variable(('z', 'y', 'x'), np.asarray(t), {'standard_name': 'air_temperature', 'units': 'K'}),
    }
    proj_attrs = dict(crs.to_cf())
    proj_attrs['grid_mapping'] = 'proj'
    variables['proj'] = Variable((), np.int64(0), proj_attrs)
    write_nc(Dataset(coords={}, variables=variables, attrs=attrs), outName)


class GMAO(WeatherModel):
    """GEOS-5 FP: 72 levels, 0.25 x 0.3125 degrees."""

    def __init__(self) -> None:
        super().__init__()
        self._humidityType = 'q'
        self._model_level_type = 'ml'
        self._classname = 'gmao'
        self._dataset = 'gmao'
        self._Name = 'GMAO'
        self._time_res = TIME_RES['GMAO']

        self._valid_range = (
            dt.datetime(2014, 2, 20, tzinfo=dt.timezone.utc),
            dt.datetime.now(dt.timezone.utc),
        )
        self._lag_time = dt.timedelta(hours=24)

        # model constants
        self._k1 = 0.776
        self._k2 = 0.233
        self._k3 = 3.75e3

        self._lat_res = 0.25
        self._lon_res = 0.3125
        self._x_res = 0.3125
        self._y_res = 0.25

        self._proj = Geographic()

    def _fetch(self, out) -> None:
        """Index-sliced OpenDAP download of p/t/q/heights."""
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

        t0 = dt.datetime(2017, 12, 1, 0, 0, 0, tzinfo=dt.timezone.utc)
        time_ind = int((time - t0).total_seconds() / 10800.0)

        ml_min, ml_max = 0, 71
        url = (
            'https://opendap.nccs.nasa.gov/dods/GEOS-5/fp/0.25_deg/assim/inst3_3d_asm_Nv'
        )
        session = setup_session(*_earthdata_credentials(), check_url=url)
        ds = open_url(url, session=session)

        q = ds['qv'][time_ind, ml_min:ml_max + 1,
                     lat_min_ind:lat_max_ind + 1, lon_min_ind:lon_max_ind + 1].data.squeeze()
        p = ds['pl'][time_ind, ml_min:ml_max + 1,
                     lat_min_ind:lat_max_ind + 1, lon_min_ind:lon_max_ind + 1].data.squeeze()
        t = ds['t'][time_ind, ml_min:ml_max + 1,
                    lat_min_ind:lat_max_ind + 1, lon_min_ind:lon_max_ind + 1].data.squeeze()
        h = ds['h'][time_ind, ml_min:ml_max + 1,
                    lat_min_ind:lat_max_ind + 1, lon_min_ind:lon_max_ind + 1].data.squeeze()

        lats = np.arange(-90 + lat_min_ind * self._lat_res,
                         -90 + (lat_max_ind + 1) * self._lat_res, self._lat_res)
        lons = np.arange(-180 + lon_min_ind * self._lon_res,
                         -180 + (lon_max_ind + 1) * self._lon_res, self._lon_res)
        lon_grid, lat_grid = np.meshgrid(lons, lats)
        write_weather_vars(lat_grid, lon_grid, h, q, p, t, time, self._proj, out)

    def load_weather(self, f=None) -> None:
        f = self.files[0] if f is None else f
        self._load_model_level(f)

    def _load_model_level(self, filename) -> None:
        """Raw h/q/p/t file -> (y, x, z) cubes on the device, z bottom up."""
        ds = read_nc(filename)
        # raw files may use x/y 1-D or latitude/longitude 2-D conventions
        if 'latitude' in ds:
            lats2 = np.asarray(ds['latitude'].data, dtype=np.float64)
            lons2 = np.asarray(ds['longitude'].data, dtype=np.float64)
            if lats2.ndim == 2:
                lats = lats2[:, 0]
                lons = lons2[0, :]
            else:
                lats, lons = lats2, lons2
        else:
            lons = np.asarray(ds['x'].data, dtype=np.float64)
            lats = np.asarray(ds['y'].data, dtype=np.float64)
        h, q, p, t = (host_to_device(np.asarray(ds[a if a in ds else b].data), self._device)
                      for a, b in (('h', 'H'), ('q', 'QV'), ('p', 'PL'), ('t', 'T')))

        _lons, _lats = np.meshgrid(lons, lats)
        self._p, self._q, self._t, h = (_restack(a) for a in (p, q, t, h))
        self._lats = _lats
        self._lons = _lons
        self._xs = _lons.copy()
        self._ys = _lats.copy()
        self._zs = h


def _restack(a):
    """(z, y, x) -> (y, x, z) with z flipped bottom-up."""
    return torch.flip(a.permute(1, 2, 0), (2,))


def _earthdata_credentials():
    from netrc import netrc

    nrc = netrc()
    try:
        usr, _, pwd = nrc.hosts['urs.earthdata.nasa.gov']
        return usr, pwd
    except KeyError:
        raise KeyError('No entry for urs.earthdata.nasa.gov in ~/.netrc')
