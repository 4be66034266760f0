"""ECMWF weather-model family: ERA5, ERA5T, ERA-I, HRES.

Counterpart of ``raider_tpu/wx/ecmwf.py``. The fetchers use the cdsapi /
ecmwfapi clients, imported inside them; a raw file is parsed on the host
and its fields go to the model's device, where the hydrostatic height
rebuild (``calcgeoh``), the flips and the transposes run.
"""

import datetime as dt

import numpy as np
import torch

from raider_tpu_torch.geodesy import Geographic
from raider_tpu_torch.io import read_nc
from raider_tpu_torch.logger import logger
from raider_tpu_torch.utils.timeutils import round_date
from raider_tpu_torch.wx import levels as _lv
from raider_tpu_torch.wx.base import TIME_RES, WeatherModel, host_to_device


class ECMWF(WeatherModel):
    """Base class for ECMWF-hosted models."""

    def __init__(self) -> None:
        super().__init__()
        # refractivity constants [K/Pa], [K/Pa], [K^2/Pa]
        self._k1 = 0.776
        self._k2 = 0.233
        self._k3 = 3.75e3

        self._time_res = TIME_RES['ECMWF']
        self._lon_res = 0.25
        self._lat_res = 0.25
        self._proj = Geographic()
        self._model_level_type = 'ml'

    def __pressure_levels__(self) -> None:
        self._zlevels = np.flipud(_lv.LEVELS_25_HEIGHTS)
        self._levels = len(self._zlevels)

    def __model_levels__(self) -> None:
        self._levels = 137
        self._zlevels = np.flipud(_lv.LEVELS_137_HEIGHTS)
        self._a = _lv.A_137_HRES
        self._b = _lv.B_137_HRES

    def load_weather(self, f=None, *args, **kwargs) -> None:
        f = f if f is not None else self.files[0]
        self._load_model_level(f)

    # ----------------------------------------------------------------- parse
    def _load_model_level(self, fname) -> None:
        """Raw model-level netCDF -> (y, x, z) cubes on the device."""
        lats, lons, xs, ys, t, q, lnsp, z = self._makeDataCubes(fname)
        t, q, lnsp, z = (host_to_device(a, self._device) for a in (t, q, lnsp, z))

        if lats[0] > lats[1]:
            z, lnsp = torch.flip(z, (0,)), torch.flip(lnsp, (0,))
            t, q = torch.flip(t, (1,)), torch.flip(q, (1,))
            lats = lats[::-1]
        if lons[0] > lons[1]:
            z, lnsp, t, q = (torch.flip(a, (-1,)) for a in (z, lnsp, t, q))
            lons = lons[::-1]
        lons = np.where(lons > 180, lons - 360, lons)

        self._t = t
        self._q = q
        geo_hgt, pres, hgt = self._calculategeoh(z, lnsp)

        self._lons, self._lats = np.meshgrid(lons, lats)
        self._get_heights(self._lats, hgt.permute(1, 2, 0))
        h = self._zs

        # (z, y, x) -> (y, x, z), then flip z bottom-up
        self._p, self._t, self._q = (torch.flip(a.permute(1, 2, 0), (2,))
                                     for a in (pres, self._t, self._q))
        self._ys = self._lats.copy()
        self._xs = self._lons.copy()
        self._zs = torch.flip(h, (2,))

    def _load_pressure_level(self, filename, *args, **kwargs) -> None:
        """Raw pressure-level netCDF -> (y, x, z) cubes on the device."""
        ds = read_nc(filename)
        z, t, q = (host_to_device(np.squeeze(np.asarray(ds[k].data)), self._device)
                   for k in ('z', 't', 'q'))
        lats = np.squeeze(np.asarray(ds['latitude'].data, dtype=np.float64))
        lons = np.squeeze(np.asarray(ds['longitude'].data, dtype=np.float64))
        levels = np.squeeze(np.asarray(ds['level'].data, dtype=np.float64)) * 100

        # the asymmetric flips (z lat-flipped unconditionally, t/q only when
        # lats descend; z level-flipped here, t/q/p at the end) are the JAX
        # package's, which follows the reference
        z = torch.flip(z, (1,))
        if lats[0] > lats[1]:
            z = torch.flip(z, (0,))
            t, q = torch.flip(t, (1,)), torch.flip(q, (1,))
            lats = lats[::-1]
        if lons[0] > lons[1]:
            z, t, q = (torch.flip(a, (-1,)) for a in (z, t, q))
            lons = lons[::-1]
        lons = np.where(lons > 180, lons - 360, lons)

        geo_hgt = (z / self._g0).permute(1, 2, 0)
        self._lons, self._lats = np.meshgrid(lons, lats)
        self._get_heights(self._lats, geo_hgt)
        self._p = host_to_device(levels, self._device)[None, None, :].expand(self._zs.shape)

        self._ys = self._lats.copy()
        self._xs = self._lons.copy()
        self._p = torch.flip(self._p, (2,))
        self._t = torch.flip(t.permute(1, 2, 0), (2,))
        self._q = torch.flip(q.permute(1, 2, 0), (2,))

    def _makeDataCubes(self, fname):
        """Raw (z, lat, lon) host arrays masked to the query bounds."""
        S, N, W, E = self._ll_bounds
        ds = read_nc(fname)
        lats_full = np.asarray(ds['latitude'].data, dtype=np.float64)
        lons_full = np.asarray(ds['longitude'].data, dtype=np.float64)
        lons_full = ((lons_full + 180) % 360) - 180

        m_lat = (S <= lats_full) & (N >= lats_full)
        m_lon = (W <= lons_full) & (E >= lons_full)

        def _get(name):
            return np.squeeze(np.asarray(ds[name].data, dtype=np.float64))

        t = _get('t')[..., m_lat, :][..., m_lon]
        q = _get('q')[..., m_lat, :][..., m_lon]
        z = _get('z')
        lnsp = _get('lnsp')
        # surface fields may carry a leading level axis of size 1 or n-levels
        if z.ndim == 3:
            z = z[0]
        if lnsp.ndim == 3:
            lnsp = lnsp[0]
        z = z[m_lat, :][:, m_lon]
        lnsp = lnsp[m_lat, :][:, m_lon]
        lats = lats_full[m_lat]
        lons = lons_full[m_lon]

        if z.size == 0:
            raise RuntimeError('There is no data in z, you may have a problem with your mask')
        return lats, lons, lons.copy(), lats.copy(), t, q, lnsp, z

    # ----------------------------------------------------------------- fetch
    def _fetch(self, out) -> None:
        lat_min, lat_max, lon_min, lon_max = self._ll_bounds
        self._get_from_ecmwf(
            lat_min, lat_max, self._lat_res, lon_min, lon_max, self._lon_res, self._time, out
        )

    def _get_from_ecmwf(self, lat_min, lat_max, lat_step, lon_min, lon_max,
                        lon_step, time, out) -> None:
        """Legacy ECMWFDataServer fetch."""
        import ecmwfapi

        server = ecmwfapi.ECMWFDataServer()
        corrected = round_date(time, dt.timedelta(hours=self._time_res))
        if corrected != time:
            logger.warning('Rounded given datetime from %s to %s', time, corrected)
        server.retrieve({
            'class': self._classname,
            'dataset': self._dataset,
            'expver': f'{self._expver}',
            'levelist': 'all',
            'levtype': 'ml',
            'param': 'lnsp/q/z/t',
            'stream': 'oper',
            'date': corrected.strftime('%Y-%m-%d'),
            'type': 'an',
            'time': corrected.strftime('%H:%M:%S'),
            'step': '0',
            'grid': f'{lat_step}/{lon_step}',
            'area': f'{lat_max}/{lon_min}/{lat_min}/{lon_max}',
            'format': 'netcdf',
            'resol': 'av',
            'target': str(out),
        })

    def _get_from_cds(self, lat_min, lat_max, lon_min, lon_max, acqTime, outname) -> None:
        """CDS API fetch for ERA5."""
        import cdsapi

        c = cdsapi.Client(verify=0)
        if getattr(c, 'url', None) == 'https://cds.climate.copernicus.eu/api/v2':
            # expired-credential detection
            logger.warning(
                'Old CDS API configuration detected: ECMWF released a breaking '
                'change in late 2024 that expired all existing credentials. '
                'This run may fail with a 404 HTTP error, in which case you '
                'may have to regenerate your CDS API credentials at '
                'https://cds.climate.copernicus.eu/how-to-api.'
            )
        var = ['z', 'q', 't'] if self._model_level_type == 'pl' else '129/130/133/152'
        corrected = round_date(acqTime, dt.timedelta(hours=self._time_res))
        if corrected != acqTime:
            logger.warning('Rounded given datetime from %s to %s', acqTime, corrected)
        c.retrieve('reanalysis-era5-complete', {
            'class': 'ea',
            'expver': '1',
            'levelist': 'all',
            'levtype': f'{self._model_level_type}',
            'param': var,
            'stream': 'oper',
            'type': 'an',
            'date': corrected.strftime('%Y-%m-%d'),
            'time': corrected.strftime('%H:%M'),
            'step': '0',
            'area': [lat_max, lon_min, lat_min, lon_max],
            'grid': [0.25, 0.25],
            'format': 'netcdf',
        }, str(outname))

    def _download_ecmwf(self, lat_min, lat_max, lat_step, lon_min, lon_max,
                        lon_step, time, out) -> None:
        """MARS fetch for HRES."""
        from ecmwfapi import ECMWFService

        server = ECMWFService('mars')
        corrected = round_date(time, dt.timedelta(hours=self._time_res))
        if corrected != time:
            logger.warning('Rounded given datetime from %s to %s', time, corrected)
        param = '129/130/133/152' if self._model_level_type == 'ml' else '129.128/130.128/133.128/152'
        lon_floor = lon_min - (lon_min % 0.1)
        lat_floor = lat_min - (lat_min % 0.1)
        server.execute({
            'class': self._classname,
            'dataset': self._dataset,
            'expver': f'{self._expver}',
            'resol': 'av',
            'stream': 'oper',
            'type': 'an',
            'levelist': 'all',
            'levtype': f'{self._model_level_type}',
            'param': param,
            'date': corrected.strftime('%Y-%m-%d'),
            'time': corrected.time().strftime('%H:%M'),
            'step': '0',
            'grid': f'{lon_step}/{lat_step}',
            'area': f'{lat_max}/{lon_floor}/{lat_floor}/{lon_max}',
            'format': 'netcdf',
        }, str(out))


class ERA5(ECMWF):
    """ERA5 reanalysis: CDS API, 137 model levels, 0.25 degrees."""

    def __init__(self) -> None:
        super().__init__()
        self._humidityType = 'q'
        self._expver = '0001'
        self._classname = 'ea'
        self._dataset = 'era5'
        self._Name = 'ERA-5'
        self._proj = Geographic()

        lag_months = 3
        today = dt.datetime.now(dt.timezone.utc)
        # subtract ~3 months without external deps
        month = today.month - lag_months
        year = today.year
        while month < 1:
            month += 12
            year -= 1
        end_date = today.replace(year=year, month=month, day=min(today.day, 28))
        self._valid_range = (
            dt.datetime(1950, 1, 1, tzinfo=dt.timezone.utc),
            end_date,
        )
        self._lag_time = dt.timedelta(days=31 * lag_months)
        self.setLevelType('ml')

    def _fetch(self, out) -> None:
        lat_min, lat_max, lon_min, lon_max = self._ll_bounds
        self._get_from_cds(lat_min, lat_max, lon_min, lon_max, self._time, out)

    def load_weather(self, f=None, *args, **kwargs) -> None:
        f = self.files[0] if f is None else f
        if self._model_level_type == 'pl':
            self._load_pressure_level(f, *args, **kwargs)
        elif self._model_level_type == 'ml':
            self._load_model_level(f)
        else:
            raise RuntimeError(f'{self._model_level_type} is not a valid model type')


class ERA5T(ERA5):
    """Near-real-time ERA5 (expver 0005)."""

    def __init__(self) -> None:
        super().__init__()
        self._expver = '0005'
        self._dataset = 'era5t'
        self._Name = 'ERA-5T'
        self._valid_range = (
            dt.datetime(1950, 1, 1, tzinfo=dt.timezone.utc),
            dt.datetime.now(dt.timezone.utc),
        )
        self._lag_time = dt.timedelta(days=1)


class ERAI(ECMWF):
    """ERA-Interim: 60 model levels, valid 1979 to 2019-08-31."""

    def __init__(self) -> None:
        super().__init__()
        self._classname = 'ei'
        self._expver = '0001'
        self._dataset = 'interim'
        self._Name = 'ERA-I'
        self.setLevelType('ml')
        self._valid_range = (
            dt.datetime(1979, 1, 1, tzinfo=dt.timezone.utc),
            dt.datetime(2019, 8, 31, tzinfo=dt.timezone.utc),
        )
        self._lag_time = dt.timedelta(days=30)

    def __model_levels__(self) -> None:
        self._levels = 60
        self._a = _lv.A_ERAI
        self._b = _lv.B_ERAI

    def __pressure_levels__(self) -> None:
        raise RuntimeError('ERA-I does not use pressure levels, you need to use model levels')


class HRES(ECMWF):
    """ECMWF operational HRES via MARS, 9 km, 137 (91 pre-2013-06-26)
    levels."""

    def __init__(self, level_type: str = 'ml') -> None:
        WeatherModel.__init__(self)
        self._k1 = 0.776
        self._k2 = 0.233
        self._k3 = 3.75e3

        self._lon_res = 9.0 / 111
        self._lat_res = 9.0 / 111
        self._x_res = 9.0 / 111
        self._y_res = 9.0 / 111

        self._humidityType = 'q'
        self._expver = '1'
        self._classname = 'od'
        self._dataset = 'hres'
        self._Name = 'HRES'
        self._proj = Geographic()
        self._time_res = TIME_RES['HRES']
        self._valid_range = (
            dt.datetime(1983, 4, 20, tzinfo=dt.timezone.utc),
            dt.datetime.now(dt.timezone.utc),
        )
        self._lag_time = dt.timedelta(hours=6)
        self.setLevelType(level_type)

    def update_a_b(self) -> None:
        """Pre-2013-06-26 91-level coefficients."""
        self._levels = 91
        self._zlevels = np.flipud(_lv.LEVELS_91_HEIGHTS)
        self._a = _lv.A_91_HRES
        self._b = _lv.B_91_HRES

    def load_weather(self, f=None) -> None:
        f = self.files[0] if f is None else f
        if self._model_level_type == 'ml':
            cutoff = dt.datetime(2013, 6, 26, tzinfo=dt.timezone.utc)
            t = self._time if self._time.tzinfo else self._time.replace(tzinfo=dt.timezone.utc)
            if t < cutoff:
                self.update_a_b()
            self._load_model_level(f)
        elif self._model_level_type == 'pl':
            self._load_pressure_level(f)

    def _fetch(self, out) -> None:
        lat_min, lat_max, lon_min, lon_max = self._ll_bounds
        cutoff = dt.datetime(2013, 6, 26, tzinfo=dt.timezone.utc)
        if self._time < cutoff:
            self.update_a_b()
        self._download_ecmwf(lat_min, lat_max, self._lat_res, lon_min, lon_max,
                             self._lon_res, self._time, out)
