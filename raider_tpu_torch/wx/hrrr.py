"""NOAA HRRR (CONUS) and HRRR-AK weather models.

Counterpart of ``raider_tpu/wx/hrrr.py``. The fetcher uses Herbie (AWS GRIB
subsets), imported inside it; a raw netCDF is parsed on the host and its
fields go to the model's device. Native 3 km grids in Lambert conformal
conic (CONUS) and polar stereographic (Alaska), both on the NCEP 6371229 m
sphere.
"""

import datetime as dt

import numpy as np

from raider_tpu_torch.geodesy import (SPHERE_6371229, Geographic, LambertConformalConic,
                                      PolarStereographic, crs_from_cf, transform_points)
from raider_tpu_torch.io import read_nc
from raider_tpu_torch.logger import logger
from raider_tpu_torch.utils import require_device
from raider_tpu_torch.utils.geom2d import polygon_contains_box, polygon_intersects_box
from raider_tpu_torch.utils.timeutils import round_date
from raider_tpu_torch.wx.base import TIME_RES, WeatherModel, host_to_device
from raider_tpu_torch.wx.exceptions import NoWeatherModelData
from raider_tpu_torch.wx.levels import LEVELS_50_HEIGHTS

HRRR_CONUS_COVERAGE_POLYGON = [(-125, 21), (-133, 49), (-60, 49), (-72, 21)]
HRRR_AK_COVERAGE_POLYGON = [(195, 40), (157, 55), (175, 70), (260, 77), (232, 52)]

HRRR_CONUS_PROJ = LambertConformalConic(
    lat_0=38.5, lon_0=262.5, lat_1=38.5, lat_2=38.5, ellipsoid=SPHERE_6371229
)
HRRR_AK_PROJ = PolarStereographic(
    lat_0=90.0, lon_0=225.0, lat_ts=60.0, ellipsoid=SPHERE_6371229
)


def check_hrrr_dataset_availability(datetime: dt.datetime, model: str = 'hrrr') -> bool:
    """Probe Herbie for file availability."""
    from herbie import Herbie

    herbie = Herbie(datetime, model=model, product='nat', fxx=0)
    return herbie.grib is not None


def get_bounds_indices(snwe, lats, lons):
    """SNWE lat/lon bounds -> 2-D index bounds on a curvilinear grid."""
    S, N, W, E = snwe
    if W < E:
        m1 = (S <= lats) & (N >= lats) & (W <= lons) & (E >= lons)
    else:
        raise ValueError(
            'Longitude is either flipped or you are crossing the international date line; '
            'if the latter please give me longitudes from 0-360'
        )
    if np.sum(m1) == 0:
        lons = np.mod(lons, 360)
        W, E = np.mod([W, E], 360)
        m1 = (S <= lats) & (N >= lats) & (W <= lons) & (E >= lons)
        if np.sum(m1) == 0:
            raise NoWeatherModelData('Area of Interest has no overlap with the HRRR model available extent')
    shp = lats.shape
    m1_y = np.argwhere(np.sum(m1, axis=1) != 0)
    y_min = max(m1_y[0][0], 0)
    y_max = min(m1_y[-1][0], shp[0])
    m1_x = np.argwhere(np.sum(m1, axis=0) != 0)
    x_min = max(m1_x[0][0], 0)
    x_max = min(m1_x[-1][0], shp[1])
    return x_min, x_max, y_min, y_max


def download_hrrr_file(ll_bounds, date, out, model: str = 'hrrr', product: str = 'nat',
                       fxx: int = 0, verbose: bool = False) -> None:
    """Herbie GRIB-subset download -> cropped netCDF."""
    import os
    from pathlib import Path

    from herbie import Herbie

    herbie = Herbie(
        date.strftime('%Y-%m-%d %H:%M'),
        model=model, product=product, fxx=fxx,
        overwrite=False, verbose=True,
        save_dir=Path(os.path.dirname(str(out))),
    )
    ds_list = herbie.xarray(':(SPFH|PRES|TMP|HGT):', verbose=verbose)
    ds_out = None
    for ds in ds_list:
        if 'hybrid' in ds._coord_names:
            ds_out, coord = ds, 'hybrid'
            break
    else:
        for ds in ds_list:
            if 'isobaricInhPa' in ds._coord_names:
                ds_out, coord = ds, 'isobaricInhPa'
                break
        else:
            raise RuntimeError('Herbie did not obtain an HRRR dataset with the expected layers')

    x_min, x_max, y_min, y_max = get_bounds_indices(
        ll_bounds, ds_out.latitude.to_numpy(), ds_out.longitude.to_numpy()
    )
    ds_out = ds_out.rename({'gh': 'z', coord: 'levels'})

    proj = HRRR_AK_PROJ if model == 'hrrrak' else HRRR_CONUS_PROJ
    ds_out['proj'] = 0
    for k, v in proj.to_cf().items():
        ds_out.proj.attrs[k] = v
    for var in ds_out.data_vars:
        ds_out[var].attrs['grid_mapping'] = 'proj'

    xl, yl = (v.numpy() for v in transform_points(
        Geographic(), proj, ds_out['longitude'].values, ds_out['latitude'].values)[:2])
    W, E = np.nanmin(xl), np.nanmax(xl)
    S, N = np.nanmin(yl), np.nanmax(yl)
    grid = 3000.0
    ds_out['x'] = np.arange(W, E + grid / 2, grid)
    ds_out['y'] = np.arange(S, N + grid / 2, grid)
    ds_sub = ds_out.isel(x=slice(x_min, x_max), y=slice(y_min, y_max))
    ds_sub.to_netcdf(out, engine='netcdf4')


def load_weather_hrrr(filename, device='cuda'):
    """Raw HRRR netCDF -> fields on ``device``: the (y, x, z) views of the
    file's (z, y, x) q, t, pressure and geopotential height as float64
    tensors, with the host axes (x and y as 1-D arrays: the JAX reader's
    broadcasts of them hold the same values), the longitude/latitude grids
    and the CRS."""
    device = require_device(device)
    ds = read_nc(filename)

    pres, temps, qs, geo_hgt = (host_to_device(ds[k].data, device).permute(1, 2, 0)
                                for k in ('pres', 't', 'q', 'z'))
    xs = np.asarray(ds['x'].data, dtype=np.float64)
    ys = np.asarray(ds['y'].data, dtype=np.float64)
    lats = np.asarray(ds['latitude'].data, dtype=np.float64)
    lons = np.asarray(ds['longitude'].data, dtype=np.float64)
    proj = crs_from_cf(ds['proj'].attrs)
    lons = np.where(lons > 180, lons - 360, lons)
    return xs, ys, lons, lats, qs, temps, pres, geo_hgt, proj


class HRRR(WeatherModel):
    """HRRR CONUS: 3 km LCC grid, 50 native levels."""

    def __init__(self) -> None:
        super().__init__()
        self._humidityType = 'q'
        self._model_level_type = 'pl'
        self._expver = '0001'
        self._classname = 'hrrr'
        self._dataset = 'hrrr'
        self._time_res = TIME_RES['HRRR']
        self._valid_range = (
            dt.datetime(2016, 7, 15, tzinfo=dt.timezone.utc),
            dt.datetime.now(dt.timezone.utc),
        )
        self._lag_time = dt.timedelta(hours=3)

        self._k1 = 0.776
        self._k2 = 0.233
        self._k3 = 3.75e3

        self._lat_res = 3.0 / 111
        self._lon_res = 3.0 / 111
        self._x_res = 3.0
        self._y_res = 3.0

        self._Name = 'HRRR'
        self.files = None
        self._proj = HRRR_CONUS_PROJ
        self._valid_bounds = HRRR_CONUS_COVERAGE_POLYGON
        self.setLevelType('nat')

    def __model_levels__(self) -> None:
        self._levels = 50
        self._zlevels = np.flipud(LEVELS_50_HEIGHTS)

    def __pressure_levels__(self) -> None:
        raise NotImplementedError('Pressure levels do not go high enough for HRRR.')

    def _fetch(self, out) -> None:
        corrected = round_date(self._time, dt.timedelta(hours=self._time_res))
        self.checkTime(corrected)
        if corrected != self._time:
            logger.info('Rounded given datetime from %s to %s', self._time, corrected)
        bounds = np.asarray(self._ll_bounds, dtype=np.float64).copy()
        bounds[2:] = np.mod(bounds[2:], 360)
        download_hrrr_file(bounds, corrected, out, 'hrrr', self._model_level_type)

    def _cast_to_hrrrak(self) -> None:
        """Switch to the Alaska domain in place."""
        self.__class__ = HRRRAK
        self._dataset = 'hrrrak'
        self._valid_bounds = HRRR_AK_COVERAGE_POLYGON
        self._proj = HRRR_AK_PROJ
        self._Name = 'HRRR-AK'
        self._time_res = TIME_RES['HRRR-AK']
        self._valid_range = (
            dt.datetime(2018, 7, 13, tzinfo=dt.timezone.utc),
            dt.datetime.now(dt.timezone.utc),
        )
        self.setLevelType('nat')

    def load_weather(self, f=None, *args, **kwargs) -> None:
        if f is None:
            f = self.files[0] if isinstance(self.files, list) else self.files
        xs, ys, lons, lats, qs, temps, pres, geo_hgt, proj = load_weather_hrrr(f, self._device)
        self._get_heights(lats, geo_hgt)
        self._t = temps
        self._q = qs
        self._p = pres
        self._xs = xs
        self._ys = ys
        self._lats = lats
        self._lons = lons
        self._proj = proj

    def checkValidBounds(self, ll_bounds) -> None:
        """Coverage check with automatic CONUS -> Alaska cast."""
        S, N, W, E = ll_bounds
        aoi = (W, S, E, N)
        if polygon_contains_box(self._valid_bounds, aoi):
            return
        if polygon_intersects_box(self._valid_bounds, aoi):
            logger.critical('The HRRR weather model extent does not completely cover your AOI!')
            return
        logger.info('The HRRR weather model extent does not include your AOI!')
        logger.info('Checking the HRRR-AK model.')
        W2, E2 = np.mod([W, E], 360)
        aoi2 = (W2, S, E2, N)
        if polygon_contains_box(HRRR_AK_COVERAGE_POLYGON, aoi2):
            self._cast_to_hrrrak()
            logger.info('Casting self to the HRRR-AK weather model.')
        elif polygon_intersects_box(HRRR_AK_COVERAGE_POLYGON, aoi2):
            self._cast_to_hrrrak()
            logger.info('Casting self to the HRRR-AK weather model.')
            logger.critical('The HRRR-AK weather model extent does not completely cover your AOI!')
        else:
            raise ValueError('The requested location is unavailable for HRRR')


class HRRRAK(WeatherModel):
    """HRRR Alaska: 3 km polar-stereographic grid."""

    def __init__(self) -> None:
        super().__init__()
        self._k1 = 0.776
        self._k2 = 0.233
        self._k3 = 3.75e3

        self._lat_res = 3.0 / 111
        self._lon_res = 3.0 / 111
        self._x_res = 3.0
        self._y_res = 3.0

        self.files = None
        self._humidityType = 'q'
        self._classname = 'hrrrak'
        self._dataset = 'hrrrak'
        self._Name = 'HRRR-AK'
        self._time_res = TIME_RES['HRRR-AK']
        self._valid_range = (
            dt.datetime(2018, 7, 13, tzinfo=dt.timezone.utc),
            dt.datetime.now(dt.timezone.utc),
        )
        self._lag_time = dt.timedelta(hours=3)
        self._valid_bounds = HRRR_AK_COVERAGE_POLYGON
        self._proj = HRRR_AK_PROJ
        self.setLevelType('nat')

    def __model_levels__(self) -> None:
        self._levels = 50
        self._zlevels = np.flipud(LEVELS_50_HEIGHTS)

    def __pressure_levels__(self) -> None:
        raise NotImplementedError(
            'Pressure levels from HRRR-AK do not go high enough for delay calculations.'
        )

    def _fetch(self, out) -> None:
        bounds = np.asarray(self._ll_bounds, dtype=np.float64).copy()
        bounds[2:] = np.mod(bounds[2:], 360)
        corrected = round_date(self._time, dt.timedelta(hours=self._time_res))
        self.checkTime(corrected)
        if corrected != self._time:
            logger.info('Rounded given datetime from %s to %s', self._time, corrected)
        download_hrrr_file(bounds, corrected, out, 'hrrrak', self._model_level_type)

    def load_weather(self, f=None, *args, **kwargs) -> None:
        if f is None:
            f = self.files[0] if isinstance(self.files, list) else self.files
        xs, ys, lons, lats, qs, temps, pres, geo_hgt, proj = load_weather_hrrr(f, self._device)
        self._get_heights(lats, geo_hgt)
        self._t = temps
        self._q = qs
        self._p = pres
        self._xs = xs
        self._ys = ys
        self._lats = lats
        self._lons = lons
        self._proj = proj

    def checkValidBounds(self, ll_bounds) -> None:
        S, N, W, E = ll_bounds
        W2, E2 = np.mod([W, E], 360)
        aoi = (W2, S, E2, N)
        if polygon_contains_box(self._valid_bounds, aoi):
            return
        if polygon_intersects_box(self._valid_bounds, aoi):
            logger.critical('The HRRR-AK weather model extent does not completely cover your AOI!')
            return
        raise ValueError('The requested location is unavailable for HRRR-AK')
