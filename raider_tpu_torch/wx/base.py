"""Weather-model base class: the refractivity preprocessing pipeline.

Counterpart of ``raider_tpu/wx/base.py``: the model metadata (valid time
range, level type, coverage, file names, fetch) and the numeric pipeline.
Cubes live on the device given to :meth:`WeatherModel.load`, in the
(y, x, z) layout of the JAX package with z ascending; the grid axes and
lat/lon grids stay host numpy.

    load_weather (a reader subclass: wx/ecmwf.py, hrrr.py, gmao.py,
                  merra2.py, ncmr.py, wrf.py) -> fields on the device
      -> _find_e           (saturation vapor pressure)
      -> _uniform_in_z     (per-column interpolation onto one z ladder)
      -> _check_for_nans   (fillna3d: pandas' backward-limit fill, in torch)
      -> refractivities
      -> _adjust_grid      (pad a zmin layer below ground, trim to bounds)
      -> _get_ztd          (kernel B1 on CUDA, its twin on the CPU)
      -> to_dataset / write
"""

import datetime as dt
import os
from pathlib import Path
from typing import Optional

import numpy as np
import torch

from raider_tpu_torch.constants import _ZMIN, _ZREF, R_D, R_V, _g0
from raider_tpu_torch.geodesy import Geographic, geo_to_ht
from raider_tpu_torch.io import Dataset, Variable, write_nc
from raider_tpu_torch.logger import logger
from raider_tpu_torch.ops import interp_along_axis, ztd_totals
from raider_tpu_torch.utils import require_device
from raider_tpu_torch.wx.exceptions import DatetimeOutsideRange

TIME_RES = {
    'GMAO': 3,
    'ECMWF': 1,
    'HRES': 6,
    'HRRR': 1,
    'WRF': 1,
    'NCMR': 1,
    'HRRR-AK': 3,
}


def host_to_device(a, device, dtype=torch.float64) -> torch.Tensor:
    """``a`` as a ``dtype`` tensor on ``device`` (its own dtype when None). A
    host array moves in its own precision (in native byte order: netCDF-3
    stores big-endian) and converts there."""
    if not isinstance(a, torch.Tensor):
        a = np.asarray(a)
        a = torch.from_numpy(np.ascontiguousarray(a, dtype=a.dtype.newbyteorder('=')))
    return a.to(device=device).to(dtype or a.dtype)


def find_svp(t):
    """Saturation vapor pressure [Pa] from temperature [K], float32.

    Buck (1881) over water, Alduchov & Eskridge (1996) AERKi over ice, with
    a quadratic blend between -23 C and 0 C.
    """
    t1 = 273.15  # 0 C
    t2 = 250.15  # -23 C
    tref = t - t1
    wgt = (t - t2) / (t1 - t2)
    svpw = 6.1121 * torch.exp((17.502 * tref) / (240.97 + tref))
    svpi = 6.1121 * torch.exp((22.587 * tref) / (273.86 + tref))
    svp = svpi + (svpw - svpi) * wgt**2
    svp = torch.where(t > t1, svpw, svp)
    svp = torch.where(t < t2, svpi, svp)
    return (svp * 100.0).to(torch.float32)


def fillna3d(array, axis: int = -1, fill_value: float = 0.0):
    """Fill NaNs along ``axis``: linear between valid neighbours, the first
    valid value for leading NaNs, ``fill_value`` for trailing NaNs (and for
    all-NaN columns).

    The semantics of pandas' ``interpolate(axis=1,
    limit_direction='backward')`` followed by a fill of what stays NaN, as
    the JAX package computes it; the interpolation runs in float64 like
    ``np.interp`` and is stored back in the input dtype.
    """
    a = torch.movedim(array, axis, -1)
    n = a.shape[-1]
    valid = ~torch.isnan(a)
    idx = torch.arange(n, device=a.device).expand(a.shape)
    prev_i = torch.cummax(torch.where(valid, idx, -1), dim=-1).values
    next_i = torch.flip(torch.cummin(torch.flip(torch.where(valid, idx, n), (-1,)), dim=-1).values,
                        (-1,))
    a64 = a.double()
    prev_v = torch.gather(a64, -1, prev_i.clamp_min(0))
    next_v = torch.gather(a64, -1, next_i.clamp_max(n - 1))
    has_prev = prev_i >= 0
    has_next = next_i < n
    span = (next_i - prev_i).clamp_min(1).double()
    lin = prev_v + (next_v - prev_v) / span * (idx - prev_i).double()
    filled = torch.where(has_prev & has_next, lin, torch.where(has_next, next_v, fill_value))
    out = torch.where(valid, a64, filled).to(array.dtype)
    out = torch.where(torch.isnan(out), torch.full_like(out, fill_value), out)
    return torch.movedim(out, -1, axis).contiguous()


def _least_nonzero(a):
    """First non-NaN value along the last axis."""
    idx = torch.argmax((~torch.isnan(a)).to(torch.uint8), dim=-1, keepdim=True)
    return torch.gather(a, -1, idx)[..., 0]


def pad_lower(invar):
    """Prepend a layer below the lowest z-level holding the deepest valid
    value of each column."""
    return torch.cat((_least_nonzero(invar)[:, :, None], invar), dim=2)


def _nanmin(a) -> float:
    return float(torch.nan_to_num(a, nan=float('inf')).min())


class WeatherModel:
    """Generic numerical weather model for delay estimation.

    A subclass fills the fields in ``load_weather``: ``_t``, ``_p`` and
    ``_q`` (or ``_rh``) as (y, x, z) arrays or tensors, ``_zs`` the
    per-column heights (y, x, z), ``_xs``/``_ys`` the grid axes and
    ``_lats``/``_lons`` the (y, x) geographic grids. The readers put their
    fields on ``_device``, which :meth:`load` sets.
    """

    _dataset: Optional[str] = None

    def __init__(self) -> None:
        self._k1 = None
        self._k2 = None
        self._k3 = None
        self._humidityType = 'q'
        self._a = []
        self._b = []
        self.files = None
        self._time = None
        self._time_res = None
        self._lon_res = None
        self._lat_res = None
        self._x_res = None
        self._y_res = None
        self._classname = None
        self._Name = ''
        self._wmLoc = None
        self._model_level_type = 'ml'
        self._valid_range = (
            dt.datetime(1900, 1, 1, tzinfo=dt.timezone.utc),
            dt.datetime.now(dt.timezone.utc),
        )
        self._lag_time = dt.timedelta(days=30)
        self._bbox = None
        self._levels = []
        # valid extent as a (W, S, E, N) box, or a coverage polygon
        self._valid_bounds = (-180.0, -90.0, 180.0, 90.0)
        self._ll_bounds = None
        self._R_v = float(R_V)
        self._R_d = float(R_D)
        self._g0 = float(_g0)
        self._zmin = float(_ZMIN)
        self._zmax = float(_ZREF)
        self._proj = Geographic()
        self._device = None
        self._zlevels = None
        self._xs = np.empty((1, 1, 1))
        self._ys = np.empty((1, 1, 1))
        self._zs = np.empty((1, 1, 1))
        self._lats = None
        self._lons = None
        self._p = None
        self._q = None
        self._rh = None
        self._t = None
        self._e = None
        self._wet_refractivity = None
        self._hydrostatic_refractivity = None
        self._wet_ztd = None
        self._hydrostatic_ztd = None
        self._out_name = None

    # ------------------------------------------------------------------ meta
    def Model(self) -> str:
        return self._Name

    def dtime(self) -> Optional[int]:
        return self._time_res

    def getLLRes(self) -> float:
        return float(np.max([self._lat_res, self._lon_res]))

    def getTime(self) -> Optional[dt.datetime]:
        return self._time

    def setTime(self, time, fmt: str = '%Y-%m-%dT%H:%M:%S') -> None:
        if isinstance(time, str):
            self._time = dt.datetime.strptime(time, fmt)
        elif isinstance(time, dt.datetime):
            self._time = time
        else:
            raise ValueError('"time" must be a string or a datetime object')
        if self._time.tzinfo is None:
            self._time = self._time.replace(tzinfo=dt.timezone.utc)

    def checkTime(self, time: dt.datetime) -> None:
        """Raise if ``time`` is outside the model's valid range or lag window."""
        if not isinstance(time, dt.datetime):
            raise ValueError(f'"time" should be a datetime object, got {time!r}')
        time = time.replace(tzinfo=dt.timezone.utc) if time.tzinfo is None else time
        start, end = self._valid_range
        logger.info('Weather model %s is available from %s to %s', self.Model(), start, end)
        if time < start or (end is not None and end < time):
            raise DatetimeOutsideRange(self.Model(), time)
        if time > dt.datetime.now(dt.timezone.utc) - self._lag_time:
            raise DatetimeOutsideRange(self.Model(), time)

    def setLevelType(self, levelType: str) -> None:
        if levelType not in ('ml', 'pl', 'nat', 'prs'):
            raise RuntimeError(f'Level type {levelType} is not recognized')
        self._model_level_type = levelType
        if levelType in ('ml', 'nat'):
            self.__model_levels__()
        else:
            self.__pressure_levels__()

    def __model_levels__(self) -> None:
        raise NotImplementedError

    def __pressure_levels__(self) -> None:
        raise NotImplementedError

    def get_latlon_bounds(self):
        return self._ll_bounds

    def set_latlon_bounds(self, ll_bounds, Nextra: int = 2,
                          output_spacing: Optional[float] = None) -> None:
        """Buffer the query bounds (SNWE) to model-grid margins."""
        from raider_tpu_torch.utils.bbox import clip_bbox

        ex_buffer_lon_max = 0.0
        if self._Name in ('HRRR', 'HRRR-AK', 'HRES'):
            Nextra = 6
        else:
            ex_buffer_lon_max = self._lon_res
        S, N, W, E = ll_bounds
        pixlat, pixlon = Nextra * self._lat_res, Nextra * self._lon_res
        S = np.max([S - pixlat, -90.0 + pixlat])
        N = np.min([N + pixlat, 90.0 - pixlat])
        W = np.max([W - (pixlon + ex_buffer_lon_max), -180.0 + (pixlon + ex_buffer_lon_max)])
        E = np.min([E + (pixlon + ex_buffer_lon_max), 180.0 - pixlon - ex_buffer_lon_max])
        if output_spacing is not None:
            S, N, W, E = clip_bbox([S, N, W, E], output_spacing)
        self._ll_bounds = np.array([S, N, W, E])

    def checkValidBounds(self, ll_bounds) -> None:
        from raider_tpu_torch.utils.bbox import boxes_intersect

        S, N, W, E = ll_bounds
        if not boxes_intersect((W, S, E, N), self._valid_bounds):
            if not boxes_intersect((W + 360, S, E + 360, N), self._valid_bounds):
                raise ValueError(f'The requested location is unavailable for {self._Name}')

    @property
    def bbox(self):
        """(W, S, E, N) extent of the processed weather file."""
        if self._bbox is None:
            from raider_tpu_torch.geodesy import transform_points
            from raider_tpu_torch.io import read_nc

            path = self.out_file(self.get_wmLoc())
            if not Path(path).exists():
                raise ValueError('Need to save cropped weather model as netcdf')
            ds = read_nc(path)
            xs = np.asarray(ds.coords['x'].data, dtype=np.float64)
            ys = np.asarray(ds.coords['y'].data, dtype=np.float64)
            cx = np.array([xs.min(), xs.min(), xs.max(), xs.max()])
            cy = np.array([ys.min(), ys.max(), ys.min(), ys.max()])
            lons, lats = (np.asarray(v) for v in transform_points(self._proj, Geographic(),
                                                                  cx, cy)[:2])
            self._bbox = (lons.min(), lats.min(), lons.max(), lats.max())
        return self._bbox

    @bbox.setter
    def bbox(self, value) -> None:
        self._bbox = tuple(value)

    def checkContainment(self, ll_bounds, buffer_deg: float = 1e-5) -> bool:
        """True if the processed file covers ``ll_bounds`` (SNWE), with the
        +/-360 longitude translates."""
        from raider_tpu_torch.utils.bbox import box_contains_with_translates

        s, n, w, e = ll_bounds
        return box_contains_with_translates(self.bbox, (w, s, e, n), buffer_deg)

    def get_wmLoc(self) -> str:
        return self._wmLoc if self._wmLoc is not None else os.path.join(os.getcwd(), 'weather_files')

    def set_wmLoc(self, weather_model_directory: str) -> None:
        self._wmLoc = weather_model_directory

    def out_file(self, outLoc: str) -> str:
        return os.path.join(outLoc, make_weather_model_filename(self._Name, self._time,
                                                                self._ll_bounds))

    def filename(self, time: Optional[dt.datetime] = None, outLoc: str = 'weather_files') -> str:
        os.makedirs(outLoc, exist_ok=True)
        if time is None:
            if self._time is None:
                raise ValueError('Time must be specified before the file can be written')
            time = self._time
        f = make_raw_weather_data_filename(outLoc, self._Name, time)
        self.files = [f]
        return f

    def getProjection(self):
        return self._proj

    # --------------------------------------------------------- fetch/load
    def fetch(self, out, time: dt.datetime) -> None:
        self.checkTime(time)
        self.setTime(time)
        try:
            self._fetch(out)
        except Exception as e:
            logger.exception(e)
            raise

    def _fetch(self, out) -> None:
        raise NotImplementedError

    def load_weather(self, *args, **kwargs) -> None:
        raise NotImplementedError

    def load(self, *args, device='cuda', _zlevels=None, **kwargs):
        """Run the preprocessing pipeline on ``device`` (the CUDA card unless
        the caller names another; without CUDA the default raises).

        When the latitude/longitude bounds are set and the processed file
        already exists, returns its path and computes nothing (as the JAX
        package does); otherwise returns None and the result stays in
        memory (:meth:`to_dataset`, :meth:`write`).
        """
        self._device = require_device(device)
        outLoc = self.get_wmLoc()
        if self._ll_bounds is not None:
            self._out_name = self.out_file(outLoc)
            if Path(self._out_name).exists():
                return self._out_name
        self.load_weather(*args, f=make_raw_weather_data_filename(outLoc, self.Model(),
                                                                  self.getTime()), **kwargs)
        for name in ('_t', '_p', '_q', '_rh', '_zs'):
            v = getattr(self, name)
            if v is not None:
                setattr(self, name, torch.as_tensor(
                    np.ascontiguousarray(v) if isinstance(v, np.ndarray) else v,
                    device=self._device))
        self._find_e()
        self._uniform_in_z(_zlevels=_zlevels)
        self._check_for_nans()
        self._get_wet_refractivity()
        self._get_hydro_refractivity()
        self._adjust_grid(self.get_latlon_bounds())
        self._get_ztd()
        return None

    # ------------------------------------------------------------- numerics
    def _convertmb2Pa(self, pres):
        return 100 * pres

    def _get_heights(self, lats, geo_hgt, geo_ht_fill=np.nan) -> None:
        """Geopotential -> ellipsoidal heights."""
        geo_hgt = host_to_device(geo_hgt, self._device)
        geo_ht_fix = torch.where(geo_hgt != geo_ht_fill, geo_hgt, float('nan'))
        lats = host_to_device(lats, self._device)
        self._zs = geo_to_ht(lats[..., None].expand(geo_ht_fix.shape), geo_ht_fix)

    def _calculategeoh(self, z, lnsp):
        from raider_tpu_torch.wx.calcgeoh import calcgeoh

        return calcgeoh(lnsp, self._t, self._q, z, self._a, self._b, self._R_d, self._levels)

    def _find_e(self) -> None:
        if self._humidityType == 'rh':
            self._e = self._rh / 100 * find_svp(self._t)
        elif self._humidityType == 'q':
            svp = find_svp(self._t)
            w = self._q / (1 - self._q)
            self._e = w * self._R_v * (self._p - svp) / self._R_d
        else:
            raise RuntimeError('Not a valid humidity type')
        self._rh = None
        self._q = None

    def _get_wet_refractivity(self) -> None:
        """N_wet = k2 e/T + k3 e/T^2."""
        self._wet_refractivity = (float(self._k2) * self._e / self._t
                                  + float(self._k3) * self._e / self._t**2)

    def _get_hydro_refractivity(self) -> None:
        """N_hydro = k1 P/T."""
        self._hydrostatic_refractivity = float(self._k1) * self._p / self._t

    def getWetRefractivity(self):
        return self._wet_refractivity

    def getHydroRefractivity(self):
        return self._hydrostatic_refractivity

    def _uniform_in_z(self, _zlevels=None) -> None:
        """Interpolate t, p and e onto one z ladder for every column."""
        zs = self._zs
        if _zlevels is None:
            if self._zlevels is not None:
                _zlevels = self._zlevels
            else:
                _zlevels = torch.nanmean(zs, dim=(0, 1)).cpu().numpy()
                # TOP-only clamp: the mean of near-identical columns can land
                # an ulp above the lowest column top, where the top node
                # interpolates to NaN and the fill zeroes its refractivity
                # (a 1.7 mm hydrostatic bias on a 30 km WRF column). The
                # bottom is not clamped: below-native-bottom nodes get the
                # flat surface-gap fill.
                _zlevels = np.minimum(_zlevels, _nanmin(zs[:, :, -1]))
        _zlevels = np.ascontiguousarray(_zlevels, dtype=np.float64)
        new_zs = torch.as_tensor(_zlevels, device=self._device).expand(
            tuple(self._p.shape[:2]) + (_zlevels.size,))
        for name in ('_t', '_p', '_e'):
            cur = getattr(self, name).to(torch.float64)
            out = interp_along_axis(zs.to(torch.float64), cur, new_zs, axis=2)
            setattr(self, name, out.to(torch.float32))
        self._zs = _zlevels
        self._xs = np.unique(self._xs)
        self._ys = np.unique(self._ys)

    def _check_for_nans(self) -> None:
        self._p = fillna3d(self._p)
        self._t = fillna3d(self._t, fill_value=1e16)  # avoid divide-by-zero
        self._e = fillna3d(self._e)

    def _adjust_grid(self, ll_bounds=None) -> None:
        """Pad the grid with a layer at zmin, then trim to the bounds."""
        if self._zmin < np.nanmin(self._zs):
            self._zs = np.insert(self._zs, 0, self._zmin)
            for name in ('_p', '_t', '_e', '_wet_refractivity', '_hydrostatic_refractivity'):
                setattr(self, name, pad_lower(getattr(self, name)))
            if ll_bounds is not None:
                self._trimExtent(ll_bounds)

    def _trimExtent(self, extent) -> None:
        """Crop the grid to the SNWE bounds + 2 cells."""
        if self._lats is None:
            return
        lat = np.array(self._lats, dtype=np.float64)
        lon = np.array(self._lons, dtype=np.float64)
        lat[np.isnan(lat)] = np.nanmean(lat)
        lon[np.isnan(lon)] = np.nanmean(lon)
        mask = (lat >= extent[0]) & (lat <= extent[1]) & (lon >= extent[2]) & (lon <= extent[3])
        ma1 = np.sum(mask, axis=1).astype(bool)
        ma2 = np.sum(mask, axis=0).astype(bool)
        if np.sum(ma1) == 0 and np.sum(ma2) == 0:
            return
        ny, nx = self._p.shape[:2]
        index1 = max(np.arange(len(ma1))[ma1][0] - 2, 0)
        index2 = min(np.arange(len(ma1))[ma1][-1] + 2, ny)
        index3 = max(np.arange(len(ma2))[ma2][0] - 2, 0)
        index4 = min(np.arange(len(ma2))[ma2][-1] + 2, nx)
        self._lons = self._lons[index1:index2, index3:index4]
        self._lats = self._lats[index1:index2, index3:index4]
        self._xs = self._xs[index3:index4]
        self._ys = self._ys[index1:index2]
        for name in ('_wet_refractivity', '_hydrostatic_refractivity'):
            setattr(self, name, getattr(self, name)[index1:index2, index3:index4, ...])
        # t, p and e stay contiguous (y, x, z): kernel B1 reads them in place
        for name in ('_p', '_t', '_e'):
            setattr(self, name, getattr(self, name)[index1:index2, index3:index4, ...].contiguous())

    def _get_ztd(self) -> None:
        """Zenith total delay at every node, integrated from each level to the
        model top: kernel B1 (``ops.ztd.ztd_totals``) on CUDA, its twin on
        the CPU. B1 reads the contiguous (y, x, z) t, p and e through their
        (z, y, x) views, without a copy. A kernel failure raises."""
        wet_t, hyd_t = ztd_totals(*(torch.movedim(a, -1, 0) for a in (self._t, self._p, self._e)),
                                  torch.as_tensor(self._zs, dtype=torch.float32,
                                                  device=self._device),
                                  k1=float(self._k1), k2=float(self._k2), k3=float(self._k3))
        self._wet_ztd = torch.movedim(wet_t, 0, -1)
        self._hydrostatic_ztd = torch.movedim(hyd_t, 0, -1)

    # ------------------------------------------------------------------ output
    def to_dataset(self) -> Dataset:
        """The processed model in the schema of the JAX package's ``write()``,
        in memory: cubes are (z, y, x) tensors on the model's device."""
        def _zyx(arr):
            return torch.movedim(arr, -1, 0).contiguous()

        attrs = {
            'Conventions': 'CF-1.6',
            'datetime': dt.datetime.strftime(self._time, '%Y_%m_%dT%H_%M_%S'),
            'date_created': dt.datetime.now().strftime('%Y_%m_%dT%H_%M_%S'),
            'title': 'Weather model data and delay calculations',
            'model_name': self._Name,
        }
        coords = {
            'x': Variable(('x',), np.asarray(self._xs), {}),
            'y': Variable(('y',), np.asarray(self._ys), {}),
            'z': Variable(('z',), np.asarray(self._zs), {}),
        }
        variables = {
            'latitude': Variable(('y', 'x'), np.asarray(self._lats), {}),
            'longitude': Variable(('y', 'x'), np.asarray(self._lons), {}),
            't': Variable(('z', 'y', 'x'), _zyx(self._t), {'units': 'K', 'standard_name': 'temperature'}),
            'p': Variable(('z', 'y', 'x'), _zyx(self._p), {'units': 'Pa', 'standard_name': 'pressure'}),
            'e': Variable(('z', 'y', 'x'), _zyx(self._e), {'units': 'Pa', 'standard_name': 'humidity'}),
            'wet': Variable(('z', 'y', 'x'), _zyx(self._wet_refractivity),
                            {'units': 'dimentionless', 'standard_name': 'wet_refractivity'}),
            'hydro': Variable(('z', 'y', 'x'), _zyx(self._hydrostatic_refractivity),
                              {'units': 'dimentionless', 'standard_name': 'hydrostatic_refractivity'}),
            'wet_total': Variable(('z', 'y', 'x'), _zyx(self._wet_ztd),
                                  {'units': 'm', 'standard_name': 'total_wet_refractivity'}),
            'hydro_total': Variable(('z', 'y', 'x'), _zyx(self._hydrostatic_ztd),
                                    {'units': 'm', 'standard_name': 'total_hydrostatic_refractivity'}),
        }
        proj_attrs = dict(self._proj.to_cf())
        proj_attrs['grid_mapping'] = 'proj'
        variables['proj'] = Variable((), np.int64(0), proj_attrs)
        for name, var in variables.items():
            if name not in ('proj', 'latitude', 'longitude'):
                var.attrs['grid_mapping'] = 'proj'
        return Dataset(coords=coords, variables=variables, attrs=attrs)

    def getPoints(self):
        """Copies of the x, y and z grids (arrays, or tensors on the model's device)."""
        return tuple(a.clone() if isinstance(a, torch.Tensor) else a.copy()
                     for a in (self._xs, self._ys, self._zs))

    def write(self, nc_format: str = 'NETCDF4') -> str:
        """Write :meth:`to_dataset` to the processed-model file: netCDF4
        through h5py, or classic netCDF-3 when ``nc_format`` is
        ``'NETCDF3_64BIT_OFFSET'`` (see ``io.ncdf.write_nc``)."""
        if self._out_name is None:
            raise ValueError('write() needs the latitude/longitude bounds set before load()')
        return write_nc(self.to_dataset(), self._out_name, nc_format=nc_format)


def make_weather_model_filename(name: str, time: dt.datetime, ll_bounds) -> str:
    """Processed-file cache key."""
    s = np.floor(ll_bounds[0])
    S = f'{np.abs(s):.0f}S' if s < 0 else f'{s:.0f}N'
    n = np.ceil(ll_bounds[1])
    N = f'{np.abs(n):.0f}S' if n < 0 else f'{n:.0f}N'
    w = np.floor(ll_bounds[2])
    W = f'{np.abs(w):.0f}W' if w < 0 else f'{w:.0f}E'
    e = np.ceil(ll_bounds[3])
    E = f'{np.abs(e):.0f}W' if e < 0 else f'{e:.0f}E'
    return f'{name}_{time.strftime("%Y_%m_%d_T%H_%M_%S")}_{S}_{N}_{W}_{E}.nc'


def make_raw_weather_data_filename(outLoc: str, name: str, time: dt.datetime) -> str:
    return os.path.join(outLoc, f'{name}_{dt.datetime.strftime(time, "%Y_%m_%d_T%H_%M_%S")}.nc')
