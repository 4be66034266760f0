"""Synthetic raw weather-model files, one per reader, as classic netCDF-3.

Each writer lays out a file the way its reader in ``raider_tpu_torch.wx``
expects it (variable names, dimension order, level order, CRS attributes)
and fills it with the standard atmosphere plus seeded noise over seeded
terrain, at the model's native level count and spacing. The files are
written by ``scipy.io.netcdf_file`` (no h5py) with 64-bit offsets, so the
HRRR CONUS grid (50 x 1059 x 1799 float32 fields, ~1.5 GB) fits. Fields are
drawn on ``device`` (the card unless the caller names another; the seeded
stream depends on the device) and copied to the host once.
"""

import numpy as np
import torch

from raider_tpu_torch.constants import _g0
from raider_tpu_torch.utils import require_device

P0 = 101325.0

# model -> (native levels, grid): a projected grid is (kind, ny, nx, spacing
# in m, lat, lon) of its first point (HRRR CONUS's own grid) or of its centre
# (a 400 x 400 cut of HRRR-AK's grid around Anchorage, a WRF domain); a
# geographic one is (S, N, W, E) at the class's _lat_res x _lon_res
DOMAINS = {
    'HRRR': (50, ('lcc', 1059, 1799, 3000.0, 21.138, 237.280)),
    'HRRRAK': (50, ('ps', 400, 400, 3000.0, 61.2, -149.9)),
    'ERA5': (137, (25.0, 45.0, -110.0, -90.0)),
    'ERA5T': (137, (25.0, 45.0, -110.0, -90.0)),
    'ERAI': (60, (25.0, 45.0, -110.0, -90.0)),
    'HRES': (137, (25.0, 45.0, -110.0, -90.0)),
    'GMAO': (72, (25.0, 45.0, -110.0, -90.0)),
    'MERRA2': (72, (25.0, 45.0, -110.0, -90.0)),
    'NCMR': (70, (25.0, 45.0, -110.0, -90.0)),
    'WRF': (50, ('wrf', 400, 400, 5550.0, 35.0, -100.0)),
}
# model tops [m] of the height-based raw files
_TOPS = {'HRRR': 27000.0, 'HRRRAK': 27000.0, 'GMAO': 65000.0, 'MERRA2': 65000.0,
         'NCMR': 40000.0, 'WRF': 25000.0}


def standard_atmosphere(h, gen):
    """Temperature [K], pressure [Pa] and specific humidity at heights ``h``
    [m] (float64 tensor): the standard atmosphere with seeded noise."""
    t = torch.where(h < 11000.0, 288.15 - 0.0065 * h, 216.65 + 0.001 * (h - 20000.0).clamp_min(0.0))
    p = torch.where(h < 11000.0, P0 * (1.0 - 2.25577e-5 * h.clamp_max(11000.0)) ** 5.25588,
                    22632.0 * torch.exp(-(h - 11000.0) / 6341.6))
    q = 0.015 * torch.exp(-h.clamp_min(0.0) / 2000.0)
    t = t + 0.5 * torch.randn(h.shape, generator=gen, device=h.device, dtype=h.dtype)
    p = p * (1.0 + 1e-3 * torch.randn(h.shape, generator=gen, device=h.device, dtype=h.dtype))
    q = q * (0.7 + 0.4 * torch.rand(h.shape, generator=gen, device=h.device, dtype=h.dtype))
    return t, p, q


def height_of_pressure(p):
    """The standard atmosphere's height [m] at pressure ``p`` [Pa]."""
    low = (1.0 - (p / P0) ** (1.0 / 5.25588)) / 2.25577e-5
    return torch.where(p > 22632.0, low, 11000.0 - 6341.6 * torch.log(p / 22632.0))


def terrain(lat, lon, gen):
    """Seeded terrain [m] on (ny, nx) lat/lon tensors."""
    t = (800.0 + 600.0 * torch.sin(torch.deg2rad(lat) * 40.0) * torch.cos(torch.deg2rad(lon) * 30.0)
         + 50.0 * torch.randn(lat.shape, generator=gen, device=lat.device, dtype=lat.dtype))
    return t.clamp_min(0.0)


def _levels(ground, nz, top):
    """(nz, ny, nx) terrain-following heights from the ground to ``top``."""
    sigma = torch.linspace(0.0, 1.0, nz, dtype=ground.dtype, device=ground.device) ** 1.5
    return ground[None] + (top - ground[None]) * sigma[:, None, None]


def _host(a, dtype=np.float32):
    return a.detach().cpu().numpy().astype(dtype)


def _proj_var(f, crs):
    v = f.createVariable('proj', 'i4', ())
    v[...] = 0
    for k, val in crs.to_cf().items():
        setattr(v, k, val)


def _projected_grid(kind, ny, nx, step, lat0, lon0, device):
    """A projected model's axes and lat/lon grids from its first point
    (``lcc``) or its centre."""
    from raider_tpu_torch.geodesy import LambertConformalConic
    from raider_tpu_torch.geodesy.crs import Ellipsoid
    from raider_tpu_torch.wx.hrrr import HRRR_AK_PROJ, HRRR_CONUS_PROJ

    proj = {'lcc': HRRR_CONUS_PROJ, 'ps': HRRR_AK_PROJ,
            'wrf': LambertConformalConic(lat_0=lat0, lon_0=lon0, lat_1=30.0, lat_2=60.0,
                                         ellipsoid=Ellipsoid(a=6370e3, f=0.0))}[kind]
    x0, y0 = (float(v) for v in proj.forward(lon0, lat0))
    if kind != 'lcc':   # (lat0, lon0) is the centre
        x0, y0 = x0 - step * (nx - 1) / 2.0, y0 - step * (ny - 1) / 2.0
    xs = x0 + step * torch.arange(nx, dtype=torch.float64, device=device)
    ys = y0 + step * torch.arange(ny, dtype=torch.float64, device=device)
    yy, xx = torch.meshgrid(ys, xs, indexing='ij')
    lon, lat = proj.inverse(xx, yy)
    return proj, xs, ys, lat, lon


def write_hrrr(path, ak=False, nz=None, grid=None, seed=0, device='cuda'):
    """HRRR / HRRR-AK raw file (``wx/hrrr.py::load_weather_hrrr``): x, y,
    latitude, longitude, (z, y, x) ``t``, ``q``, ``pres`` and geopotential
    height ``z`` (bottom up), and the CRS in ``proj``."""
    name = 'HRRRAK' if ak else 'HRRR'
    nz = nz or DOMAINS[name][0]
    kind, ny, nx, step, lat0, lon0 = grid or DOMAINS[name][1]
    from scipy.io import netcdf_file

    device = require_device(device)
    gen = torch.Generator(device=device)
    gen.manual_seed(seed)
    proj, xs, ys, lat, lon = _projected_grid(kind, ny, nx, step, lat0, lon0, device)
    h = _levels(terrain(lat, lon, gen), nz, _TOPS[name])
    with netcdf_file(str(path), 'w', version=2) as f:
        f.createDimension('levels', nz)
        f.createDimension('y', ny)
        f.createDimension('x', nx)
        f.createVariable('x', 'f8', ('x',))[:] = _host(xs, np.float64)
        f.createVariable('y', 'f8', ('y',))[:] = _host(ys, np.float64)
        f.createVariable('latitude', 'f8', ('y', 'x'))[:] = _host(lat, np.float64)
        # the GRIB longitudes run 0-360
        f.createVariable('longitude', 'f8', ('y', 'x'))[:] = _host(torch.remainder(lon, 360.0),
                                                                   np.float64)
        t, p, q = standard_atmosphere(h, gen)
        for key, val in (('z', h), ('t', t), ('q', q), ('pres', p)):
            f.createVariable(key, 'f4', ('levels', 'y', 'x'))[:] = _host(val)
            f.variables[key].grid_mapping = 'proj'
        del t, p, q
        _proj_var(f, proj)
    return path


def crop_hrrr(src, dst, ll_bounds, q_scale: float = 1.0, p_scale: float = 1.0,
              t_scale: float = 1.0) -> tuple:
    """Write to ``dst`` what HRRR's fetcher (``wx.hrrr.download_hrrr_file``)
    writes for ``ll_bounds`` (SNWE), cut from the whole-grid raw file
    ``src``: the rows and columns ``get_bounds_indices`` finds on its
    latitude/longitude grid, with the longitudes taken modulo 360 as the
    fetcher does; the humidity ``q``, the pressure ``pres`` and the
    temperature ``t`` multiplied by ``q_scale``, ``p_scale`` and
    ``t_scale`` (so that cuts for several epochs differ). Returns the
    (y, x) shape written."""
    from scipy.io import netcdf_file

    from raider_tpu_torch.wx.hrrr import get_bounds_indices

    bounds = np.asarray(ll_bounds, dtype=np.float64).copy()
    bounds[2:] = np.mod(bounds[2:], 360)
    with netcdf_file(str(src), 'r', mmap=True) as f:
        x0, x1, y0, y1 = get_bounds_indices(bounds, f.variables['latitude'][:],
                                            f.variables['longitude'][:])
        cut = {'y': slice(y0, y1), 'x': slice(x0, x1)}
        with netcdf_file(str(dst), 'w', version=2) as g:
            for name, size in f.dimensions.items():
                g.createDimension(name, len(range(size)[cut[name]]) if name in cut else size)
            for name, var in f.variables.items():
                out = g.createVariable(name, var.typecode(), var.dimensions)
                data = var.data[tuple(cut.get(d, slice(None)) for d in var.dimensions)]
                scale = {'q': q_scale, 'pres': p_scale, 't': t_scale}.get(name, 1.0)
                out[...] = data * np.float32(scale) if scale != 1.0 else data
                for k, v in var._attributes.items():
                    setattr(out, k, v)
            del var, data   # the mapped file closes only when no array refers to it
    return y1 - y0, x1 - x0


def _geographic_axes(model, box):
    _, cls = _model_class(model)
    m = cls()
    s, n, w, e = box
    lats = np.arange(s, n + 1e-9, m._lat_res)
    lons = np.arange(w, e + 1e-9, m._lon_res)
    return m, lats, lons


def _model_class(model):
    from raider_tpu_torch.wx.registry import get_wm_by_name

    return get_wm_by_name(model)


def write_ecmwf(path, model='ERA5', box=None, seed=0, device='cuda'):
    """ECMWF model-level raw file (``wx/ecmwf.py::_makeDataCubes``): ``t``
    and ``q`` on the model's levels (top first), surface geopotential ``z``
    and ``lnsp``, latitudes north to south as CDS delivers them. Temperature
    and humidity follow the standard atmosphere at each level's height."""
    from scipy.io import netcdf_file

    m, lats, lons = _geographic_axes(model, box or DOMAINS[model][1])
    lats = lats[::-1].copy()
    nz = m._levels
    device = require_device(device)
    gen = torch.Generator(device=device)
    gen.manual_seed(seed)
    lat = torch.as_tensor(lats, device=device)[:, None].expand(lats.size, lons.size)
    lon = torch.as_tensor(lons, device=device)[None, :].expand(lats.size, lons.size)
    ground = terrain(lat, lon, gen)
    sp = P0 * (1.0 - 2.25577e-5 * ground) ** 5.25588
    a = torch.as_tensor(np.asarray(m._a, dtype=np.float64), device=device)
    b = torch.as_tensor(np.asarray(m._b, dtype=np.float64), device=device)
    ph = a[:, None, None] + b[:, None, None] * sp[None]
    p_full = 0.5 * (ph[:-1] + ph[1:]).clamp_min(1e-3)
    t, _, q = standard_atmosphere(height_of_pressure(p_full), gen)
    with netcdf_file(str(path), 'w', version=2) as f:
        f.createDimension('level', nz)
        f.createDimension('latitude', lats.size)
        f.createDimension('longitude', lons.size)
        f.createVariable('level', 'i4', ('level',))[:] = np.arange(1, nz + 1)
        f.createVariable('latitude', 'f8', ('latitude',))[:] = lats
        f.createVariable('longitude', 'f8', ('longitude',))[:] = lons
        dims = ('level', 'latitude', 'longitude')
        f.createVariable('t', 'f4', dims)[:] = _host(t)
        f.createVariable('q', 'f4', dims)[:] = _host(q)
        f.createVariable('z', 'f4', dims[1:])[:] = _host(ground * float(_g0))
        f.createVariable('lnsp', 'f4', dims[1:])[:] = _host(torch.log(sp))
    return path


def write_hqpt(path, model='GMAO', box=None, seed=0, device='cuda'):
    """The h/q/p/t raw file of GMAO, MERRA2 and NCMR (what their fetchers
    write): 2-D latitude and longitude, (z, y, x) heights ``h``, ``q``,
    ``p``, ``t``; top first for GMAO and MERRA2, bottom first for NCMR."""
    from scipy.io import netcdf_file

    from raider_tpu_torch.geodesy import Geographic

    m, lats, lons = _geographic_axes(model, box or DOMAINS[model][1])
    nz = DOMAINS[model][0]
    device = require_device(device)
    gen = torch.Generator(device=device)
    gen.manual_seed(seed)
    lat = torch.as_tensor(lats, device=device)[:, None].expand(lats.size, lons.size)
    lon = torch.as_tensor(lons, device=device)[None, :].expand(lats.size, lons.size)
    h = _levels(terrain(lat, lon, gen), nz, _TOPS[model])
    t, p, q = standard_atmosphere(h, gen)
    fields = [h, q, p, t]
    if model != 'NCMR':
        fields = [torch.flip(a, (0,)) for a in fields]
    with netcdf_file(str(path), 'w', version=2) as f:
        f.createDimension('z', nz)
        f.createDimension('y', lats.size)
        f.createDimension('x', lons.size)
        f.createVariable('latitude', 'f8', ('y', 'x'))[:] = _host(lat, np.float64)
        f.createVariable('longitude', 'f8', ('y', 'x'))[:] = _host(lon, np.float64)
        for key, val in zip(('h', 'q', 'p', 't'), fields):
            f.createVariable(key, 'f4', ('z', 'y', 'x'))[:] = _host(val)
        _proj_var(f, Geographic())
    return path


def write_wrfout(path, nz=None, grid=None, seed=0, device='cuda'):
    """A raw ``wrfout`` file (``wx/wrf.py::_load_raw_wrfout``) on a regular
    Lambert conformal grid: XLAT/XLONG, staggered PH/PHB, the potential
    temperature perturbation T, P/PB and QVAPOR, and the projection in the
    global attributes."""
    from scipy.io import netcdf_file

    nz = nz or DOMAINS['WRF'][0]
    kind, ny, nx, step, lat0, lon0 = grid or DOMAINS['WRF'][1]
    device = require_device(device)
    gen = torch.Generator(device=device)
    gen.manual_seed(seed)
    _, _, _, lat, lon = _projected_grid(kind, ny, nx, step, lat0, lon0, device)
    zstag = _levels(terrain(lat, lon, gen), nz + 1, _TOPS['WRF'])
    z_mass = 0.5 * (zstag[:-1] + zstag[1:])
    t, p, q = standard_atmosphere(z_mass, gen)
    theta = t * (1e5 / p) ** 0.2854
    w = q / (1.0 - q)                       # mixing ratio
    with netcdf_file(str(path), 'w', version=2) as f:
        f.TRUELAT1, f.TRUELAT2, f.MOAD_CEN_LAT, f.STAND_LON = 30.0, 60.0, lat0, lon0
        for d, n in (('Time', 1), ('bottom_top', nz), ('bottom_top_stag', nz + 1),
                     ('south_north', ny), ('west_east', nx)):
            f.createDimension(d, n)
        d2 = ('Time', 'south_north', 'west_east')
        d3 = ('Time', 'bottom_top', 'south_north', 'west_east')
        d3s = ('Time', 'bottom_top_stag', 'south_north', 'west_east')
        f.createVariable('XLAT', 'f4', d2)[:] = _host(lat)[None]
        f.createVariable('XLONG', 'f4', d2)[:] = _host(lon)[None]
        f.createVariable('PH', 'f4', d3s)[:] = np.zeros((1, nz + 1, ny, nx), np.float32)
        f.createVariable('PHB', 'f4', d3s)[:] = _host(zstag * float(_g0))[None]
        f.createVariable('T', 'f4', d3)[:] = _host(theta - 300.0)[None]
        f.createVariable('P', 'f4', d3)[:] = np.zeros((1, nz, ny, nx), np.float32)
        f.createVariable('PB', 'f4', d3)[:] = _host(p)[None]
        f.createVariable('QVAPOR', 'f4', d3)[:] = _host(w)[None]
    return path


def write(model: str, path, seed: int = 0, device='cuda'):
    """Write ``model``'s raw file over its default domain."""
    model = model.upper().replace('-', '')
    if model in ('HRRR', 'HRRRAK'):
        return write_hrrr(path, ak=model == 'HRRRAK', seed=seed, device=device)
    if model in ('ERA5', 'ERA5T', 'ERAI', 'HRES'):
        return write_ecmwf(path, model, seed=seed, device=device)
    if model in ('GMAO', 'MERRA2', 'NCMR'):
        return write_hqpt(path, model, seed=seed, device=device)
    if model == 'WRF':
        return write_wrfout(path, seed=seed, device=device)
    raise ValueError(f'no raw-file writer for {model}')
