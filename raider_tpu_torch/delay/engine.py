"""Top-level tropospheric delay calculation on one device.

Counterpart of ``raider_tpu/delay/engine.py``: zenith, projected and
raytraced delays on a cube-type AOI (``BoundingBox``, ``Geocube``: the
delay cube is the answer) or at the points of a point-type AOI (station
files, radar and geocoded rasters: the cube, sampled at the points by an
8-corner gather on the device, the point coordinates in float64).

  * Zenith cube (and the projected LOS's, which is the zenith cube, each
    point delay then divided by the LOS's projection factor): the
    integrated-delay fields interpolated onto the output grid, every height
    level at once (three fp32 contractions when the output CRS is the
    model's).
  * Raytraced cube, per output height (the JAX package's host-geometry
    branch, run on the device in float64): pixel ECEF positions, batched
    geo2rdr look vectors, batched level intersections, boundary points in
    the model CRS shifted by the grid origin before the float32 entry, and
    a per-slice sampling plan from that slice's measured per-level maxima;
    then ``delay.raytrace.integrate_rays`` on the table ``pack_cubes``
    builds once per cube in the mode of the JAX package's ladder: kernel
    B2 (f32 bricks), K4 (int16 bricks, the capacity band) or the plain-torch
    pack16 / pack16_i16 / pack4 integrate for larger cubes.

The steps are timed by ``utils.profiling.stage`` under the JAX package's
stage names (that module's docstring says how they nest).

Several devices (``parallel``): ``mesh`` (a ``parallel.Mesh``, by default
``parallel.default_mesh``: every CUDA device for a bare 'cuda', else the
request's device alone) splits the zenith cube's output rows and each
raytraced slice's rays over its shards (the table replicated on each
distinct device once; the slice's plan is built from all its rays before
the split, so a sharded cube equals the unsharded one bit for bit), or,
where ``parallel.zshard_auto`` says so (``zshard``: 'auto', True or
False), integrates each slice against a table packed once in z-slabs over
the shards. One device is a mesh of one shard: every mesh size runs the
same code.

The JAX package's device-geometry session (cube-global static plan and
deferred redo) is ROADMAP A2; its int16 result stream and fetch batching
are not ported (ROADMAP "Not to port" says why).
"""

import datetime as dt
import os
from typing import Optional, Union

import numpy as np
import torch

from raider_tpu_torch.constants import MAX_SEGMENT_LENGTH
from raider_tpu_torch.delay.raytrace import _np_dtype, integrate_rays, pack_cubes, pack_mode_for
from raider_tpu_torch.geodesy import (Geocentric, Geographic, crs_from_cf, crs_from_user, get_Re,
                                      transform_points)
from raider_tpu_torch.geodesy.ellipsoid import lla2ecef
from raider_tpu_torch.geometry.aoi import AOI, BoundingBox, Geocube
from raider_tpu_torch.geometry.los import LOS
from raider_tpu_torch.geometry.rays import build_ray, level_heights
from raider_tpu_torch.io import Dataset, Variable, read_nc
from raider_tpu_torch.logger import logger
from raider_tpu_torch.ops import contract_yx, contract_z, grid_weights, interp3d_points
from raider_tpu_torch.parallel.mesh import (Mesh, default_mesh, gather_rays, place_ray_arrays,
                                            process_group_size, process_rank, replicate,
                                            shard_rays)
from raider_tpu_torch.parallel.zshard import (integrate_rays_z_sharded, pack_cube_slabs,
                                              zshard_auto)
from raider_tpu_torch.utils import require_device
from raider_tpu_torch.utils.profiling import stage


def torch_dtype(dtype) -> torch.dtype:
    """A torch dtype from a torch or numpy dtype."""
    return dtype if isinstance(dtype, torch.dtype) else getattr(torch, np.dtype(dtype).name)


class WeatherCube:
    """A processed weather model (a Dataset, or the path of its file) whose
    fields are served as tensors on ``device``; axes stay host numpy."""

    def __init__(self, path_or_ds: Union[str, Dataset], device) -> None:
        ds = path_or_ds if isinstance(path_or_ds, Dataset) else read_nc(path_or_ds)
        self.ds = ds
        self.device = torch.device(device)
        self.xs, self.ys, self.zs = (np.asarray(ds.coords[k].data, dtype=np.float64).copy()
                                     for k in ('x', 'y', 'z'))
        # normalize all axes to ascending (the interpolators require it)
        self._flip = [a.size > 1 and a[0] > a[-1] for a in (self.zs, self.ys, self.xs)]
        self.zs, self.ys, self.xs = (a[::-1].copy() if f else a
                                     for a, f in zip((self.zs, self.ys, self.xs), self._flip))
        try:
            self.crs = crs_from_cf(ds['proj'].attrs)
        except (KeyError, ValueError):
            logger.warning("WARNING: I can't find a CRS in the weather model file, "
                           'so I will assume you are using WGS84')
            self.crs = Geographic()

    def field(self, name: str, dtype=torch.float64) -> torch.Tensor:
        """(z, y, x) field as a contiguous tensor on the cube's device."""
        arr = torch.as_tensor(self.ds[name].data, dtype=torch_dtype(dtype), device=self.device)
        dims = tuple(d for d, f in enumerate(self._flip) if f)
        if dims:
            arr = torch.flip(arr, dims)
        return arr.contiguous()


def tropo_delay(
    datetime: dt.datetime,
    weather_model_file,
    aoi: AOI,
    los: LOS,
    height_levels: Optional[list] = None,
    out_proj: Union[int, str] = 4326,
    zref: Optional[float] = None,
    compute_dtype=None,
    *,
    device='cuda',
    mesh: Optional[Mesh] = None,
    zshard: Union[str, bool] = 'auto',
    zshard_budget_gb: float = 10.0,
):
    """Delays on an AOI: (Dataset, None) for a cube-type AOI (``BoundingBox``,
    ``Geocube``), else (wet, hydro) host numpy arrays at the AOI's points.

    ``weather_model_file`` is a processed-weather Dataset or a file path;
    all computation runs on ``device``, the CUDA card unless the caller
    names another (without CUDA the default raises; nothing falls back).
    ``compute_dtype`` (of the delay kernels) defaults to float32 on CUDA and
    float64 on the CPU, like the JAX package's accelerator/CPU default.
    ``height_levels`` default to a Geocube's heights, else the model's
    levels. ``mesh`` shards the cube builders over several devices (by
    default ``parallel.default_mesh(device)``: every CUDA device for a bare
    'cuda', else ``device`` alone) and ``zshard``
    ('auto', True, False) with ``zshard_budget_gb`` chooses z-slab tables
    (the JAX package's ``RAIDER_TPU_ZSHARD`` and
    ``RAIDER_TPU_ZSHARD_BUDGET_GB``).
    """
    device = require_device(device)
    if mesh is None:
        mesh = default_mesh(device)
    if compute_dtype is None:
        compute_dtype = torch.float32 if device.type == 'cuda' else torch.float64
    compute_dtype = torch_dtype(compute_dtype)
    crs = crs_from_user(out_proj)
    wm = WeatherCube(weather_model_file, device)

    toa = wm.zs.max() - 1
    if height_levels is None:
        height_levels = aoi.readZ() if isinstance(aoi, Geocube) else wm.zs
    if zref is None:
        zref = toa
    if zref > toa:
        zref = toa
        logger.warning('Requested integration height (zref) is higher than top of weather '
                       f'model. Forcing to top ({toa}).')
    ds = _get_delays_on_cube(datetime, wm, weather_model_file, aoi, height_levels, los, crs,
                             zref, compute_dtype=compute_dtype, mesh=mesh, zshard=zshard,
                             zshard_budget_gb=zshard_budget_gb)
    if isinstance(aoi, (BoundingBox, Geocube)):
        return ds, None

    # the points stay float64 (float32 would quantize lat/lon at ~0.4 m)
    lat, lon, hgt = (torch.as_tensor(np.asarray(a, dtype=np.float64), device=device)
                     for a in (*aoi.readLL(), aoi.readZ()))
    wet, hydro = _delays_at_points(ds, lat, lon, hgt, crs, compute_dtype)
    if los.is_Projected():
        los.setTime(datetime)
        los.setPoints(lat, lon, hgt)
        wet = los(wet)
        hydro = los(hydro)
    return wet.cpu().numpy(), hydro.cpu().numpy()


def _delays_at_points(ds: Dataset, lat, lon, hgt, crs, compute_dtype):
    """The delay cube ``ds`` sampled at the float64 point tensors (an
    8-corner gather on their device). The cube goes in as ``compute_dtype``
    with ascending axes (its y axis is written N->S, and ``height_levels``
    may descend); the points are moved into ``crs`` when it is not
    geographic. Returns (wet, hydro) tensors."""
    device = lat.device
    if crs == Geographic():
        pts_y, pts_x, pts_z = lat, lon, hgt
    else:
        pts_x, pts_y, pts_z = transform_points(Geographic(), crs, lon, lat, hgt)

    cube_y, cube_x, cube_z = (np.asarray(ds.coords[k].data, dtype=np.float64) for k in 'yxz')
    flip = tuple(d for d, a in ((0, cube_z), (1, cube_y)) if a.size > 1 and a[0] > a[-1])
    if 0 in flip:
        cube_z = cube_z[::-1].copy()
    if 1 in flip:
        cube_y = cube_y[::-1].copy()
    out = []
    for name in ('wet', 'hydro'):
        cube = torch.as_tensor(np.asarray(ds[name].data), device=device).to(compute_dtype)
        if flip:
            cube = torch.flip(cube, flip)
        out.append(interp3d_points(cube.contiguous(), cube_y, cube_x, cube_z, pts_y, pts_x,
                                   pts_z))
    return out


def _get_delays_on_cube(datetime, wm: WeatherCube, weather_model_file, aoi, heights, los,
                        crs, zref, compute_dtype=torch.float64, mesh: Optional[Mesh] = None,
                        zshard: Union[str, bool] = 'auto', zshard_budget_gb: float = 10.0):
    """Build the delay cube and its Dataset."""
    zpts = np.array(heights, dtype=np.float64)
    if not hasattr(aoi, 'xpts'):
        res = float(min(np.diff(wm.xs).mean(), np.diff(wm.ys).mean()))
        if not wm.crs.is_geographic:
            # a projected model's axes are in metres; the spacing is in
            # degrees, at the 1e5 m a degree of the JAX package's rule
            res /= 1e5
        aoi.set_output_spacing(ll_res=res)
        aoi.set_output_xygrid(crs)

    if los.is_Zenith() or los.is_Projected():
        out_type = 'zenith' if los.is_Zenith() else 'slant - projected'
        with stage('delay.ztd_cube'):
            wet, hydro = _build_cube(wm, aoi.xpts, aoi.ypts, zpts, crs,
                                     ('wet_total', 'hydro_total'), compute_dtype, mesh=mesh)
    else:
        out_type = 'slant - raytracing'
        with stage('delay.raytrace_cube'):
            wet, hydro = _build_cube_ray(wm, aoi.xpts, aoi.ypts, zpts, los, crs, zref=zref,
                                         compute_dtype=compute_dtype, mesh=mesh,
                                         zshard=zshard, zshard_budget_gb=zshard_budget_gb)
    if np.isnan(wet).any() or np.isnan(hydro).any():
        logger.critical('There are missing delay values. Check your inputs.')
    return writeResultsToDataset(datetime, aoi.xpts, aoi.ypts, zpts, crs, wet, hydro,
                                 weather_model_file, out_type)


# output rows of the zenith cube's separable contractions a block
ZENITH_ROW_BLOCK = 256


def _build_cube(wm: WeatherCube, xpts, ypts, zpts, pts_crs, fields, compute_dtype,
                mesh: Optional[Mesh] = None):
    """Zenith cube: the integrated-delay fields on the output grid, all
    height levels at once; returns host numpy (z, y, x) arrays. The output
    rows are split over the mesh's shards (by default the cube's device
    alone), the cubes replicated. The separable path contracts z once on
    the cube's device, then y and x in blocks of ``ZENITH_ROW_BLOCK`` rows,
    whole blocks a shard: every mesh size runs the same contractions (a
    GEMM's bits depend on its shape), so a sharded cube is the unsharded
    one bit for bit."""
    mesh = mesh or Mesh((wm.device,))
    cubes = [wm.field(f, compute_dtype) for f in fields]
    # the separable path touches every cube entry per contraction line, so a
    # single NaN would poison whole rows: it needs NaN-free cubes
    if wm.crs == pts_crs and not any(bool(torch.isnan(c).any()) for c in cubes):
        w_y, w_x = (torch.as_tensor(grid_weights(a, p), dtype=compute_dtype, device=wm.device)
                    for a, p in ((wm.ys, ypts), (wm.xs, xpts)))
        w_z = grid_weights(wm.zs, zpts)
        blocks = [(lo, min(lo + ZENITH_ROW_BLOCK, len(ypts)))
                  for lo in range(0, len(ypts), ZENITH_ROW_BLOCK)]
        first = process_rank() * mesh.size
        mine = np.array_split(np.arange(len(blocks)),
                              mesh.size * process_group_size())[first:first + mesh.size]
        out = []
        for c in cubes:
            parts = [contract_yx(zc, wy[blocks[k][0]:blocks[k][1]], wx)
                     for (zc, wy, wx), ks in zip(replicate((contract_z(c, w_z), w_y, w_x), mesh),
                                                 mine) for k in ks]
            out.append(gather_rays(parts or [c.new_empty((len(zpts), 0, len(xpts)))],
                                   len(ypts), mesh, dim=1))
        return out

    # the gather path: the (y, x) grid in the model CRS, its rows split over
    # the shards, each shard's rows broadcast over the heights
    dev = wm.device
    xx, yy = np.meshgrid(xpts, ypts)
    lon, lat = pts_crs.inverse(torch.as_tensor(xx, device=dev), torch.as_tensor(yy, device=dev))
    mx, my = wm.crs.forward(lon, lat)
    (py, px), n_y = place_ray_arrays([my.to(compute_dtype), mx.to(compute_dtype)], 0, mesh)
    zz = torch.as_tensor(zpts, dtype=compute_dtype)[:, None, None]
    out = []
    for c in cubes:
        parts = []
        for c_d, y_d, x_d in zip(replicate(c, mesh), py, px):
            shape = (zpts.size,) + tuple(y_d.shape)
            parts.append(interp3d_points(c_d, wm.ys, wm.xs, wm.zs, y_d.expand(shape),
                                         x_d.expand(shape), zz.to(y_d.device).expand(shape)))
        out.append(gather_rays(parts, n_y, mesh, dim=1))
    return out


def _nanmax_rows(a: torch.Tensor) -> np.ndarray:
    """Row-wise nanmax of a (L, N) tensor as host float64 (NaN for all-NaN rows)."""
    m = torch.nan_to_num(a, nan=-float('inf')).amax(dim=1)
    m = torch.where(torch.isnan(a).all(dim=1), torch.full_like(m, float('nan')), m)
    return m.cpu().numpy().astype(np.float64)


def _slice_geometry(wm: WeatherCube, lat, lon, ht: float, los, zref: float):
    """Ray geometry of one output height, float64 on the device.

    lat/lon: (N,) float64 pixel tensors. Returns None when no model level
    contributes, else a dict with the (L+1, N) boundary points ``bnd_y``,
    ``bnd_x``, ``bnd_z`` in the model CRS (y and x shifted by the grid
    origin: float32 then quantizes at the grid extent's ulp, not the
    absolute coordinate's), ``d2`` (squared horizontal chord) and
    ``ray_len`` (L, N), the level chain ``heights``, and the host plan
    inputs ``per_level_max`` and ``hstep_max`` (L,).
    """
    hts = torch.full_like(lat, float(ht))
    xyz = torch.stack(lla2ecef(lat, lon, hts), dim=-1)
    with stage('raytrace.look_vectors', log=False):
        look = los.getLookVectors(ht, [lon, lat, hts], xyz)
    with stage('raytrace.build_ray', log=False):
        ray_lengths, low_xyzs, high_xyzs = build_ray(wm.zs, float(ht), xyz, look, zref)
    if ray_lengths is None:
        return None
    if bool(torch.isnan(ray_lengths).all()):
        raise ValueError('geo2rdr did not converge. Check orbit coverage')

    # contiguous segments: only the L+1 unique boundary points are transformed
    bounds_xyz = torch.cat([low_xyzs, high_xyzs[-1:]], dim=0)
    gx, gy, gz = transform_points(Geocentric(), wm.crs, bounds_xyz[..., 0],
                                  bounds_xyz[..., 1], bounds_xyz[..., 2])
    bnd_y = gy - float(wm.ys[0])
    bnd_x = gx - float(wm.xs[0])
    chord2 = torch.sum((high_xyzs - low_xyzs) ** 2, dim=-1)
    dz = gz[1:] - gz[:-1]
    d2 = torch.clamp_min(chord2 - dz ** 2, 0.0)
    # per-level max horizontal motion (model units), inflated by the f32
    # coordinate quantization so the brick grouping bound stays conservative
    hstep = torch.hypot(bnd_y[1:] - bnd_y[:-1], bnd_x[1:] - bnd_x[:-1])
    return dict(bnd_y=bnd_y, bnd_x=bnd_x, bnd_z=gz, d2=d2, ray_len=ray_lengths,
                heights=level_heights(wm.zs, float(ht), zref),
                per_level_max=_nanmax_rows(ray_lengths),
                hstep_max=_nanmax_rows(hstep) * (1.0 + 1e-5) + 1e-7)


def _build_cube_ray(wm: WeatherCube, xpts, ypts, zpts, los, pts_crs, zref,
                    compute_dtype=torch.float64,
                    max_segment_length: float = MAX_SEGMENT_LENGTH,
                    mesh: Optional[Mesh] = None, zshard: Union[str, bool] = 'auto',
                    zshard_budget_gb: float = 10.0):
    """Raytraced cube: float64 geometry and the integrate per output height,
    on the weather cube's device. The table is packed once in the mode
    ``pack_mode_for`` picks for the cube; an int16 mode's ``(table, deq)``
    pair rides into every slice's ``integrate_rays``. Either the table is
    packed once in z-slabs over the mesh's shards (where ``zshard_auto``
    says so) and each slice integrated by ``integrate_rays_z_sharded``, or
    each slice's rays are split over the shards by ``shard_rays`` (the
    cube's device alone when the mesh has fewer than 8 pixels a shard), its
    plan built from all of them. Returns host float64 (z, y, x) arrays
    (wet, hydro)."""
    compute_dtype = torch_dtype(compute_dtype)
    mesh = mesh or Mesh((wm.device,))
    dev = wm.device
    cube_wet = wm.field('wet', compute_dtype)
    cube_hydro = wm.field('hydro', compute_dtype)
    # the kernel's axes carry the same origin shift as the boundary points
    ys_k = wm.ys - wm.ys[0]
    xs_k = wm.xs - wm.xs[0]
    n_shards = mesh.size * process_group_size()
    pack_mode = pack_mode_for(cube_wet.shape, _np_dtype(cube_wet), grouped=True)
    xx, yy = np.meshgrid(xpts, ypts)
    npix = xx.size
    if zshard_auto(cube_wet.shape, compute_dtype, pack_mode, n_shards,
                   force=None if zshard == 'auto' else bool(zshard),
                   budget_gb=zshard_budget_gb):
        slabs = pack_cube_slabs(cube_wet, cube_hydro, pack_mode, mesh.size, mesh=mesh)

        def integrate(*rays, per_level_max, plan):
            return integrate_rays_z_sharded(cube_wet, cube_hydro, ys_k, xs_k, wm.zs, *rays,
                                            per_level_max, max_segment_length, mode=pack_mode,
                                            mesh=mesh, packed=slabs)
    else:
        table, _ = pack_cubes(cube_wet, cube_hydro, mode=pack_mode)

        def per_shard(by, bx, bz, d2, rl, re, table, per_level_max, plan):
            return integrate_rays(cube_wet, cube_hydro, ys_k, xs_k, wm.zs, by, bx, bz, d2, rl,
                                  re, per_level_max, max_segment_length, packed2d=table,
                                  mode=pack_mode, **plan)
        ray_mesh = mesh if npix >= 8 * n_shards else Mesh(mesh.devices[:1])
        sharded = shard_rays(per_shard, ray_mesh, ray_axis_argnums={0: 1, 1: 1, 2: 1, 3: 1, 4: 1,
                                                                    5: 0})

        def integrate(*rays, per_level_max, plan):
            return sharded(*rays, table, per_level_max, plan)

    lon, lat = pts_crs.inverse(torch.as_tensor(xx.ravel(), dtype=torch.float64, device=dev),
                               torch.as_tensor(yy.ravel(), dtype=torch.float64, device=dev))
    re_local = get_Re(lat).to(compute_dtype)
    out = torch.zeros((2, zpts.size, npix), dtype=torch.float64, device=dev)
    for hh, ht in enumerate(zpts):
        logger.info(f'Processing slice {hh + 1} / {len(zpts)}: {ht}')
        with stage('raytrace.device_geometry', log=False):
            geom = _slice_geometry(wm, lat, lon, float(ht), los, zref)
        if geom is None:
            # no model level contributes at this height: the delay stays 0
            continue
        rays = [geom[k].to(compute_dtype) for k in ('bnd_y', 'bnd_x', 'bnd_z', 'd2', 'ray_len')]
        with stage('raytrace.integrate', log=False):
            out[0, hh], out[1, hh] = integrate(
                *rays, re_local, per_level_max=geom['per_level_max'],
                plan=dict(heights=geom['heights'], hstep_max=geom['hstep_max']))
    with stage('raytrace.final_fetch', log=False):
        # every process holds every slice whole (gathered or summed above)
        out = out.cpu().numpy().reshape(2, zpts.size, ypts.size, xpts.size)
    return out[0], out[1]


def writeResultsToDataset(datetime, xpts, ypts, zpts, crs, wetDelay, hydroDelay,
                          weather_model_file, out_type) -> Dataset:
    """CF-1.7 delay cube (the JAX package's writer schema)."""
    source = weather_model_file if isinstance(weather_model_file, (str, os.PathLike)) else 'in-memory'
    attrs = {
        'Conventions': 'CF-1.7',
        'title': 'RAiDER geo cube',
        'source': os.path.basename(str(source)),
        'history': str(dt.datetime.now(tz=dt.timezone.utc)) + ' raider-tpu-torch',
        'description': f'RAiDER geo cube - {out_type}',
        'reference_time': datetime.strftime('%Y%m%dT%H:%M:%S'),
    }
    coords = {
        'x': Variable(('x',), np.asarray(xpts), {}),
        'y': Variable(('y',), np.asarray(ypts), {}),
        'z': Variable(('z',), np.asarray(zpts),
                      {'axis': 'Z', 'units': 'm', 'description': 'height above ellipsoid'}),
    }
    if crs.is_geographic:
        coords['y'].attrs.update(units='degrees_north', standard_name='latitude',
                                 long_name='latitude')
        coords['x'].attrs.update(units='degrees_east', standard_name='longitude',
                                 long_name='longitude')
    else:
        coords['y'].attrs.update(axis='Y', standard_name='projection_y_coordinate',
                                 long_name='y-coordinate in projected coordinate system', units='m')
        coords['x'].attrs.update(axis='X', standard_name='projection_x_coordinate',
                                 long_name='x-coordinate in projected coordinate system', units='m')
    variables = {
        'wet': Variable(('z', 'y', 'x'), np.asarray(wetDelay),
                        {'units': 'm', 'description': f'wet {out_type} delay',
                         'grid_mapping': 'crs'}),
        'hydro': Variable(('z', 'y', 'x'), np.asarray(hydroDelay),
                          {'units': 'm', 'description': f'hydrostatic {out_type} delay',
                           'grid_mapping': 'crs'}),
        'crs': Variable((), np.int64(-2147483647), dict(crs.to_cf())),
    }
    return Dataset(coords=coords, variables=variables, attrs=attrs)
