"""GUNW interferometric tropospheric correction workflow.

The counterpart of ``raider_tpu/workflows/gunw.py``: read the acquisition
geometry of an ARIA GUNW product, compute two epochs of raytraced delay
cubes (``calc_delays.calcDelays`` on ``device``: kernel B1 in every fresh
weather-model load, B2 in every raytraced slice), turn them into
interferometric phase and package them back into the GUNW under
``science/grids/corrections/external/troposphere/<MODEL>``.

A GUNW product is netCDF4/HDF5 with groups, which only h5py reads and
writes here. The module therefore keeps h5py to two thin layers, each of
which imports it inside itself:

  * the reader, :func:`read_gunw_metadata`: every value the workflow takes
    from the product (the bounding-box WKT, the input granules of both
    epochs, the wavelength, the extent of the ``science/grids/data``
    latitude/longitude grid) as a plain :class:`GUNWMetadata` record;
  * the writers, :func:`update_gunw_slc` and :func:`update_gunw_version`,
    which write what the pure :func:`troposphere_layout` lays out (groups,
    arrays, dimension scales, attributes, the CRS WKT).

Everything between them runs without h5py: :func:`run_gunw` goes from a
metadata record through the run config (:func:`prep_from_gunw`), the
port's ``calcDelays`` (whose cubes may be netCDF-3,
``nc_format='NETCDF3_64BIT_OFFSET'``, on a machine without h5py) to the
phase arrays (:func:`compute_delays_slc`). On such a machine
``calcDelaysGUNW --file`` raises an ``ImportError`` naming h5py: nothing
falls back.

The arithmetic is the JAX package's: the phase is ``float64(delay) *
(-4 pi / wavelength)``, cast to float32 when written. The one attribute
whose value differs by package is ``raider_tpu_version``: it keeps its
name and holds ``raider_tpu_torch.__version__``.
"""

import argparse
import datetime as dt
import json
import os
import re
from dataclasses import dataclass
from pathlib import Path
from typing import List, NamedTuple, Optional, Tuple, Union

import numpy as np

import raider_tpu_torch
from raider_tpu_torch.io import read_nc
from raider_tpu_torch.logger import logger
from raider_tpu_torch.utils.geom2d import polygon_intersects_box
from raider_tpu_torch.workflows.config import write_yaml
from raider_tpu_torch.wx import credentials
from raider_tpu_torch.wx.exceptions import NoWeatherModelData
from raider_tpu_torch.wx.registry import get_wm_by_name

TROPO_GROUP = 'science/grids/corrections/external/troposphere'
TROPO_NAMES = ['troposphereWet', 'troposphereHydrostatic']
DIM_NAMES = ['heightsMeta', 'latitudeMeta', 'longitudeMeta']

# cube spacing in degrees per model
DCT_POSTING = {'HRRR': 0.05, 'HRES': 0.10, 'GMAO': 0.10, 'ERA5': 0.10,
               'ERA5T': 0.10, 'MERRA2': 0.1}

_GRANULES = 'science/radarMetaData/inputSLC/{}/L1InputGranules'
_DATA_GRID = 'science/grids/data'


def _wkt_polygon_bounds(wkt: str) -> Tuple[float, float, float, float]:
    """(W, S, E, N) bounds of a WKT POLYGON string."""
    nums = re.findall(r'(-?\d+\.?\d*)\s+(-?\d+\.?\d*)', wkt)
    xs = np.array([float(a) for a, _ in nums])
    ys = np.array([float(b) for _, b in nums])
    return float(xs.min()), float(ys.min()), float(xs.max()), float(ys.max())


def _strings(vals) -> List[str]:
    out = []
    for v in np.atleast_1d(vals):
        if isinstance(v, bytes):
            v = v.decode()
        if v:
            out.append(str(v))
    return out


def _get_acq_time_from_gunw_id(gunw_id: str, reference_or_secondary: str) -> dt.datetime:
    if reference_or_secondary not in ('reference', 'secondary'):
        raise ValueError('reference_or_secondary must be "reference" or "secondary"')
    tokens = gunw_id.split('-')
    date_tokens = tokens[6].split('_')
    date_token = date_tokens[0] if reference_or_secondary == 'reference' else date_tokens[1]
    t = tokens[7]
    return dt.datetime(
        int(date_token[:4]), int(date_token[4:6]), int(date_token[6:]),
        int(t[:2]), int(t[2:4]), int(t[4:]),
    )


# ------------------------------------------------------------ the reader

@dataclass
class GUNWMetadata:
    """What the workflow reads from a GUNW product (:func:`read_gunw_metadata`).

    ``path``: the product's path; its file name carries the look direction,
    the dates and the mid time. ``bbox_wkt``: the ``productBoundingBox``
    polygon. ``granules``: the L1 input granule names by epoch
    ('reference', 'secondary'). ``wavelength`` in metres. ``data_extent``:
    (lon_min, lat_min, lon_max, lat_max) of the ``science/grids/data``
    grid, or None where the product has no such grid.
    """

    path: str
    bbox_wkt: str
    granules: dict
    wavelength: float
    data_extent: Optional[Tuple[float, float, float, float]] = None


def read_gunw_metadata(path) -> GUNWMetadata:
    """Every value the workflow takes from the GUNW product at ``path``
    (read with h5py, imported here)."""
    try:
        import h5py
    except ImportError as exc:
        raise ImportError('reading a GUNW product (netCDF4/HDF5 with groups) needs h5py, which '
                          'is not installed; run_gunw() takes a GUNWMetadata record instead') \
            from exc

    with h5py.File(path, 'r') as f:
        poly = f['productBoundingBox'][()][0]
        granules = {k: _strings(f[_GRANULES.format(k)][()]) for k in ('reference', 'secondary')}
        wavelength = float(f['science/radarMetaData/wavelength'][()])
        extent = None
        if f'{_DATA_GRID}/latitude' in f and f'{_DATA_GRID}/longitude' in f:
            lats = np.asarray(f[f'{_DATA_GRID}/latitude'][()], dtype=np.float64)
            lons = np.asarray(f[f'{_DATA_GRID}/longitude'][()], dtype=np.float64)
            extent = (float(lons.min()), float(lats.min()), float(lons.max()), float(lats.max()))
    if isinstance(poly, bytes):
        poly = poly.decode()
    return GUNWMetadata(path=str(path), bbox_wkt=str(poly), granules=granules,
                        wavelength=wavelength, data_extent=extent)


def _metadata(gunw: Union[GUNWMetadata, str, Path]) -> GUNWMetadata:
    return gunw if isinstance(gunw, GUNWMetadata) else read_gunw_metadata(gunw)


# ----------------------------------------------------- availability checks

def check_hrrr_dataset_availablity_for_s1_azimuth_time_interpolation(
    gunw_id: str, weather_model_name: str = 'hrrr'
) -> bool:
    from raider_tpu_torch.workflows.s1_timing import get_times_for_azimuth_interpolation
    from raider_tpu_torch.wx.hrrr import check_hrrr_dataset_availability

    ref_t = _get_acq_time_from_gunw_id(gunw_id, 'reference')
    sec_t = _get_acq_time_from_gunw_id(gunw_id, 'secondary')
    step = 1 if weather_model_name == 'hrrr' else 3
    times = get_times_for_azimuth_interpolation(ref_t, step) + \
        get_times_for_azimuth_interpolation(sec_t, step)
    return all(check_hrrr_dataset_availability(t, weather_model_name) for t in times)


def check_weather_model_availability(gunw, weather_model_name: str) -> bool:
    """Both GUNW epochs within the model's valid range; ``gunw`` is a path
    or a :class:`GUNWMetadata` record."""
    meta = _metadata(gunw)
    gunw_id = Path(meta.path).name.replace('.nc', '')
    ref_t = _get_acq_time_from_gunw_id(gunw_id, 'reference')
    sec_t = _get_acq_time_from_gunw_id(gunw_id, 'secondary')

    if weather_model_name == 'HRRR' and meta.data_extent is not None:
        from raider_tpu_torch.wx.hrrr import HRRR_AK_COVERAGE_POLYGON

        w, s, e, n = meta.data_extent
        if polygon_intersects_box(HRRR_AK_COVERAGE_POLYGON, (np.mod(w, 360), s, np.mod(e, 360), n)):
            weather_model_name = 'HRRRAK'

    _, Model = get_wm_by_name(weather_model_name)
    model = Model()
    start, end = model._valid_range
    ref_t = ref_t.replace(tzinfo=dt.timezone.utc)
    sec_t = sec_t.replace(tzinfo=dt.timezone.utc)
    ref_ok = start <= ref_t and (end is None or ref_t <= end)
    sec_ok = start <= sec_t and (end is None or sec_t <= end)
    return ref_ok and sec_ok


def identify_which_hrrr(gunw) -> str:
    """CONUS vs Alaska; ``gunw`` is a path or a :class:`GUNWMetadata` record."""
    from raider_tpu_torch.wx.hrrr import HRRR_AK_COVERAGE_POLYGON, HRRR_CONUS_COVERAGE_POLYGON

    meta = _metadata(gunw)
    if meta.data_extent is None:
        raise KeyError(f'GUNW {meta.path} has no {_DATA_GRID} latitude/longitude grid')
    w, s, e, n = meta.data_extent
    if polygon_intersects_box(HRRR_CONUS_COVERAGE_POLYGON, (w, s, e, n)):
        return 'HRRR'
    if polygon_intersects_box(HRRR_AK_COVERAGE_POLYGON, (np.mod(w, 360), s, np.mod(e, 360), n)):
        return 'HRRRAK'
    raise NoWeatherModelData(
        f'GUNW {meta.path} does not intersect with any HRRR coverage area. '
        'Please use a different weather model.'
    )


# -------------------------------------------------------------- run config

class GUNW:
    """Run parameters of a GUNW product, built from its path (read with
    h5py) or, without h5py, from its :class:`GUNWMetadata` record."""

    def __init__(self, gunw, wm: str, out_dir: str) -> None:
        self.meta = _metadata(gunw)
        self.path_gunw = Path(self.meta.path)
        self.wm = wm
        self.out_dir = Path(out_dir)

        self.SNWE = self.get_bbox()
        self.heights = np.arange(-500, 9500, 500).tolist()
        self.dates, self.mid_time = self.get_datetimes()
        self.look_dir = self.get_look_dir()
        self.wavelength = self.get_wavelength()
        self.name = self.make_fname()
        self.orbit_file = self.get_orbit_file()
        self.spacing_m = int(DCT_POSTING[self.wm] * 1e5)

    def get_bbox(self):
        w, s, e, n = _wkt_polygon_bounds(self.meta.bbox_wkt)
        return s, n, w, e

    def make_fname(self) -> str:
        ref, sec = self.path_gunw.name.split('-')[6].split('_')
        mid_time = self.path_gunw.name.split('-')[7]
        return f'{ref}-{sec}_{mid_time}'

    def get_slc_dt(self) -> list:
        lst_sten = []
        for key in ('reference', 'secondary'):
            st, en = dt.datetime(1989, 3, 1), dt.datetime(1989, 3, 1)
            for slc in self.meta.granules[key]:
                st_tmp = dt.datetime.strptime(slc.split('_')[5], '%Y%m%dT%H%M%S')
                en_tmp = dt.datetime.strptime(slc.split('_')[6], '%Y%m%dT%H%M%S')
                if st > dt.datetime(1989, 3, 1):
                    if not (abs((st_tmp - st).days) < 2 and abs((en_tmp - en).days) < 2):
                        raise ValueError('SLC granules are too far apart in time. '
                                         'Incorrect metadata')
                st = max(st, st_tmp)
                en = max(en, en_tmp)
            if not st > dt.datetime(1989, 3, 1):
                raise ValueError(f'Missing {key} SLC metadata in GUNW: {self.path_gunw}')
            lst_sten.append((st, en))
        return lst_sten

    def get_datetimes(self):
        mid_dates = []
        mid_time = None
        for st, en in self.get_slc_dt():
            midpoint = st + (en - st) / 2
            mid_dates.append(int(midpoint.date().strftime('%Y%m%d')))
            mid_time = midpoint.time().strftime('%H:%M:%S')
        return mid_dates, mid_time

    def get_look_dir(self) -> str:
        return 'right' if self.path_gunw.name.split('-')[3].lower() == 'r' else 'left'

    def get_wavelength(self) -> float:
        return float(self.meta.wavelength)

    def get_orbit_file(self) -> list:
        """The reference epoch's orbit files (``s1_timing``'s look-up:
        network, looked up when called)."""
        orbit_dir = self.out_dir / 'orbits'
        orbit_dir.mkdir(parents=True, exist_ok=True)
        slcs = [s.replace('.zip', '') for s in self.meta.granules['reference'] if s]
        from raider_tpu_torch.workflows.s1_timing import get_orbits_from_slc_ids_hyp3lib

        return [str(o) for o in get_orbits_from_slc_ids_hyp3lib(slcs, str(orbit_dir))]


def prep_from_gunw(gunw, weather_model: str, output_directory: str,
                   interpolate_time: str = 'azimuth_time_grid',
                   api_uid=None, api_key=None) -> Tuple[Path, float]:
    """GUNW (a path or a :class:`GUNWMetadata` record) -> the run-config
    YAML ``GUNW_<dates>_<time>.yaml`` in the working directory; returns its
    path and the wavelength."""
    credentials.check_api(weather_model, api_uid, api_key)
    obj = GUNW(gunw, weather_model, output_directory)

    cfg = {
        'weather_model': weather_model,
        'look_dir': obj.look_dir,
        'aoi_group': {'bounding_box': list(obj.SNWE)},
        'height_group': {'height_levels': obj.heights},
        'date_group': {'date_list': obj.dates},
        'time_group': {'time': obj.mid_time, 'interpolate_time': interpolate_time},
        'los_group': {'ray_trace': True, 'orbit_file': obj.orbit_file},
        'runtime_group': {
            'raster_format': 'nc',
            'output_directory': str(output_directory),
            'cube_spacing_in_m': obj.spacing_m,
        },
    }
    path_cfg = Path(f'GUNW_{obj.name}.yaml')
    write_yaml(cfg, path_cfg)
    return path_cfg, obj.wavelength


# ------------------------------------------------------- phase packaging

def compute_delays_slc(cube_paths: List[Path], wavelength: float):
    """Delay cubes (netCDF-3 or netCDF4) -> two-epoch phase arrays in
    radians, float64. Returns (model_name, dict of arrays, coords,
    crs_attrs, per-epoch attrs)."""
    dct_delays = {}
    for path in cube_paths:
        date = dt.datetime.strptime(Path(path).name.split('_')[2], '%Y%m%dT%H%M%S')
        dct_delays[date] = Path(path)
    sec, ref = sorted(dct_delays.keys())

    phase2range = (-4 * np.pi) / float(wavelength)
    out = {}
    attrs_lst = []
    coords = None
    crs_attrs = None
    model = None
    for key, datetime in zip(('reference', 'secondary'), (ref, sec)):
        path = dct_delays[datetime]
        ds = read_nc(path)
        for name, var in zip(TROPO_NAMES, ('wet', 'hydro')):
            out[f'{key}_{name}'] = np.asarray(ds[var].data, dtype=np.float64) * phase2range
        # a one-element string list reads back as a list from netCDF-3 and
        # as its string from netCDF4: take the netCDF4 reading, so that the
        # packaged attributes do not depend on the cubes' format
        attrs_lst.append({k: (v[0] if len(v) == 1 else [str(x) for x in v])
                          if isinstance(v, list) else v for k, v in ds.attrs.items()})
        coords = {
            DIM_NAMES[0]: np.asarray(ds.coords['z'].data, dtype=np.float32),
            DIM_NAMES[1]: np.asarray(ds.coords['y'].data, dtype=np.float32),
            DIM_NAMES[2]: np.asarray(ds.coords['x'].data, dtype=np.float32),
        }
        crs_attrs = dict(ds['crs'].attrs)
        model = Path(path).name.split('_')[0]
    return model, out, coords, crs_attrs, attrs_lst


def _attr(v):
    return np.bytes_(v) if isinstance(v, str) else v


def troposphere_layout(model: str, arrays: dict, coords: dict, crs_attrs: dict,
                       attrs_lst: list) -> dict:
    """What :func:`update_gunw_slc` writes, laid out without h5py.

    Returns ``{'group': <model group path>, 'clear': [names deleted from
    the troposphere group], 'chunks': (z, y, x), 'epochs': {'reference' |
    'secondary': {'dims': {name: float32 array}, 'crs': {'data': int32 0,
    'attrs': {...}, 'wkt': {...}}, 'variables': {name: {'data': float32
    array, 'dims': DIM_NAMES, 'attrs': {...}}}}}}``. Attribute strings are
    ``np.bytes_``, as written. The crs ``attrs`` are the cube's CF
    attributes; ``wkt`` holds ``crs_wkt`` and ``spatial_ref`` from the
    port's ``geodesy.crs.crs_from_cf(crs_attrs).to_wkt()`` (empty when the
    CF attributes carry ``crs_wkt`` or name no CRS the port knows), written
    only where the crs dataset has no ``crs_wkt`` yet.
    """
    chunks = tuple(
        int(max(1, np.floor(c))) for c in (
            coords[DIM_NAMES[0]].size,
            coords[DIM_NAMES[1]].size / 3,
            coords[DIM_NAMES[2]].size / 3,
        )
    )
    crs_out = {k: _attr(v) for k, v in crs_attrs.items()}
    crs_wkt = {}
    if 'crs_wkt' not in crs_out:
        # downstream GUNW consumers read the CRS from crs_wkt / spatial_ref
        from raider_tpu_torch.geodesy.crs import crs_from_cf

        try:
            wkt = np.bytes_(crs_from_cf(crs_attrs).to_wkt())
            crs_wkt = {'crs_wkt': wkt, 'spatial_ref': wkt}
        except (ValueError, KeyError, NotImplementedError):
            logger.debug('could not derive crs_wkt from CF attrs')

    epochs = {}
    for k, rs in enumerate(('reference', 'secondary')):
        variables = {}
        for name in TROPO_NAMES:
            kind = name.replace('troposphere', '').lower()
            desc = f'Delay due to {kind} component of troposphere'
            attrs = {
                'units': np.bytes_('radians'),
                'grid_mapping': np.bytes_('crs'),
                'description': np.bytes_(desc),
                'long_name': np.bytes_(name),
                'standard_name': np.bytes_(name),
                'raider_tpu_version': np.bytes_(raider_tpu_torch.__version__),
            }
            for meta_key in ('model_times_used', 'reference_time', 'interpolation_method'):
                if meta_key in attrs_lst[k]:
                    val = attrs_lst[k][meta_key]
                    attrs[meta_key] = np.bytes_(str(val)) if isinstance(val, (str, list)) else val
            variables[name] = {'data': arrays[f'{rs}_{name}'].astype(np.float32),
                               'dims': list(DIM_NAMES), 'attrs': attrs}
        epochs[rs] = {'dims': {d: coords[d] for d in DIM_NAMES},
                      'crs': {'data': np.int32(0), 'attrs': crs_out, 'wkt': crs_wkt},
                      'variables': variables}
    return {'group': f'{TROPO_GROUP}/{model.upper()}', 'clear': TROPO_NAMES + ['crs'],
            'chunks': chunks, 'epochs': epochs}


def update_gunw_slc(path_gunw, model: str, arrays: dict, coords: dict,
                    crs_attrs: dict, attrs_lst: list) -> None:
    """Write the phase cubes into the GUNW's troposphere group (with h5py,
    imported here): :func:`troposphere_layout`, written."""
    import h5py

    layout = troposphere_layout(model, arrays, coords, crs_attrs, attrs_lst)
    with h5py.File(path_gunw, 'a') as f:
        grp = f.require_group(TROPO_GROUP)
        # clear the pre-update layout
        for name in layout['clear']:
            if name in grp:
                del grp[name]
        wm_grp = f.require_group(layout['group'])
        for rs, epoch in layout['epochs'].items():
            rs_grp = wm_grp.require_group(rs)
            for dim, data in epoch['dims'].items():
                if dim not in rs_grp:
                    d = rs_grp.create_dataset(dim, data=data)
                    d.make_scale(dim)
            if 'crs' not in rs_grp:
                v_proj = rs_grp.create_dataset('crs', data=epoch['crs']['data'])
            else:
                v_proj = rs_grp['crs']
            for ck, cv in epoch['crs']['attrs'].items():
                v_proj.attrs[ck] = cv
            if 'crs_wkt' not in v_proj.attrs:
                for ck, cv in epoch['crs']['wkt'].items():
                    v_proj.attrs[ck] = cv
            for name, var in epoch['variables'].items():
                if name in rs_grp:
                    del rs_grp[name]
                v = rs_grp.create_dataset(name, data=var['data'], chunks=layout['chunks'],
                                          fillvalue=0.0, dtype=np.float32)
                for i, dim in enumerate(var['dims']):
                    v.dims[i].attach_scale(rs_grp[dim])
                for ak, av in var['attrs'].items():
                    v.attrs[ak] = av
    logger.info('Updated %s group in: %s', os.path.basename(TROPO_GROUP), path_gunw)


def update_gunw_version(path_gunw) -> None:
    import h5py

    with h5py.File(path_gunw, 'a') as f:
        f.attrs['version'] = np.bytes_('1c')


def tropo_gunw_slc(cube_paths: List[Path], path_gunw, wavelength: float):
    """Compute and package the troposphere phase delays."""
    model, arrays, coords, crs_attrs, attrs_lst = compute_delays_slc(cube_paths, wavelength)
    update_gunw_slc(path_gunw, model, arrays, coords, crs_attrs, attrs_lst)
    update_gunw_version(path_gunw)
    logger.info('Wrote slc delays to: %s', path_gunw)
    return model, arrays


# ----------------------------------------------------------- compute path

class GUNWDelays(NamedTuple):
    """What :func:`run_gunw` computed: the two cube paths, the wavelength
    and :func:`compute_delays_slc`'s outputs."""

    cube_paths: list
    wavelength: float
    model: str
    arrays: dict
    coords: dict
    crs_attrs: dict
    attrs: list


def run_gunw(meta, weather_model: str, output_directory, *,
             interpolate_time: str = 'azimuth_time_grid', device='cuda',
             nc_format: str = 'NETCDF4', api_uid=None, api_key=None) -> GUNWDelays:
    """The GUNW compute path, without h5py: ``meta`` (a
    :class:`GUNWMetadata` record, or a product path) -> the run config
    (:func:`prep_from_gunw`, written to the working directory) -> the
    port's ``calcDelays`` on ``device``, its cubes written in ``nc_format``
    -> the two epochs' phase arrays."""
    from raider_tpu_torch.workflows import calc_delays

    path_cfg, wavelength = prep_from_gunw(
        meta, weather_model, output_directory, interpolate_time=interpolate_time,
        api_uid=api_uid, api_key=api_key)
    cube_paths = calc_delays.calcDelays([str(path_cfg)], device=device, nc_format=nc_format)
    if len(cube_paths) != 2:
        raise ValueError(f'Incorrect number of delay files retrieved: {cube_paths}')
    return GUNWDelays(list(cube_paths), wavelength,
                      *compute_delays_slc(cube_paths, wavelength))


# --------------------------------------------------------------- entrypoint

def calcDelaysGUNW(iargs: Optional[list] = None, *, device='cuda', nc_format: str = 'NETCDF4'):
    """HyP3/S3-aware GUNW correction entry point: S3 inputs (``aws``), the
    availability checks, :func:`run_gunw` on ``device`` (cubes in
    ``nc_format``), the packaging into the product, and the uploads.
    Returns the two cube paths."""
    p = argparse.ArgumentParser(
        description='Calculate a cube of interferometric delays for GUNW files',
    )
    p.add_argument('--bucket', help='S3 bucket containing the GUNW product')
    p.add_argument('--bucket-prefix', default='', help='S3 bucket prefix for the GUNW')
    p.add_argument('--input-bucket-prefix', help='S3 bucket prefix of the input GUNW')
    p.add_argument('-f', '--file', type=str, help='1 ARIA GUNW netcdf file')
    p.add_argument('-m', '--weather-model', default='HRRR',
                   choices=['None', 'HRRR', 'HRES', 'GMAO', 'ERA5', 'ERA5T', 'MERRA2'],
                   help='Weather model')
    p.add_argument('-uid', '--api_uid', default=None, help='API UID for the weather model API')
    p.add_argument('-key', '--api_key', default=None, help='API key for the weather model API')
    p.add_argument('-interp', '--interpolate-time', default='azimuth_time_grid',
                   choices=['none', 'center_time', 'azimuth_time_grid'])
    p.add_argument('-o', '--output-directory', default=os.getcwd())
    args = p.parse_args(iargs)

    if args.weather_model == 'None':
        print('Nothing to do!')
        return

    if args.file is None and args.bucket is None:
        raise ValueError('Provide either a GUNW file or an S3 bucket')

    # the product is read once (h5py), here or after its S3 download
    meta = read_gunw_metadata(args.file) if args.file is not None else None
    # CONUS/Alaska disambiguation + azimuth-grid availability check
    if (meta is not None and args.weather_model == 'HRRR'
            and args.interpolate_time == 'azimuth_time_grid'):
        gunw_id = Path(args.file).name.replace('.nc', '')
        wm_name = identify_which_hrrr(meta)
        try:
            ok = check_hrrr_dataset_availablity_for_s1_azimuth_time_interpolation(
                gunw_id, wm_name.lower())
        except Exception:
            ok = True  # the availability probe needs the network; as in the JAX package
        if not ok:
            raise NoWeatherModelData(
                'The required HRRR data for time-grid interpolation is not available'
            )
        # the run config keeps 'HRRR'; the model class casts itself to the
        # Alaska domain from the AOI bounds (wx.hrrr.HRRR.checkValidBounds)

    json_path = None
    if args.bucket:
        from raider_tpu_torch.workflows import aws

        in_prefix = args.input_bucket_prefix or args.bucket_prefix
        args.file = aws.get_s3_file(args.bucket, in_prefix, '.nc')
        if args.file is None:
            raise ValueError('GUNW product file could not be found at S3 location')
        json_path = aws.get_s3_file(args.bucket, in_prefix, '.json')
        if json_path is None:
            raise ValueError('GUNW metadata file could not be found at S3 location')
        json_data = json.loads(Path(json_path).read_text())
        json_data['metadata'].setdefault('weather_model', []).append(args.weather_model)
        Path(json_path).write_text(json.dumps(json_data))
        # browse image: needed for HyP3 ingest when re-uploading the product
        browse_path = aws.get_s3_file(args.bucket, in_prefix, '.png')
        if browse_path is None:
            raise ValueError('GUNW browse image could not be found at S3 location')

        # graceful exits so downstream processing can continue
        gunw_id = Path(args.file).name.replace('.nc', '')
        if args.weather_model == 'HRRR' and args.interpolate_time == 'azimuth_time_grid':
            try:
                ok = check_hrrr_dataset_availablity_for_s1_azimuth_time_interpolation(gunw_id)
            except Exception:
                ok = True
            if not ok:
                print('The required HRRR data is not available; '
                      'exiting so the process can continue')
                return
        meta = read_gunw_metadata(args.file)

    if not check_weather_model_availability(meta, args.weather_model):
        print(
            f'Weather model {args.weather_model} is not available for the '
            'acquisition dates; exiting gracefully so the process can continue'
        )
        return

    run = run_gunw(meta, args.weather_model, args.output_directory,
                   interpolate_time=args.interpolate_time, device=device,
                   nc_format=nc_format, api_uid=args.api_uid, api_key=args.api_key)

    # package into the GUNW
    update_gunw_slc(args.file, run.model, run.arrays, run.coords, run.crs_attrs, run.attrs)
    update_gunw_version(args.file)
    logger.info('Wrote slc delays to: %s', args.file)

    if args.bucket:
        from raider_tpu_torch.workflows import aws

        aws.upload_file_to_s3(args.file, args.bucket, args.bucket_prefix)
        aws.upload_file_to_s3(json_path, args.bucket, args.bucket_prefix)
        aws.upload_file_to_s3(browse_path, args.bucket, args.bucket_prefix)
    return run.cube_paths
