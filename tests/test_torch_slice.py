"""The port's delay path end to end vs the JAX package (CPU).

``tropo_delay`` on the LA synthetic weather dataset of tests/test_raytrace.py
(smooth refractivity and integrated-delay cubes), ~170 pixels at 2 heights,
with the compute dtype pinned on both sides. Raytracing uses the synthetic
polar orbit of tests/test_orbit.py; the JAX package takes its host-f64
geometry path on the CPU, which is the algorithm the port runs.

Tolerances: float64 <= 1e-9 m (the same f64 geometry and quadrature; only
rounding order differs); float32 <= 1e-5 m (float32 coordinates and
refractivities, sums of ~100 samples).
"""

import datetime as dt
import inspect
import os
import subprocess
import sys
import textwrap

import numpy as np
import pytest
import torch

from raider_tpu.delay import engine as j_engine
from raider_tpu.geometry.aoi import BoundingBox as JBox
from raider_tpu.geometry.los import Raytracing as JRay
from raider_tpu.geometry.los import Zenith as JZen
from raider_tpu_torch.convert import dataset_from_reference, orbit_from_reference
from raider_tpu_torch.delay import engine as t_engine
from raider_tpu_torch.geodesy import Geographic
from raider_tpu_torch.geodesy.crs import CRS
from raider_tpu_torch.geometry import BoundingBox, Raytracing, Zenith

from tests.test_orbit import synthetic_orbit
from tests.test_raytrace import synthetic_wm_dataset

T0 = dt.datetime(2020, 1, 30, 13, 52, 45)
BBOX = [33.2, 33.8, -118.0, -117.4]
HEIGHTS = [0.0, 1500.0]
TOL = {np.float64: 1e-9, np.float32: 1e-5}
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(scope='module')
def wm_dataset():
    ys = np.arange(32.0, 35.01, 0.25)
    xs = np.arange(-120.0, -115.99, 0.25)
    zs = np.concatenate([np.arange(-500.0, 3000.0, 250.0), np.arange(3000.0, 10000.0, 500.0),
                         np.arange(10000.0, 30001.0, 1000.0)])
    zz, yy, xx = np.meshgrid(zs, ys, xs, indexing='ij')
    wet = 100.0 * np.exp(-zz / 2000.0) * (1 + 0.05 * (yy - 33.5) + 0.03 * (xx + 118))
    hydro = 270.0 * np.exp(-zz / 8000.0) * (1 + 0.02 * (yy - 33.5))
    ds = synthetic_wm_dataset(wet_cube=wet, hydro_cube=hydro)
    ds.variables['wet_total'].data = 0.2 * np.exp(-zz / 2000.0) * (1 + 0.03 * (xx + 118))
    ds.variables['hydro_total'].data = 2.3 * np.exp(-zz / 8000.0) * (1 + 0.02 * (yy - 33.5))
    return ds


@pytest.mark.parametrize('los', ['zenith', 'raytracing'])
@pytest.mark.parametrize('dtype', [np.float64, np.float32])
def test_tropo_delay_matches_jax(wm_dataset, los, dtype):
    orbit = synthetic_orbit(T0)
    j_los = JZen() if los == 'zenith' else JRay(orbit=orbit, time=T0)
    t_los = Zenith() if los == 'zenith' else Raytracing(orbit=orbit_from_reference(orbit), time=T0)
    ref, _ = j_engine.tropo_delay(T0, wm_dataset, JBox(BBOX, cube_spacing_in_m=5000.0), j_los,
                                  height_levels=HEIGHTS, compute_dtype=dtype)
    out, _ = t_engine.tropo_delay(T0, dataset_from_reference(wm_dataset),
                                  BoundingBox(BBOX, cube_spacing_in_m=5000.0), t_los,
                                  height_levels=HEIGHTS, compute_dtype=dtype, device='cpu')
    for k in ('x', 'y', 'z'):
        np.testing.assert_array_equal(out.coords[k].data, np.asarray(ref.coords[k].data))
    assert out.attrs['description'] == ref.attrs['description']
    for name in ('wet', 'hydro'):
        a, b = np.asarray(out[name].data), np.asarray(ref[name].data)
        assert a.shape == b.shape == (2, 13, 13)
        assert np.isfinite(a).all() and np.isfinite(b).all()
        assert np.max(np.abs(a - b)) <= TOL[dtype]
    assert np.mean(out['wet'].data) > (0.05 if los == 'raytracing' else 0.01)


@pytest.mark.parametrize('out_proj', [32611, 'EPSG:32611'])
@pytest.mark.parametrize('los', ['zenith', 'raytracing'])
@pytest.mark.parametrize('dtype', [np.float64, np.float32])
def test_tropo_delay_utm_out_proj_matches_jax(wm_dataset, out_proj, los, dtype):
    """A cube on UTM 11N axes (metres) from the geographic model: the axes
    within 1e-9 m (each package's transverse Mercator in float64), the
    cubes within the dtype's tolerance."""
    orbit = synthetic_orbit(T0)
    j_los = JZen() if los == 'zenith' else JRay(orbit=orbit, time=T0)
    t_los = Zenith() if los == 'zenith' else Raytracing(orbit=orbit_from_reference(orbit), time=T0)
    ref, _ = j_engine.tropo_delay(T0, wm_dataset, JBox(BBOX, cube_spacing_in_m=5000.0), j_los,
                                  height_levels=HEIGHTS, out_proj=out_proj, compute_dtype=dtype)
    out, _ = t_engine.tropo_delay(T0, dataset_from_reference(wm_dataset),
                                  BoundingBox(BBOX, cube_spacing_in_m=5000.0), t_los,
                                  height_levels=HEIGHTS, out_proj=out_proj, compute_dtype=dtype,
                                  device='cpu')
    np.testing.assert_array_equal(out.coords['z'].data, np.asarray(ref.coords['z'].data))
    for k in ('x', 'y'):
        a, b = np.asarray(out.coords[k].data), np.asarray(ref.coords[k].data)
        assert a.shape == b.shape and np.max(np.abs(a - b)) <= 1e-9
        assert out.coords[k].attrs['units'] == 'm'
    assert 100e3 < out.coords['x'].data.min() and out.coords['x'].data.max() < 900e3
    for name in ('wet', 'hydro'):
        a, b = np.asarray(out[name].data), np.asarray(ref[name].data)
        assert a.shape == b.shape and a.shape[1] * a.shape[2] > 100
        assert np.isfinite(a).all() and np.isfinite(b).all()
        assert np.max(np.abs(a - b)) <= TOL[dtype]


class _MetricPlateCarree(CRS):
    """A projected CRS for the test: longitude and latitude at 1e5 m a degree."""

    def forward(self, lon, lat):
        return lon * 1e5, lat * 1e5

    def inverse(self, x, y):
        return x / 1e5, y / 1e5

    def to_cf(self) -> dict:
        return {'grid_mapping_name': 'metric_plate_carree'}


def test_projected_model_output_spacing(wm_dataset):
    """With no grid on the AOI, a projected model's mean axis step (metres)
    becomes the output spacing at 1e5 m a degree, the JAX package's rule
    (raider_tpu/delay/engine.py, _get_delays_on_cube); the zenith cube then
    matches the same model on geographic axes at that spacing."""
    wm = t_engine.WeatherCube(dataset_from_reference(wm_dataset), 'cpu')
    wm.xs, wm.ys, wm.crs = wm.xs * 1e5, wm.ys * 1e5, _MetricPlateCarree()
    assert not wm.crs.is_geographic
    aoi = BoundingBox(BBOX)
    zref = wm.zs.max() - 1
    out = t_engine._get_delays_on_cube(T0, wm, None, aoi, HEIGHTS, Zenith(), Geographic(), zref,
                                       torch.float64)
    res = min(np.diff(wm.xs).mean(), np.diff(wm.ys).mean()) / 1e5
    assert aoi.get_output_spacing() == res
    assert abs(res - 0.25) < 1e-12

    ref_aoi = BoundingBox(BBOX)
    ref_aoi.set_output_spacing(ll_res=res)
    ref_aoi.set_output_xygrid(Geographic())
    ref = t_engine._get_delays_on_cube(T0, t_engine.WeatherCube(dataset_from_reference(wm_dataset),
                                                                'cpu'),
                                       None, ref_aoi, HEIGHTS, Zenith(), Geographic(), zref,
                                       torch.float64)
    for k in ('x', 'y'):
        np.testing.assert_array_equal(out.coords[k].data, ref.coords[k].data)
    for name in ('wet', 'hydro'):
        a, b = np.asarray(out[name].data), np.asarray(ref[name].data)
        assert a.shape == b.shape and a.shape[1] * a.shape[2] > 1
        assert np.isfinite(a).all() and np.max(np.abs(a - b)) <= 1e-9


@pytest.fixture(scope='module')
def hrrr_file(tmp_path_factory):
    """A processed HRRR-type file (Lambert conformal conic, 3 km), written
    by the JAX package from a raw file of tests/test_torch_readers.py."""
    from raider_tpu.wx.hrrr import HRRR

    from tests.test_torch_readers import _write_hrrr_raw

    tmp = tmp_path_factory.mktemp('hrrr')
    m = HRRR()
    m.setTime(T0)
    # 240 km a side: the synthetic orbit's rays (~75 deg from the zenith)
    # stay inside the model up to its top
    box = np.array([33.0, 34.6, -118.9, -116.6])
    m.set_latlon_bounds(box)
    m.set_wmLoc(str(tmp))
    _write_hrrr_raw(m.filename(outLoc=str(tmp)), n=81, nz=10, bbox=box)
    m.load()
    return m.write()


@pytest.mark.parametrize('los', ['zenith', 'raytracing'])
@pytest.mark.parametrize('dtype', [np.float64, np.float32])
def test_lcc_model_file_matches_jax(hrrr_file, los, dtype):
    """tropo_delay on a processed LCC file with no cube spacing on the AOI:
    the output spacing is the model's 3 km step at 1e5 m a degree (the C1
    rule) and the cubes match the JAX package's."""
    orbit = synthetic_orbit(T0)
    j_los = JZen() if los == 'zenith' else JRay(orbit=orbit, time=T0)
    t_los = Zenith() if los == 'zenith' else Raytracing(orbit=orbit_from_reference(orbit), time=T0)
    box = [33.6, 33.9, -117.4, -117.1]
    j_aoi, t_aoi = JBox(box), BoundingBox(box)
    # one raytraced height keeps the test short (test_tropo_delay_matches_jax
    # raytraces two)
    heights = HEIGHTS if los == 'zenith' else HEIGHTS[:1]
    ref, _ = j_engine.tropo_delay(T0, hrrr_file, j_aoi, j_los, height_levels=heights,
                                  compute_dtype=dtype)
    out, _ = t_engine.tropo_delay(T0, hrrr_file, t_aoi, t_los, height_levels=heights,
                                  compute_dtype=dtype, device='cpu')
    assert t_aoi.get_output_spacing() == j_aoi.get_output_spacing()
    assert abs(t_aoi.get_output_spacing() - 0.03) < 1e-6
    for k in ('x', 'y', 'z'):
        np.testing.assert_array_equal(out.coords[k].data, np.asarray(ref.coords[k].data))
    for name in ('wet', 'hydro'):
        a, b = np.asarray(out[name].data), np.asarray(ref[name].data)
        assert a.shape == b.shape and a.shape[1] * a.shape[2] >= 100
        assert np.isfinite(a).all() and np.isfinite(b).all()
        assert np.max(np.abs(a - b)) <= TOL[dtype]
    assert np.mean(out['hydro'].data[0]) > 1.5


_NO_JAX_SCRIPT = textwrap.dedent('''
    import sys
    sys.modules['jax'] = None          # any import of jax now raises
    sys.modules['h5py'] = None         # nor h5py: the card's machine has neither
    sys.modules['pandas'] = None       # nor pandas
    sys.modules['raider_tpu'] = None   # nor the JAX package
    sys.modules['yaml'] = None         # the run config is read without PyYAML
    sys.modules['matplotlib'] = None   # plots import matplotlib when they plot
    sys.modules['boto3'] = None        # the S3 helpers import boto3 when they connect
    sys.modules['requests'] = None     # the GNSS tools import requests when they download
    import datetime as dt
    import os
    import tempfile
    import numpy as np
    import raider_tpu_torch
    import raider_tpu_torch.convert
    from raider_tpu_torch.utils import bbox, geom2d, timeutils
    from raider_tpu_torch.wx import (base, calcgeoh, credentials, ecmwf, exceptions, gmao, hrrr,
                                     levels, merra2, ncmr, process, registry, template, wrf)
    from raider_tpu_torch.geodesy import LambertConformalConic, PolarStereographic, utm_crs
    from raider_tpu_torch.delay import tropo_delay
    from raider_tpu_torch.geodesy import Geographic
    from raider_tpu_torch.geometry import BoundingBox, Orbit, Raytracing, Zenith
    from raider_tpu_torch.io import Dataset, Variable

    ys, xs = np.linspace(32.0, 35.0, 7), np.linspace(-120.0, -116.0, 9)
    zs = np.linspace(-500.0, 30000.0, 25)
    shape = (zs.size, ys.size, xs.size)
    cube = np.broadcast_to(np.exp(-zs / 8000.0)[:, None, None], shape).copy()
    ds = Dataset(coords={'x': Variable(('x',), xs), 'y': Variable(('y',), ys),
                         'z': Variable(('z',), zs)},
                 variables={n: Variable(('z', 'y', 'x'), cube) for n in
                            ('wet', 'hydro', 'wet_total', 'hydro_total')})
    ds.variables['proj'] = Variable((), np.int64(0), Geographic().to_cf())
    t0 = dt.datetime(2020, 1, 30, 13, 52, 45)
    tt = np.arange(-600.0, 601.0, 10.0)
    w = np.sqrt(3.986004418e14 / 7.071e6**3)
    th, inc, lon0 = 0.55 + w * tt, np.deg2rad(98.0), np.deg2rad(-130.0)
    x, y, z = np.cos(th), np.sin(th) * np.cos(inc), np.sin(th) * np.sin(inc)
    pos = 7.071e6 * np.stack([np.cos(lon0) * x - np.sin(lon0) * y,
                              np.sin(lon0) * x + np.cos(lon0) * y, z], -1)
    orbit = Orbit(times=tt, pos=pos, vel=np.gradient(pos, 10.0, axis=0), ref_time=t0)
    for los in (Zenith(), Raytracing(orbit=orbit, time=t0)):
        out, _ = tropo_delay(t0, ds, BoundingBox([33.2, 33.8, -118.0, -117.4],
                                                 cube_spacing_in_m=20000.0),
                             los, height_levels=[0.0], device='cpu')
        assert np.isfinite(out['wet'].data).all(), los
    # point requests: a station CSV (zenith) and radar rasters raytraced
    # from an EOF orbit file, every input written by the port
    from raider_tpu_torch.geometry import RasterRDR, StationFile
    from raider_tpu_torch.io import write_envi
    from raider_tpu_torch.scripts import point_inputs
    with tempfile.TemporaryDirectory() as tmp:
        rng = np.random.default_rng(0)
        csv_file = point_inputs.write_station_csv(
            os.path.join(tmp, 'st.csv'), rng.uniform(33.3, 33.7, 9), rng.uniform(-117.9, -117.5, 9),
            rng.uniform(0.0, 900.0, 9), n_duplicates=2)
        wet, hydro = tropo_delay(t0, ds, StationFile(csv_file, cube_spacing_in_m=20000.0), Zenith(),
                                 device='cpu')
        assert wet.shape == (9,) and np.isfinite(hydro).all()
        lat, lon = point_inputs.radar_grid((33.5, -117.7), (6, 5), (0.3, 0.2))
        for name, a in (('lat', lat), ('lon', lon), ('hgt', np.full(lat.shape, 100.0))):
            write_envi(a, os.path.join(tmp, name + '.rdr'), nodata=-9999.0)
        aoi = RasterRDR(*(os.path.join(tmp, n + '.rdr') for n in ('lat', 'lon', 'hgt')),
                        cube_spacing_in_m=20000.0)
        eof = point_inputs.write_eof(tmp, orbit)
        wet, hydro = tropo_delay(t0, ds, aoi, Raytracing(filename=eof, time=t0),
                                 height_levels=[0.0, 500.0], device='cpu')
        assert wet.shape == (6, 5) and np.isfinite(wet).all()
    from raider_tpu_torch.delay.pallas_window import integrate_rays_windowed
    from raider_tpu_torch.scripts import probe_f16, window_ablation
    rec = window_ablation.run(window_ablation.build_scene(64, grid=(20, 60, 60), device='cpu'),
                              say=lambda s: None)
    assert rec['max_rel'] < 1e-5, rec
    assert all(r['max_abs_err'] == 0.0 for r in probe_f16.run('cpu', n=64, say=lambda s: None))
    import torch
    from raider_tpu_torch.delay.raytrace import integrate_rays, pack_cubes
    from raider_tpu_torch.scripts import kernel_profile
    recs = kernel_profile.run('cpu', (7, 3, 3, 6), ('prod', 'pallas', 'pallas2', 'prodmerged',
                                                    'prodi16'), n_rays=64, grid=(10, 30, 30),
                              say=lambda s: None)
    assert sum(bool(r.get('equiv_ok')) for r in recs) == 4, recs
    assert len(kernel_profile.run('cpu', 'split', n_rays=64, grid=(10, 30, 30),
                                  say=lambda s: None)) == 3
    sc = kernel_profile.build_scene('cpu', n_rays=64, grid=(10, 30, 30))
    for mode in ('pack16', 'pack16_i16', 'pack4', 'brick_i16'):
        table, _ = pack_cubes(sc['wet_d'], sc['hydro_d'], mode=mode)
        w, h = integrate_rays(sc['wet_d'], sc['hydro_d'], sc['ys'], sc['xs'], sc['zs'],
                              *sc['rays'], sc['per_level_max'], packed2d=table, mode=mode,
                              heights=sc['heights'], hstep_max=sc['hstep_max'])
        assert torch.isfinite(w).float().mean() > 0.9, mode
    # a raw HRRR file (netCDF-3) through get_wm_by_name -> load -> to_dataset
    # -> tropo_delay on its Lambert conformal grid
    from raider_tpu_torch.scripts import raw_weather
    from raider_tpu_torch.wx.base import make_raw_weather_data_filename
    with tempfile.TemporaryDirectory() as tmp:
        m = registry.get_wm_by_name('HRRR')[1]()
        m.setTime(t0)
        m.set_wmLoc(tmp)
        raw_weather.write_hrrr(make_raw_weather_data_filename(tmp, 'HRRR', m.getTime()), nz=8,
                               grid=('lcc', 40, 40, 3000.0, 37.2, -99.2), device='cpu')
        assert m.load(device='cpu') is None
        out, _ = tropo_delay(t0, m.to_dataset(), BoundingBox([37.4, 37.9, -98.9, -98.4],
                                                             cube_spacing_in_m=10000.0),
                             Zenith(), height_levels=[0.0], device='cpu')
        assert np.isfinite(out['hydro'].data).all() and 1.5 < float(out['hydro'].data.mean()) < 3
    # the calc-delays workflow through the CLI on a bbox config, netCDF-3
    import raider_tpu_torch.cli.__main__
    import raider_tpu_torch.types
    import raider_tpu_torch.utils.misc
    import raider_tpu_torch.wx.plots
    from raider_tpu_torch.io import read_nc
    from raider_tpu_torch.workflows import s1_timing, yaml_subset
    with tempfile.TemporaryDirectory() as tmp:
        wm = os.path.join(tmp, 'wm')
        os.makedirs(wm)
        raw_weather.write_ecmwf(make_raw_weather_data_filename(wm, 'ERA-5', t0), 'ERA5',
                                box=(31.0, 36.0, -120.5, -115.0), device='cpu')
        cfg = os.path.join(tmp, 'cfg.yaml')
        with open(cfg, 'w') as f:
            yaml_subset.dump({'weather_model': 'ERA5', 'date_group': {'date_start': 20200130},
                              'time_group': {'time': '13:52:45'},
                              'aoi_group': {'bounding_box': '33.2 33.8 -118.0 -117.4'},
                              'height_group': {'height_levels': [0, 1000]},
                              'runtime_group': {'output_directory': tmp,
                                                'weather_model_directory': wm,
                                                'verbose': False, 'cube_spacing_in_m': 20000}},
                             f)
        out = raider_tpu_torch.cli.__main__.main(
            [cfg, '--nc_format', 'NETCDF3_64BIT_OFFSET'], device='cpu')
        cube = read_nc(out[0])
        assert np.isfinite(cube['hydro'].data).all() and cube['hydro'].data.shape[0] == 2
        assert cube.attrs['model_times_used'] == ['20200130T13:52:45']
    # the GUNW compute path, the GNSS tools, GACOS and the stage timers
    from raider_tpu_torch.utils import profiling, table
    from raider_tpu_torch.workflows import aws, gacos, gnss, gnss_combine, gunw
    from raider_tpu_torch.scripts import gnss_inputs
    with tempfile.TemporaryDirectory() as tmp:
        z = os.path.join(tmp, 'S00000.2020.trop.zip')
        gnss_inputs.write_trop_zip(z, 'S00000', 2020, (30,), n_gaps=2)
        gnss.get_delays_UNR(z, os.path.join(tmp, 'S00000_ztd.csv'), ['2020-01-30'], 43200)
        got = table.read_csv(os.path.join(tmp, 'S00000_ztd.csv'))
        assert list(got['times']) == [43200] and np.isfinite(got['ZTD']).all()
    assert 'delay.raytrace_cube' in profiling.stage_report()
    # raiderStats (its figures raise without matplotlib, after every other
    # product), the coastlines, ray sharding and z-slab tables
    from raider_tpu_torch.parallel import get_mesh, zshard
    from raider_tpu_torch.scripts import stats_inputs
    from raider_tpu_torch.workflows import coastlines, stats
    with tempfile.TemporaryDirectory() as tmp:
        csv = os.path.join(tmp, 'c.csv')
        stats_inputs.write_combined_csv(csv, n_stations=12, n_days=40, n_short=0, seed=1)
        try:
            stats.stats_analyses(['-f', csv, '-w', tmp, '-grid_delay_absolute_median',
                                  '-grid_to_raster', '-variogramplot'], device='cpu')
            raise AssertionError('a figure was drawn without matplotlib')
        except ImportError as exc:
            assert 'matplotlib' in str(exc)
        assert all(os.path.exists(os.path.join(tmp, f)) for f in (
            'grid_absolute_median.tif', 'variogram_sill.npy', 'variogram_range.npy'))
    assert len(coastlines.COASTLINES) >= 15
    for zs_mode in (False, True):
        out, _ = tropo_delay(t0, ds, BoundingBox([33.2, 33.8, -118.0, -117.4],
                                                 cube_spacing_in_m=8000.0),
                             Raytracing(orbit=orbit, time=t0), height_levels=[0.0],
                             device='cpu', mesh=get_mesh(devices=('cpu',) * 4),
                             zshard=zs_mode)
        assert np.isfinite(out['wet'].data).all()
    assert zshard.zshard_auto((137, 1801, 3600), np.float32, 'pack4', 8)
    assert not any(m in ('jax', 'pandas', 'h5py', 'yaml', 'matplotlib', 'boto3', 'requests')
                   or m.startswith(('jax.', 'raider_tpu.', 'yaml.', 'matplotlib.', 'boto3.',
                                    'requests.'))
                   for m in sys.modules if sys.modules[m] is not None)
    print('NO_JAX_OK')
''')


def test_port_runs_with_jax_blocked():
    res = subprocess.run([sys.executable, '-c', _NO_JAX_SCRIPT], cwd=REPO, capture_output=True,
                         text=True, timeout=300)
    assert res.returncode == 0, res.stderr[-3000:]
    assert 'NO_JAX_OK' in res.stdout


def test_entry_points_default_to_the_card():
    from raider_tpu_torch.delay.pallas_window import integrate_rays_windowed
    from raider_tpu_torch.scripts import kernel_profile, raw_weather
    from raider_tpu_torch.wx.base import WeatherModel
    from raider_tpu_torch.wx.process import prepareWeatherModel

    from raider_tpu_torch.workflows import stats

    for fn in (t_engine.tropo_delay, WeatherModel.load, integrate_rays_windowed,
               stats.RaiderStats.__init__, stats.stats_analyses, stats.load_gridfile,
               kernel_profile.run, kernel_profile.build_scene, prepareWeatherModel,
               raw_weather.write, raw_weather.write_hrrr, raw_weather.write_ecmwf,
               raw_weather.write_hqpt, raw_weather.write_wrfout):
        assert inspect.signature(fn).parameters['device'].default == 'cuda', fn


def test_default_device_without_cuda_raises(wm_dataset):
    """No fallback: without CUDA, a call that names no device raises."""
    from raider_tpu_torch.wx.base import WeatherModel

    if torch.cuda.is_available():
        pytest.skip('checks the machine without CUDA')
    with pytest.raises(RuntimeError, match='CUDA'):
        t_engine.tropo_delay(T0, dataset_from_reference(wm_dataset),
                             BoundingBox(BBOX, cube_spacing_in_m=5000.0), Zenith(),
                             height_levels=HEIGHTS)
    with pytest.raises(RuntimeError, match='CUDA'):
        WeatherModel().load()


def test_no_module_imports_pandas_or_h5py_at_module_level():
    """pandas and h5py, absent from the card's machine, are imported inside
    functions only; so are boto3 and requests (the S3 and download
    helpers)."""
    import re

    pat = re.compile(r'^(import|from) (pandas|h5py|boto3|requests)\b')
    for dirpath, _, files in os.walk(os.path.join(REPO, 'raider_tpu_torch')):
        for f in files:
            if f.endswith('.py'):
                with open(os.path.join(dirpath, f)) as fh:
                    bad = [line for line in fh if pat.match(line)]
                assert not bad, (f, bad)
    with open(os.path.join(REPO, 'chip_smoke.py')) as fh:
        assert not [line for line in fh if re.match(r'^\s*(import|from) (pandas|h5py|jax)\b', line)]


def test_no_module_imports_jax():
    """No line of the port imports jax or the JAX package."""
    import re

    pat = re.compile(r'^\s*(import|from) (jax|raider_tpu)\b')
    root = os.path.join(REPO, 'raider_tpu_torch')
    for dirpath, _, files in os.walk(root):
        for f in files:
            if f.endswith('.py'):
                with open(os.path.join(dirpath, f)) as fh:
                    bad = [line for line in fh if pat.match(line)]
                assert not bad, (f, bad)


def test_no_module_imports_yaml_or_matplotlib_at_module_level():
    """PyYAML (the run config has its own reader) and matplotlib (imported
    inside the plot functions) stay off the port's module level."""
    import re

    pat = re.compile(r'^(import|from) (yaml|matplotlib)\b')
    for dirpath, _, files in os.walk(os.path.join(REPO, 'raider_tpu_torch')):
        for f in files:
            if f.endswith('.py'):
                with open(os.path.join(dirpath, f)) as fh:
                    bad = [line for line in fh if pat.match(line)]
                assert not bad, (f, bad)
