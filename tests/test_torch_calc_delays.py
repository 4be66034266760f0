"""The calc-delays workflow: raider_tpu_torch's calcDelays and CLI vs raider_tpu's (CPU).

Every case writes a run config and runs it through both packages'
``calcDelays`` from synthetic raw weather files (``scripts/raw_weather.py``,
device='cpu'; ERA5 over Los Angeles; for the azimuth-time case HRRR raw
files as the JAX package's fetcher writes them, from
tests/test_torch_readers.py) staged under each run's ``weather_model_directory``,
with the station CSV, radar rasters and EOF orbit file of
``scripts/point_inputs.py``. The port runs with ``device='cpu'`` and
``--nc_format NETCDF3_64BIT_OFFSET``.

Two runs of the port per case (the raytraced cases run only the second:
the fresh processing is the same for every case, and raytracing on the
CPU is slow):
  * fresh, from the raw files: its processed models hold the JAX package's
    to the tolerances of tests/test_torch_wx.py (rtol 1e-6; the ZTD totals
    rtol 1e-5, atol 1e-9 m), and so the delays (rtol 1e-6, atol 1e-9 m);
  * on the JAX package's own processed files (copied into its weather
    directory, so the cache is hit): the delays hold the JAX package's to
    float64 within 1e-9 m, as in tests/test_torch_slice.py. On the CPU both
    packages compute in float64 (the float32 tolerance, 1e-5 m, is for the
    card). Rasters are written as float32 by both: within one float32 ulp.

A netCDF-3 cube reads back equal to the port's NETCDF4 one, variable for
variable and attribute for attribute; a one-element string list (the
``model_times_used`` of one epoch) reads back as a list from netCDF-3 and
as its one string from netCDF4 (that reader squeezes size-1 attributes).
"""

import csv
import datetime as dt
import glob
import os
import re
import shutil
import sys

import h5py
import numpy as np
import pytest
import yaml

from raider_tpu.io import read_nc as j_read_nc
from raider_tpu.workflows import calc_delays as j_cd
from raider_tpu.workflows import s1_timing as j_s1
from raider_tpu_torch.cli.__main__ import main as t_main
from raider_tpu_torch.io import read_envi, write_envi
from raider_tpu_torch.io import read_nc as t_read_nc
from raider_tpu_torch.scripts import point_inputs, raw_weather
from raider_tpu_torch.workflows import calc_delays as t_cd
from raider_tpu_torch.workflows import s1_timing as t_s1
from raider_tpu_torch.wx.base import make_raw_weather_data_filename
from raider_tpu_torch.wx.exceptions import NoWeatherModelData

from tests.test_orbit import synthetic_orbit
from tests.test_torch_readers import _write_hrrr_raw

T0 = dt.datetime(2020, 1, 30, 13, 52, 45)
BBOX = [33.2, 33.8, -118.0, -117.4]
ERA5_BOX = (31.0, 36.0, -120.5, -115.0)
HRRR_BBOX = np.array([33.0, 34.0, -118.2, -117.2])
HEIGHTS = [0.0, 500.0, 1500.0]
RAY_HEIGHTS = [0.0, 1500.0]
SPACING_M = 10000.0
F64_TOL = 1e-9
NC3 = ['--nc_format', 'NETCDF3_64BIT_OFFSET']


@pytest.fixture(scope='module')
def inputs(tmp_path_factory):
    """Raw weather files by (model, epoch), and the point inputs."""
    d = tmp_path_factory.mktemp('calc_inputs')
    raw = {}
    for i, t in enumerate((T0, T0.replace(minute=0, second=0),
                           T0.replace(minute=0, second=0) + dt.timedelta(hours=1))):
        raw[('ERA-5', t)] = raw_weather.write_ecmwf(
            make_raw_weather_data_filename(str(d), 'ERA-5', t), 'ERA5', box=ERA5_BOX, seed=i,
            device='cpu')
        # HRRR's raw file as the JAX package's fetcher writes it (netCDF4; that
        # package's reader takes no 0-d variable of a netCDF-3 file), its
        # humidity scaled so that each epoch differs
        path = make_raw_weather_data_filename(str(d), 'HRRR', t)
        _write_hrrr_raw(path, n=81, nz=10, bbox=HRRR_BBOX)
        with h5py.File(path, 'r+') as f:
            f['q'][...] = f['q'][...] * (1.0 + 0.1 * i)
        raw[('HRRR', t)] = path
    rng = np.random.default_rng(12)
    f = {'raw': raw, 'eof': point_inputs.write_eof(d, synthetic_orbit(T0))}
    f['stations'] = point_inputs.write_station_csv(
        d / 'stations.csv', rng.uniform(33.3, 33.7, 12), rng.uniform(-117.9, -117.5, 12),
        rng.uniform(0.0, 1400.0, 12), n_duplicates=2)
    rlat, rlon = point_inputs.radar_grid((33.5, -117.7), (8, 6), (0.3, 0.25))
    hgt = point_inputs.terrain((8, 6), 0.0, 1200.0, seed=3)
    hgt[2, 3] = -9999.0
    for name, arr in (('lat', rlat), ('lon', rlon), ('hgt', hgt)):
        f[name] = str(d / f'{name}.rdr')
        write_envi(arr, f[name], nodata=-9999.0)
    return f


def _config(path, model, groups, out, wm):
    cfg = {'look_dir': 'right', 'weather_model': model, 'height_group': {}, 'los_group': {},
           'date_group': {'date_start': int(T0.strftime('%Y%m%d'))},
           'time_group': {'time': T0.strftime('%H:%M:%S'), 'interpolate_time': 'none'},
           'runtime_group': {'output_directory': str(out), 'weather_model_directory': str(wm),
                             'verbose': False, 'cube_spacing_in_m': SPACING_M}}
    for k, v in groups.items():
        cfg[k] = {**cfg.get(k, {}), **v} if isinstance(v, dict) else v
    path.write_text(yaml.dump(cfg))
    return str(path)


def _is_raw(name: str) -> bool:
    """A raw file's name (``make_raw_weather_data_filename``), not a
    processed model's (which ends in its bounds)."""
    return re.fullmatch(r'[^_]+_\d{4}_\d\d_\d\d_T\d\d_\d\d_\d\d\.nc', name) is not None


def run_case(tmp, model, groups, epochs, inputs, argv=(), fresh=True):
    """The JAX package's calcDelays, then the port's fresh from the raw
    files (with ``fresh``) and on the JAX package's processed files.
    Returns (outputs, run directory) by run."""
    runs = {}
    for tag in ('jax', 'fresh', 'same') if fresh else ('jax', 'same'):
        out = tmp / tag
        wm = out / 'wm'
        os.makedirs(wm)
        if tag != 'same':
            for t in epochs:
                shutil.copy(inputs['raw'][(model if model != 'ERA5' else 'ERA-5', t)], wm)
        else:
            for f in os.listdir(tmp / 'jax' / 'wm'):
                if not _is_raw(f) and 'timeInterp' not in f:
                    shutil.copy(tmp / 'jax' / 'wm' / f, wm)
        cfg = _config(tmp / f'{tag}.yaml', model, groups, out, wm)
        if tag == 'jax':
            paths = j_cd.calcDelays([cfg, *argv])
        else:
            paths = t_main([cfg, *NC3, *argv], device='cpu')
        runs[tag] = ([str(p) for p in paths], out)
    return runs


def _names(paths):
    return [os.path.basename(p) for p in paths]


def _processed_close(jax_dir, port_dir):
    """The port's fresh processed models vs the JAX package's (the
    tolerances of tests/test_torch_wx.py)."""
    files = sorted(f for f in os.listdir(jax_dir) if not _is_raw(f) and 'timeInterp' not in f)
    assert files and files == sorted(f for f in os.listdir(port_dir)
                                     if not _is_raw(f) and 'timeInterp' not in f)
    for f in files:
        a, b = t_read_nc(port_dir / f), j_read_nc(jax_dir / f)
        for name in ('t', 'p', 'e', 'wet', 'hydro'):
            np.testing.assert_allclose(a[name].data, b[name].data, rtol=1e-6)
        for name in ('wet_total', 'hydro_total'):
            np.testing.assert_allclose(a[name].data, b[name].data, rtol=1e-5, atol=1e-9)


def _squeeze(v):
    """An attribute as the NETCDF4 reader returns it: a string array as a
    list, a one-element list as its element."""
    if isinstance(v, np.ndarray) and v.dtype.kind in 'OSU':
        v = [str(x) for x in v.ravel()]
    return v[0] if isinstance(v, list) and len(v) == 1 else v


def _cubes_close(got_path, want_path, rtol=0.0, atol=F64_TOL):
    got, want = t_read_nc(got_path), j_read_nc(want_path)
    for name in ('x', 'y', 'z'):
        np.testing.assert_array_equal(got.coords[name].data, want.coords[name].data)
    for name in ('wet', 'hydro'):
        g, w = np.asarray(got[name].data), np.asarray(want[name].data)
        assert g.shape == w.shape and np.array_equal(np.isnan(g), np.isnan(w))
        np.testing.assert_allclose(g, w, rtol=rtol, atol=atol)
    skip = {'history'}
    assert ({k: _squeeze(v) for k, v in got.attrs.items() if k not in skip}
            == {k: _squeeze(v) for k, v in want.attrs.items() if k not in skip})
    assert got['crs'].attrs == want['crs'].attrs


def _station_rows(path):
    with open(path, newline='') as f:
        rows = list(csv.reader(f))
    return rows[0], rows[1:]


def _stations_close(got_path, want_path, rtol=0.0, atol=F64_TOL):
    hg, rg = _station_rows(got_path)
    hw, rw = _station_rows(want_path)
    assert hg == hw and len(rg) == len(rw)
    delay_cols = [hg.index(k) for k in ('wetDelay', 'hydroDelay', 'totalDelay')]
    for a, b in zip(rg, rw):
        for i, (x, y) in enumerate(zip(a, b)):
            if i in delay_cols:
                np.testing.assert_allclose(float(x), float(y), rtol=rtol, atol=atol)
            elif x != y:   # the station columns, pandas' parse to 1 ulp
                np.testing.assert_array_max_ulp(np.float64(x), np.float64(y), maxulp=1)


def _rasters_close(got, want, rtol=0.0, atol=0.0, maxulp=1):
    g, w = read_envi(got)[0], read_envi(want)[0]
    assert g.shape == w.shape and g.dtype == w.dtype == np.float32
    if rtol:
        np.testing.assert_allclose(g, w, rtol=rtol, atol=atol)
    else:
        np.testing.assert_array_max_ulp(g, w, maxulp=maxulp)


@pytest.mark.parametrize('los', ['zenith', 'raytraced'])
def test_bbox_cube(tmp_path, inputs, los):
    ray = los == 'raytraced'
    groups = {'aoi_group': {'bounding_box': ' '.join(map(str, BBOX))},
              'height_group': {'height_levels': RAY_HEIGHTS if ray else HEIGHTS}}
    if ray:
        groups['los_group'] = {'ray_trace': True, 'orbit_file': inputs['eof']}
    runs = run_case(tmp_path, 'ERA5', groups, [T0], inputs, fresh=not ray)
    (pj, _), (pb, _) = runs['jax'], runs['same']
    suffix = 'ray' if ray else 'ztd'
    assert _names(pj) == _names(pb) == [f'ERA5_tropo_20200130T135245_{suffix}.nc']
    with open(pb[0], 'rb') as f:
        assert f.read(4) == b'CDF\x02'
    _cubes_close(pb[0], pj[0])
    if not ray:
        (pa, da) = runs['fresh']
        assert _names(pa) == _names(pj)
        _processed_close(tmp_path / 'jax' / 'wm', da / 'wm')
        _cubes_close(pa[0], pj[0], rtol=1e-6)


def test_netcdf3_cube_reads_back_as_the_netcdf4_one(tmp_path, inputs):
    groups = {'aoi_group': {'bounding_box': ' '.join(map(str, BBOX))},
              'height_group': {'height_levels': HEIGHTS}}
    outs = {}
    for fmt in ('NETCDF4', 'NETCDF3_64BIT_OFFSET'):
        out = tmp_path / fmt
        os.makedirs(out / 'wm')
        shutil.copy(inputs['raw'][('ERA-5', T0)], out / 'wm')
        cfg = _config(tmp_path / f'{fmt}.yaml', 'ERA5', groups, out, out / 'wm')
        outs[fmt] = t_main([cfg, '--nc_format', fmt], device='cpu')
        with open(outs[fmt][0], 'rb') as f:
            assert (f.read(4) in (b'CDF\x01', b'CDF\x02')) == (fmt != 'NETCDF4')
    for kind in ('model', 'cube'):
        if kind == 'model':
            a, b = (t_read_nc(glob.glob(str(tmp_path / fmt / 'wm' / 'ERA-5_*_*_*_*_*.nc'))[0])
                    for fmt in ('NETCDF4', 'NETCDF3_64BIT_OFFSET'))
            skip = {'date_created'}
        else:
            a, b = (t_read_nc(outs[fmt][0]) for fmt in ('NETCDF4', 'NETCDF3_64BIT_OFFSET'))
            skip = {'history'}
        assert set(a.coords) == set(b.coords) and set(a.variables) == set(b.variables)
        for name in list(a.coords) + list(a.variables):
            x, y = np.asarray(a[name].data), np.asarray(b[name].data)
            assert x.dtype == y.dtype and tuple(a[name].dims) == tuple(b[name].dims), name
            np.testing.assert_array_equal(x, y)
            assert {k: _squeeze(v) for k, v in b[name].attrs.items()} == a[name].attrs, name
        assert ({k: _squeeze(v) for k, v in b.attrs.items() if k not in skip}
                == {k: v for k, v in a.attrs.items() if k not in skip})


def test_stations(tmp_path, inputs):
    groups = {'aoi_group': {'station_file': str(inputs['stations'])}}
    runs = run_case(tmp_path, 'ERA5', groups, [T0], inputs)
    (pj, _), (pa, _), (pb, _) = runs['jax'], runs['fresh'], runs['same']
    assert _names(pj) == _names(pa) == _names(pb) == ['ERA5_Delay_20200130T135245_ztd.csv']
    _stations_close(pb[0], pj[0])
    _stations_close(pa[0], pj[0], rtol=1e-6)


def test_radar_rasters_raytraced_from_an_eof(tmp_path, inputs):
    groups = {'aoi_group': {'lat_file': inputs['lat'], 'lon_file': inputs['lon']},
              'height_group': {'height_file_rdr': inputs['hgt'], 'height_levels': RAY_HEIGHTS},
              'los_group': {'ray_trace': True, 'orbit_file': inputs['eof']}}
    runs = run_case(tmp_path, 'ERA5', groups, [T0], inputs, fresh=False)
    (pj, dj), (pb, db) = runs['jax'], runs['same']
    assert _names(pj) == _names(pb) == ['ERA5_wet_20200130T135245_ray.dat']
    for kind in ('wet', 'hydro'):
        name = f'ERA5_{kind}_20200130T135245_ray.dat'
        _rasters_close(db / name, dj / name)


def test_center_time(tmp_path, inputs):
    epochs = [T0.replace(minute=0, second=0), T0.replace(minute=0, second=0)
              + dt.timedelta(hours=1)]
    groups = {'aoi_group': {'bounding_box': ' '.join(map(str, BBOX))},
              'height_group': {'height_levels': HEIGHTS},
              'time_group': {'interpolate_time': 'center_time'}}
    runs = run_case(tmp_path, 'ERA5', groups, epochs, inputs)
    (pj, dj), (pa, da), (pb, db) = runs['jax'], runs['fresh'], runs['same']
    combined = 'ERA-5_2020_01_30T13_52_45_timeInterp_32N_35N_120W_116W.nc'
    for d in (dj, da, db):
        assert os.path.exists(d / 'wm' / combined), d
    _cubes_close(pb[0], pj[0])
    _cubes_close(pa[0], pj[0], rtol=1e-6)
    got = t_read_nc(pb[0])
    assert got.attrs['model_times_used'] == [e.strftime('%Y%m%dT%H:%M:%S') for e in epochs]
    assert got.attrs['interpolation_method'] == 'center_time'


def test_azimuth_time_grid(tmp_path, inputs, monkeypatch):
    """HRRR, the radar rasters (zenith: the LOS does not enter the time
    grid), ``azimuth_time_grid``: the two network look-ups of s1_timing
    return the local EOF in both packages."""
    for mod in (j_s1, t_s1):
        monkeypatch.setattr(mod, 'get_slc_ids_from_time', lambda lon, lat, time: ['S1A_x'])
        monkeypatch.setattr(mod, 'get_orbits_from_slc_ids_hyp3lib',
                            lambda ids, orbit_directory=None: [inputs['eof']])
    epochs = t_s1.get_times_for_azimuth_interpolation(T0, 1)
    assert epochs == j_s1.get_times_for_azimuth_interpolation(T0, 1)
    groups = {'aoi_group': {'lat_file': inputs['lat'], 'lon_file': inputs['lon']},
              'height_group': {'height_file_rdr': inputs['hgt'], 'height_levels': HEIGHTS},
              'time_group': {'interpolate_time': 'azimuth_time_grid'}}
    runs = run_case(tmp_path, 'HRRR', groups, epochs, inputs)
    (pj, dj), (pa, da), (pb, db) = runs['jax'], runs['fresh'], runs['same']
    assert _names(pj) == _names(pa) == _names(pb) == ['HRRR_wet_20200130T135245_ztd.dat']
    for d in (dj, da, db):
        assert glob.glob(str(d / 'wm' / '*_timeInterpAziGrid_*')), d
    for kind in ('wet', 'hydro'):
        name = f'HRRR_{kind}_20200130T135245_ztd.dat'
        _rasters_close(db / name, dj / name)
        _rasters_close(da / name, dj / name, rtol=1e-6, atol=1e-9)


def test_download_only(tmp_path, inputs):
    """``--download_only``: the models are prepared, no delay is written."""
    groups = {'aoi_group': {'bounding_box': ' '.join(map(str, BBOX))}}
    runs = run_case(tmp_path, 'ERA5', groups, [T0], inputs, argv=('--download_only',))
    for tag in ('jax', 'fresh'):
        paths, d = runs[tag]
        assert paths == []
        assert not [f for f in os.listdir(d) if f.endswith(('.nc', '.csv', '.dat'))]
    assert sorted(os.listdir(runs['fresh'][1] / 'wm')) == sorted(os.listdir(runs['jax'][1] / 'wm'))


@pytest.mark.parametrize('example', ['template', 'example_LA_bbox', 'example_LA_GNSS',
                                     'example_UK_isce'])
def test_generate_config(tmp_path, monkeypatch, example):
    written = {}
    for tag, fn in (('jax', j_cd.calcDelays), ('port', t_cd.calcDelays)):
        os.makedirs(tmp_path / tag)
        monkeypatch.chdir(tmp_path / tag)
        with pytest.raises(SystemExit):
            fn(['--generate_config', example])
        written[tag] = {f: (tmp_path / tag / f).read_bytes() for f in os.listdir(tmp_path / tag)}
    assert written['port'] == written['jax'] and written['port']


def test_no_h5py_error_names_the_option(tmp_path, inputs, monkeypatch, caplog):
    """NETCDF4 without h5py: write_nc raises an ImportError naming the
    netCDF-3 option, and nothing switches format by itself."""
    from raider_tpu_torch.io import Dataset, Variable, write_nc

    monkeypatch.setitem(sys.modules, 'h5py', None)
    ds = Dataset(coords={'x': Variable(('x',), np.arange(3.0))})
    with pytest.raises(ImportError, match='NETCDF3_64BIT_OFFSET'):
        write_nc(ds, tmp_path / 'a.nc')
    assert not (tmp_path / 'a.nc').exists()
    out = tmp_path / 'run'
    os.makedirs(out / 'wm')
    shutil.copy(inputs['raw'][('ERA-5', T0)], out / 'wm')
    cfg = _config(tmp_path / 'cfg.yaml', 'ERA5',
                  {'aoi_group': {'bounding_box': ' '.join(map(str, BBOX))}}, out, out / 'wm')
    with pytest.raises(NoWeatherModelData):
        t_main([cfg], device='cpu')
    assert 'NETCDF3_64BIT_OFFSET' in caplog.text
    assert not [f for f in os.listdir(out / 'wm') if not _is_raw(f)]


def test_cli_dispatch_and_default_device(tmp_path, monkeypatch):
    """``++process downloadGNSS`` and ``calcDelaysGUNW`` reach the port's
    entry points with the remaining arguments (and the device)."""
    import inspect

    from raider_tpu_torch.workflows import gnss as t_gnss
    from raider_tpu_torch.workflows import gunw as t_gunw

    entry_gunw = t_gunw.calcDelaysGUNW
    calls = []
    monkeypatch.setattr(t_gnss, 'downloadGNSS', lambda argv: calls.append(('gnss', argv)))
    monkeypatch.setattr(t_gunw, 'calcDelaysGUNW',
                        lambda argv, device='cuda': calls.append(('gunw', argv, device)) or 'ok')
    t_main(['++process', 'downloadGNSS', '--date', '20200130'])
    assert t_main(['++process', 'calcDelaysGUNW', '--file', 'x.nc'], device='cpu') == 'ok'
    assert calls == [('gnss', ['--date', '20200130']), ('gunw', ['--file', 'x.nc'], 'cpu')]
    for fn in (t_main, t_cd.calcDelays, t_cd.getWeatherFile, t_cd.combine_weather_files,
               t_cd.get_time_grid_for_aztime_interp, t_s1.get_azimuth_time_grid,
               t_s1.get_s1_azimuth_time_grid, entry_gunw, t_gunw.run_gunw):
        assert inspect.signature(fn).parameters['device'].default == 'cuda', fn
