"""The GUNW workflow: raider_tpu_torch.workflows.gunw vs raider_tpu's (CPU).

Both packages run on copies of the same synthetic GUNW product
(tests/test_gunw_gnss.py's builder; its bounding box cut to 0.6 x 0.6 deg
and the heights to two so that raytracing stays short on the CPU) and the
same raw ERA5 files (``scripts/raw_weather.py``, device='cpu', one per
epoch at the product's mid time, ``-interp none``). The orbit look-up
(``s1_timing.get_orbits_from_slc_ids_hyp3lib``) returns a text orbit with
statevectors around both epochs, and the credentials check is a no-op, in
both packages. The port runs with ``device='cpu'`` and writes its cubes as
netCDF-3.

Compared: the metadata and run config, the availability checks, the
whole ``calcDelaysGUNW --file``: the written troposphere groups dataset by
dataset and attribute by attribute. The phases hold the JAX package's to
1e-9 m x 4 pi / lambda in float64 when the port runs on the JAX package's
processed files, and to the processing tolerances of tests/test_torch_wx.py
(rtol 1e-6) from the raw files; written as float32, they are within one
float32 ulp in the first case. The only attribute expected to differ is
``raider_tpu_version`` (each package's own version). Then the S3 flow with
a fake boto3 client (the updated HyP3 JSON, the uploads), the three
missing-object errors, and the compute path with h5py and pandas blocked.
"""

import datetime as dt
import json
import os
import shutil
import sys

import h5py
import numpy as np
import pytest
import yaml

from raider_tpu.workflows import gunw as J
from raider_tpu.workflows import aws as j_aws
from raider_tpu.workflows import s1_timing as j_s1
from raider_tpu_torch.scripts import raw_weather
from raider_tpu_torch.workflows import aws as t_aws
from raider_tpu_torch.workflows import gunw as T
from raider_tpu_torch.workflows import s1_timing as t_s1
from raider_tpu_torch.wx.base import make_raw_weather_data_filename
from raider_tpu_torch.wx.exceptions import NoWeatherModelData

from tests.test_gunw_gnss import make_synthetic_gunw
from tests.test_orbit import synthetic_orbit
from tests.test_torch_gnss import blocked

NAME = 'S1-GUNW-D-R-071-tops-20200130_20200124-135156-34956N_32979N-PP-913f-v2_0_4.nc'
BOX_WKT = 'POLYGON ((-117.9 33.3, -117.3 33.3, -117.3 33.9, -117.9 33.9, -117.9 33.3))'
EPOCHS = (dt.datetime(2020, 1, 30, 13, 52, 7), dt.datetime(2020, 1, 24, 13, 52, 7))
ERA5_BOX = (31.0, 36.0, -120.5, -115.0)
HEIGHTS = [0]
WAVELENGTH = 0.05546576
F64_TOL = 1e-9 * 4 * np.pi / WAVELENGTH
PKGS = (('jax', J), ('port', T))


def write_gunw(path, wkt=BOX_WKT, lat=None, lon=None):
    make_synthetic_gunw(path)
    with h5py.File(path, 'a') as f:
        del f['productBoundingBox']
        f.create_dataset('productBoundingBox', data=np.array([wkt.encode()]))
        if lat is not None:
            for k, v in (('latitude', lat), ('longitude', lon)):
                f[f'science/grids/data/{k}'][...] = v
    return str(path)


@pytest.fixture(scope='module')
def inputs(tmp_path_factory):
    d = tmp_path_factory.mktemp('gunw_inputs')
    raw = [raw_weather.write_ecmwf(make_raw_weather_data_filename(str(d), 'ERA-5', t), 'ERA5',
                                   box=ERA5_BOX, seed=i, device='cpu')
           for i, t in enumerate(EPOCHS)]
    # statevectors around both epochs (the orbit's +-600 s pad picks one)
    lines = []
    for t0 in EPOCHS:
        orb = synthetic_orbit(t0, lon_asc_deg=-117.5)
        for sec, pos, vel in zip(orb.times, orb.pos, orb.vel):
            t = t0 + dt.timedelta(seconds=float(sec))
            lines.append(f'{t.isoformat()} ' + ' '.join(f'{v:.6f}' for v in (*pos, *vel)) + '\n')
    orbit = d / 'orbit.txt'
    orbit.write_text(''.join(lines))
    return {'raw': raw, 'orbit': str(orbit), 'gunw': write_gunw(d / NAME)}


@pytest.fixture
def patched(monkeypatch, inputs):
    """The orbit look-up returns the local orbit (recording its calls), the
    credentials check passes, and the GUNWs hold two heights, in both
    packages."""
    calls = []

    def orbits(ids, orbit_directory=None):
        calls.append((list(ids), os.path.basename(orbit_directory)))
        return [inputs['orbit']]

    for s1 in (j_s1, t_s1):
        monkeypatch.setattr(s1, 'get_orbits_from_slc_ids_hyp3lib', orbits)
    for mod in (J, T):
        monkeypatch.setattr(mod.credentials, 'check_api', lambda *a, **k: None)
        own = mod.GUNW.__init__

        def init(self, *a, _own=own, **k):
            _own(self, *a, **k)
            self.heights = list(HEIGHTS)
        monkeypatch.setattr(mod.GUNW, '__init__', init)
    return calls


def test_metadata_and_run_config(tmp_path, inputs, patched, monkeypatch):
    meta = T.read_gunw_metadata(inputs['gunw'])
    assert meta.bbox_wkt == BOX_WKT and meta.wavelength == WAVELENGTH
    assert meta.granules['reference'][0].startswith('S1B_IW_SLC__1SDV_20200130T135154')
    assert meta.data_extent == (-118.7, 33.0, -116.7, 34.9)
    j = J.GUNW(inputs['gunw'], 'ERA5', str(tmp_path / 'jax'))
    with blocked('h5py', 'pandas'):
        objs = [T.GUNW(meta, 'ERA5', str(tmp_path / 'port'))]
    objs.append(T.GUNW(inputs['gunw'], 'ERA5', str(tmp_path / 'port')))
    for t in objs:
        for k in ('SNWE', 'heights', 'dates', 'mid_time', 'look_dir', 'wavelength', 'name',
                  'orbit_file', 'spacing_m'):
            assert getattr(t, k) == getattr(j, k), k
        assert t.get_slc_dt() == j.get_slc_dt()
    assert patched[0] == patched[1] == (
        ['S1B_IW_SLC__1SDV_20200130T135154_20200130T135221_030090_037069_BBDD'], 'orbits')
    for rs in ('reference', 'secondary'):
        assert T._get_acq_time_from_gunw_id(NAME[:-3], rs) == J._get_acq_time_from_gunw_id(
            NAME[:-3], rs)
    with pytest.raises(ValueError):
        T._get_acq_time_from_gunw_id(NAME, 'both')

    cfgs = {}
    for tag, mod in PKGS:
        os.makedirs(tmp_path / tag, exist_ok=True)
        monkeypatch.chdir(tmp_path / tag)
        with blocked(*(('h5py', 'pandas') if tag == 'port' else ())):
            path, lam = mod.prep_from_gunw(meta if tag == 'port' else inputs['gunw'], 'ERA5',
                                           str(tmp_path / 'out'), interpolate_time='none')
        assert lam == WAVELENGTH and str(path) == 'GUNW_20200130-20200124_135156.yaml'
        cfgs[tag] = yaml.safe_load((tmp_path / tag / path).read_text())
    assert cfgs['port'] == cfgs['jax']


def test_synthetic_product_writer(tmp_path, inputs, patched):
    """``scripts.gunw_inputs.write_gunw`` writes a product that both
    packages read as the record it was given."""
    from raider_tpu_torch.scripts import gunw_inputs

    meta = T.read_gunw_metadata(inputs['gunw'])
    meta.path = str(tmp_path / NAME)
    assert gunw_inputs.write_gunw(meta.path, meta) == meta.path
    assert T.read_gunw_metadata(meta.path) == meta
    j = J.GUNW(meta.path, 'ERA5', str(tmp_path / 'jax'))
    t = T.GUNW(meta, 'ERA5', str(tmp_path / 'port'))
    for k in ('SNWE', 'dates', 'mid_time', 'look_dir', 'wavelength', 'name', 'orbit_file'):
        assert getattr(t, k) == getattr(j, k), k
    assert T.identify_which_hrrr(meta) == J.identify_which_hrrr(meta.path) == 'HRRR'
    with h5py.File(meta.path, 'r') as f:
        assert J.TROPO_GROUP in f and len(f[J.TROPO_GROUP]) == 0


def test_weather_model_availability(tmp_path, inputs):
    ak = write_gunw(tmp_path / NAME.replace('-071-', '-072-'),
                    wkt='POLYGON ((-150 61, -149 61, -149 62, -150 62, -150 61))',
                    lat=np.linspace(60.5, 62.5, 20), lon=np.linspace(-151.0, -148.0, 25))
    nowhere = tmp_path / 'none' / NAME
    os.makedirs(nowhere.parent)
    write_gunw(nowhere, lat=np.linspace(-40.0, -39.0, 20), lon=np.linspace(10.0, 12.0, 25))
    for path in (inputs['gunw'], ak, str(nowhere)):
        meta = T.read_gunw_metadata(path)
        for model in ('ERA5', 'ERAI', 'GMAO', 'HRES', 'MERRA2', 'HRRR', 'HRRRAK'):
            want = J.check_weather_model_availability(path, model)
            assert T.check_weather_model_availability(path, model) == want, (path, model)
            assert T.check_weather_model_availability(meta, model) == want
        try:
            want = J.identify_which_hrrr(path)
        except J.NoWeatherModelData:
            with pytest.raises(NoWeatherModelData, match='does not intersect'):
                T.identify_which_hrrr(meta)
        else:
            assert T.identify_which_hrrr(path) == T.identify_which_hrrr(meta) == want
    assert T.identify_which_hrrr(ak) == 'HRRRAK'


def _tree(path):
    """The troposphere group of a GUNW: {dataset path: (data, attrs,
    attached scales)} and the file's version."""
    out = {}
    with h5py.File(path, 'r') as f:
        def visit(name, obj):
            if isinstance(obj, h5py.Dataset):
                scales = [[s.name for s in obj.dims[i].values()] for i in range(obj.ndim)]
                attrs = {k: v for k, v in obj.attrs.items() if k not in ('DIMENSION_LIST',
                                                                         'REFERENCE_LIST')}
                out[name] = (obj[()], attrs, scales, obj.chunks)
        f[J.TROPO_GROUP].visititems(visit)
        return out, f.attrs['version']


def _same_attr(a, b):
    if isinstance(a, np.ndarray) or isinstance(b, np.ndarray):
        return np.array_equal(np.asarray(a), np.asarray(b))
    return a == b


def assert_groups_close(got_path, want_path, rtol=0.0):
    got, gv = _tree(got_path)
    want, wv = _tree(want_path)
    assert gv == wv == b'1c'
    assert sorted(got) == sorted(want) and len(got) == 2 * (3 + 1 + 2)
    for name, (data, attrs, scales, chunks) in want.items():
        g_data, g_attrs, g_scales, g_chunks = got[name]
        assert g_data.dtype == data.dtype and g_data.shape == data.shape, name
        assert g_scales == scales and g_chunks == chunks, name
        assert sorted(g_attrs) == sorted(attrs), name
        for k, v in attrs.items():
            if k != 'raider_tpu_version':
                assert _same_attr(g_attrs[k], v), (name, k, g_attrs[k], v)
        if name.rsplit('/', 1)[-1] in J.TROPO_NAMES:
            assert np.isfinite(data).all() and (data < 0).all()
            if rtol:
                np.testing.assert_allclose(g_data, data, rtol=rtol, atol=F64_TOL)
            else:
                np.testing.assert_array_max_ulp(g_data, data, maxulp=1)
        else:
            np.testing.assert_array_equal(g_data, data, err_msg=name)


def _phases(mod, cube_paths):
    return mod.compute_delays_slc(cube_paths, WAVELENGTH)[1]


def test_calc_delays_gunw_file(tmp_path, inputs, patched, monkeypatch):
    """The whole ``calcDelaysGUNW --file`` in the JAX package and, on the
    JAX package's processed files (netCDF4), in the port; then the port's
    compute path (``run_gunw``, h5py and pandas blocked) from the raw
    files, packaged by its writers."""
    runs = {}
    for tag in ('jax', 'fresh', 'same'):
        d = tmp_path / tag
        os.makedirs(d / 'out' / 'weather_files')
        gunw = shutil.copy(inputs['gunw'], d / NAME)
        if tag == 'same':
            for f in os.listdir(tmp_path / 'jax' / 'out' / 'weather_files'):
                if f.count('_') > 6:       # a processed file (its name ends in its bounds)
                    shutil.copy(tmp_path / 'jax' / 'out' / 'weather_files' / f,
                                d / 'out' / 'weather_files')
        else:
            for p in inputs['raw']:
                shutil.copy(p, d / 'out' / 'weather_files')
        monkeypatch.chdir(d)
        argv = ['--weather-model', 'ERA5', '--file', str(gunw), '-interp', 'none',
                '-o', str(d / 'out')]
        if tag == 'jax':
            cubes = J.calcDelaysGUNW(argv)
        elif tag == 'same':
            reads, own = [], T.read_gunw_metadata
            monkeypatch.setattr(T, 'read_gunw_metadata', lambda p: reads.append(p) or own(p))
            cubes = T.calcDelaysGUNW(argv, device='cpu', nc_format='NETCDF3_64BIT_OFFSET')
            assert reads == [str(gunw)]      # the product is opened once
        else:
            meta = T.read_gunw_metadata(gunw)
            with blocked('h5py', 'pandas'):
                run = T.run_gunw(meta, 'ERA5', str(d / 'out'), interpolate_time='none',
                                 device='cpu', nc_format='NETCDF3_64BIT_OFFSET')
            T.update_gunw_slc(gunw, run.model, run.arrays, run.coords, run.crs_attrs, run.attrs)
            T.update_gunw_version(gunw)
            cubes = run.cube_paths
            assert run.wavelength == WAVELENGTH and run.model == 'ERA5'
            for k, v in _phases(T, cubes).items():
                np.testing.assert_array_equal(run.arrays[k], v)
        runs[tag] = (gunw, [str(c) for c in cubes])
    names = [sorted(os.path.basename(c) for c in runs[t][1]) for t in runs]
    assert names[0] == names[1] == names[2] == ['ERA5_tropo_20200124T135207_ray.nc',
                                                 'ERA5_tropo_20200130T135207_ray.nc']
    for c in runs['fresh'][1] + runs['same'][1]:
        with open(c, 'rb') as f:
            assert f.read(4) == b'CDF\x02'
    want = _phases(J, runs['jax'][1])
    for tag, rtol in (('same', 0.0), ('fresh', 1e-6)):
        got = _phases(T, runs[tag][1])
        assert sorted(got) == sorted(want)
        for k in want:
            np.testing.assert_allclose(got[k], want[k], rtol=rtol, atol=F64_TOL, err_msg=k)
        assert_groups_close(runs[tag][0], runs['jax'][0], rtol=rtol)
    w_ref = want['reference_troposphereWet']
    assert np.abs(w_ref - want['secondary_troposphereWet']).max() > 0.0


def _write_cubes(mod_tag, d):
    """Two epochs' delay cubes as the package's calcDelays writes them."""
    from raider_tpu.delay.engine import writeResultsToDataset as j_write
    from raider_tpu.geodesy import Geographic as JGeo
    from raider_tpu.io import write_nc as j_write_nc
    from raider_tpu_torch.delay.engine import writeResultsToDataset as t_write
    from raider_tpu_torch.geodesy import Geographic as TGeo
    from raider_tpu_torch.io import write_nc as t_write_nc

    rng = np.random.default_rng(5)
    zpts = np.array([0.0, 1500.0])
    xpts, ypts = np.linspace(-117.9, -117.3, 7), np.linspace(33.9, 33.3, 7)
    out = []
    for day in ('20200124', '20200130'):
        wet = rng.uniform(0.01, 0.3, (2, 7, 7))
        hydro = rng.uniform(1.0, 2.5, (2, 7, 7))
        when = dt.datetime.strptime(day, '%Y%m%d')
        p = d / f'ERA5_tropo_{day}T135207_ray.nc'
        if mod_tag == 'jax':
            ds = j_write(when, xpts, ypts, zpts, JGeo(), wet, hydro, 'wm.nc', 'slant - raytracing')
            ds.attrs.update(model_times_used=[day], interpolation_method='none')
            j_write_nc(ds, p)
        else:
            ds = t_write(when, xpts, ypts, zpts, TGeo(), wet, hydro, 'wm.nc', 'slant - raytracing')
            ds.attrs.update(model_times_used=[day], interpolation_method='none')
            t_write_nc(ds, p, nc_format='NETCDF3_64BIT_OFFSET')
        out.append(str(p))
    return out


class FakeS3:
    """boto3's S3 client over a local directory: objects by key."""

    def __init__(self, objects: dict):
        self.objects = objects
        self.calls = []

    def list_objects_v2(self, Bucket, Prefix):
        self.calls.append(('list', Bucket, Prefix))
        keys = [k for k in self.objects if k.startswith(Prefix)]
        return {'Contents': [{'Key': k} for k in keys]} if keys else {}

    def download_file(self, bucket, key, file_name):
        self.calls.append(('download', bucket, key, file_name))
        shutil.copy(self.objects[key], file_name)

    def upload_file(self, path, bucket, key, extra):
        self.calls.append(('upload', os.path.basename(path), bucket, key, extra))

    def put_object_tagging(self, Bucket, Key, Tagging):
        self.calls.append(('tag', Bucket, Key, Tagging))


def _bucket(tmp_path, inputs, kinds=('.nc', '.json', '.png')):
    src = tmp_path / 'bucket'
    os.makedirs(src, exist_ok=True)
    files = {'.nc': inputs['gunw'], '.json': src / 'product.json', '.png': src / 'browse.png'}
    (src / 'product.json').write_text(json.dumps({'metadata': {'granules': ['a', 'b']}}))
    (src / 'browse.png').write_bytes(b'\x89PNG')
    return {f'in-prefix/{os.path.basename(str(files[k]))}': str(files[k]) for k in kinds}


def test_s3_flow(tmp_path, inputs, patched, monkeypatch):
    """``--bucket``: product, metadata JSON and browse image fetched through
    the client, the JSON updated, the product packaged, all three
    uploaded (calcDelays replaced by a writer of two cubes)."""
    from raider_tpu.workflows import calc_delays as j_cd
    from raider_tpu_torch.workflows import calc_delays as t_cd

    clients = {}
    for tag, mod, aws, cd in (('jax', J, j_aws, j_cd), ('port', T, t_aws, t_cd)):
        d = tmp_path / tag
        os.makedirs(d)
        monkeypatch.chdir(d)
        clients[tag] = FakeS3(_bucket(tmp_path / tag, inputs))
        monkeypatch.setattr(aws, '_client', lambda c=clients[tag]: c)
        cubes = _write_cubes(tag, d)
        monkeypatch.setattr(cd, 'calcDelays', lambda argv, c=cubes, **kw: c)
        out = mod.calcDelaysGUNW(['--bucket', 'bkt', '--bucket-prefix', 'out-prefix',
                                  '--input-bucket-prefix', 'in-prefix', '--weather-model', 'ERA5',
                                  '-interp', 'none', '-o', str(d)], **(
                                      {'device': 'cpu'} if tag == 'port' else {}))
        assert out == cubes
    for tag in clients:
        assert (tmp_path / tag / 'product.json').read_text() == (
            tmp_path / 'jax' / 'product.json').read_text()
    assert json.loads((tmp_path / 'port' / 'product.json').read_text())['metadata'][
        'weather_model'] == ['ERA5']
    assert clients['port'].calls == clients['jax'].calls
    assert [c[1] for c in clients['port'].calls if c[0] == 'upload'] == [
        NAME, 'product.json', 'browse.png']
    got, _ = _tree(tmp_path / 'port' / NAME)
    want, _ = _tree(tmp_path / 'jax' / NAME)
    assert sorted(got) == sorted(want)
    for name in want:
        np.testing.assert_array_max_ulp(got[name][0], want[name][0], maxulp=0)


@pytest.mark.parametrize('present,error', [
    ((), 'GUNW product file could not be found'),
    (('.nc',), 'GUNW metadata file could not be found'),
    (('.nc', '.json'), 'GUNW browse image could not be found'),
])
def test_missing_s3_objects(tmp_path, inputs, monkeypatch, present, error):
    for tag, mod, aws in (('jax', J, j_aws), ('port', T, t_aws)):
        d = tmp_path / tag
        os.makedirs(d)
        monkeypatch.chdir(d)
        monkeypatch.setattr(aws, '_client', lambda c=FakeS3(_bucket(d, inputs, present)): c)
        with pytest.raises(ValueError, match=error):
            mod.calcDelaysGUNW(['--bucket', 'dummy-bucket', '--input-bucket-prefix', 'in-prefix',
                                '--weather-model', 'ERA5'])


def test_without_h5py(tmp_path, inputs, monkeypatch):
    """With h5py blocked, ``calcDelaysGUNW --file`` raises an ImportError
    naming h5py; the layout of what the writers write is built all the
    same."""
    monkeypatch.setitem(sys.modules, 'h5py', None)
    monkeypatch.chdir(tmp_path)
    with pytest.raises(ImportError, match='h5py'):
        T.calcDelaysGUNW(['--weather-model', 'ERA5', '--file', inputs['gunw'], '-interp', 'none'],
                         device='cpu')
    with pytest.raises(ImportError, match='h5py'):
        T.calcDelaysGUNW(['--file', inputs['gunw']], device='cpu')
    cubes = _write_cubes('port', tmp_path)
    model, arrays, coords, crs_attrs, attrs = T.compute_delays_slc(cubes, WAVELENGTH)
    lay = T.troposphere_layout(model, arrays, coords, crs_attrs, attrs)
    assert lay['group'] == f'{T.TROPO_GROUP}/ERA5' and lay['chunks'] == (2, 2, 2)
    for rs in ('reference', 'secondary'):
        ep = lay['epochs'][rs]
        assert list(ep['dims']) == T.DIM_NAMES
        assert all(v.dtype == np.float32 for v in ep['dims'].values())
        assert ep['crs']['attrs']['grid_mapping_name'] == b'latitude_longitude'
        from raider_tpu_torch.geodesy.crs import crs_from_wkt

        assert crs_from_wkt(ep['crs']['wkt']['crs_wkt'].decode()).to_epsg() == 4326
        for name, var in ep['variables'].items():
            assert var['data'].dtype == np.float32 and var['dims'] == T.DIM_NAMES
            assert var['attrs']['units'] == b'radians' and var['attrs']['grid_mapping'] == b'crs'
            assert var['attrs']['long_name'] == var['attrs']['standard_name'] == name.encode()
            np.testing.assert_array_equal(var['data'], arrays[f'{rs}_{name}'].astype(np.float32))
