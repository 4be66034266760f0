"""netCDF reading: raider_tpu_torch.io.read_nc vs raider_tpu.io.read_nc (CPU).

A classic netCDF-3 file (written by ``scipy.io.netcdf_file``: raw CDS/MARS
downloads, WRF output, the readers' raw files) is read by scipy and never
touches h5py, which the machine with the card does not have; an HDF5
netCDF4 file still goes through h5py. Values, dims and attributes are
compared exactly (both readers return what scipy's maskandscale gives).
"""

import os
import subprocess
import sys
import textwrap

import numpy as np
import pytest

from raider_tpu.io import ncdf as j_ncdf
from raider_tpu_torch.io import ncdf as t_ncdf

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def write_nc3(path, version=1, scalar=False):
    """A classic file: a coordinate, a 2-D field with a _FillValue, packed
    int16 data and, with ``scalar``, a 0-d variable with CF grid-mapping
    attrs (the JAX reader slices every variable with ``[:]``, which a 0-d
    one refuses; the port reads it)."""
    from scipy.io import netcdf_file

    rng = np.random.default_rng(0)
    with netcdf_file(str(path), 'w', version=version) as f:
        f.title = 'classic'
        f.createDimension('level', 3)
        f.createDimension('lat', 4)
        lev = f.createVariable('level', 'f8', ('level',))
        lev[:] = [1.0, 2.0, 3.0]
        t = f.createVariable('t', 'f4', ('level', 'lat'))
        data = rng.uniform(200.0, 300.0, (3, 4)).astype(np.float32)
        data[1, 2] = -9999.0
        t[:] = data
        t._FillValue = np.float32(-9999.0)
        t.units = 'K'
        q = f.createVariable('q', 'i2', ('level', 'lat'))
        q[:] = rng.integers(-100, 100, (3, 4)).astype(np.int16)
        q.scale_factor = 0.5
        q.add_offset = 10.0
        if not scalar:
            return
        p = f.createVariable('proj', 'i4', ())
        p[...] = 0
        p.grid_mapping_name = 'lambert_conformal_conic'
        p.standard_parallel = 38.5
        p.earth_radius = 6371229.0


def _same(a, b):
    a, b = np.asarray(a), np.asarray(b)
    assert a.shape == b.shape
    np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize('version', [1, 2])
def test_netcdf3_reads_as_jax_reads(tmp_path, version):
    path = tmp_path / 'classic.nc'
    write_nc3(path, version)
    with open(path, 'rb') as fh:
        assert fh.read(4) == (b'CDF\x01' if version == 1 else b'CDF\x02')
    ref, out = j_ncdf.read_nc(path), t_ncdf.read_nc(path)
    assert set(out.coords) == set(ref.coords) == {'level'}
    assert set(out.variables) == set(ref.variables) == {'t', 'q'}
    assert out.attrs == ref.attrs
    for name in ('level', 't', 'q'):
        assert tuple(out[name].dims) == tuple(ref[name].dims)
        _same(out[name].data, ref[name].data)
        assert out[name].attrs.keys() == ref[name].attrs.keys()
    assert out['t'].data.dtype.isnative


_NO_H5PY = textwrap.dedent('''
    import sys
    sys.modules['h5py'] = None          # any import of h5py now raises
    from raider_tpu_torch.io import read_nc
    from raider_tpu_torch.geodesy import crs_from_cf
    ds = read_nc(sys.argv[1])
    assert set(ds.variables) == {'t', 'q', 'proj'}, ds.variables
    assert int(ds['proj'].data) == 0 and ds['proj'].data.shape == ()
    assert crs_from_cf(ds['proj'].attrs).to_cf()['standard_parallel'] == 38.5
    print('NO_H5PY_OK', float(ds['q'].data.sum()))
''')


def test_netcdf3_reads_without_h5py(tmp_path):
    path = tmp_path / 'classic.nc'
    write_nc3(path, scalar=True)
    res = subprocess.run([sys.executable, '-c', _NO_H5PY, str(path)], cwd=REPO,
                         capture_output=True, text=True, timeout=120)
    assert res.returncode == 0, res.stderr[-2000:]
    assert 'NO_H5PY_OK' in res.stdout
    write_nc3(tmp_path / 'no_scalar.nc')
    total = float(res.stdout.split()[-1])
    assert total == float(np.asarray(j_ncdf.read_nc(tmp_path / 'no_scalar.nc')['q'].data).sum())


def test_hdf5_still_goes_through_h5py(tmp_path, monkeypatch):
    """A netCDF4 file is opened by h5py; dims come from the attached
    scales, and an axis with none matches a coordinate by its length."""
    import h5py

    path = tmp_path / 'nc4.nc'
    ds = t_ncdf.Dataset(coords={'x': t_ncdf.Variable(('x',), np.arange(5.0))},
                        variables={'a': t_ncdf.Variable(('x',), np.arange(5.0) * 2)})
    t_ncdf.write_nc(ds, path)
    with h5py.File(path, 'a') as f:
        f.create_dataset('b', data=np.ones((2, 5)))    # no scales attached
    opened = []
    real = h5py.File

    def spy(*args, **kwargs):
        opened.append(args[0])
        return real(*args, **kwargs)

    monkeypatch.setattr(h5py, 'File', spy)
    out = t_ncdf.read_nc(path)
    assert opened == [path]
    monkeypatch.setattr(h5py, 'File', real)
    ref = j_ncdf.read_nc(path)
    assert tuple(out['b'].dims) == tuple(ref['b'].dims) == ('dim_0', 'x')
    _same(out['a'].data, ref['a'].data)
    with pytest.raises(ValueError, match='netCDF-3'):
        write_nc3(tmp_path / 'c.nc')
        t_ncdf.read_nc(tmp_path / 'c.nc', group='g')


def _encoded_dataset():
    """Every value netCDF-3 holds only through an encoding of write_nc."""
    import torch

    return t_ncdf.Dataset(
        coords={'x': t_ncdf.Variable(('x',), np.arange(3.0), {'units': 'm'}),
                'z': t_ncdf.Variable(('z',), np.array([0.0, 500.0]), {})},
        variables={
            'wet': t_ncdf.Variable(('z', 'x'), torch.arange(6, dtype=torch.float32).reshape(2, 3),
                                   {'grid_mapping': 'proj', 'flag': True, 'n': 3, 'f': 0.1,
                                    'arr': [1.5, 2.5], 'flags': np.array([True, False])}),
            'proj': t_ncdf.Variable((), np.int64(-2147483647),
                                    {'name': 'Zürich é', 'standard_parallel': [38.5]}),
            'mask': t_ncdf.Variable(('z', 'x'),
                                    np.array([[True, False, True], [False, False, True]]), {}),
            'count': t_ncdf.Variable(('z',), np.array([1, 2], np.int16), {}),
        },
        attrs={'model_times_used': ['20200130T13:00:00', '20200130T14:00:00'],
               'one_time': ['20200130T13:00:00'], 'Date1': 0, 'scale': np.float32(2.5),
               'empty': '', 'title': 'delays'})


def test_netcdf3_encodings_round_trip(tmp_path):
    """Each value classic netCDF cannot hold reads back as it was written:
    int64 and bool data, string lists, bools, non-ASCII text, Python
    floats (not float32)."""
    ds = _encoded_dataset()
    path = t_ncdf.write_nc(ds, tmp_path / 'a.nc', nc_format='NETCDF3_64BIT_OFFSET')
    with open(path, 'rb') as fh:
        assert fh.read(4) == b'CDF\x02'
    back = t_ncdf.read_nc(path)
    assert set(back.coords) == {'x', 'z'} and set(back.variables) == set(ds.variables)
    for name, var in list(ds.coords.items()) + list(ds.variables.items()):
        a, b = t_ncdf.to_numpy(var.data), np.asarray(back[name].data)
        assert a.dtype == b.dtype and tuple(back[name].dims) == tuple(var.dims), name
        np.testing.assert_array_equal(a, b)
        assert set(back[name].attrs) == set(var.attrs), name
        for k, v in var.attrs.items():
            np.testing.assert_array_equal(np.asarray(back[name].attrs[k]), np.asarray(v))
    assert back.attrs['model_times_used'] == ds.attrs['model_times_used']
    assert back.attrs['one_time'] == ['20200130T13:00:00']
    assert back['wet'].attrs['flag'] is np.True_ and back['wet'].attrs['f'] == 0.1
    assert back['wet'].attrs['f'].dtype == np.float64
    assert back['proj'].attrs['name'] == 'Zürich é'
    assert back.attrs['empty'] == '' and back.attrs['scale'].dtype == np.float32


def test_netcdf3_and_netcdf4_read_back_alike(tmp_path):
    ds = _encoded_dataset()
    ds.variables['proj'].attrs['name'] = 'ascii'   # the netCDF4 writer stores ASCII text
    a = t_ncdf.read_nc(t_ncdf.write_nc(ds, tmp_path / 'a.nc'))
    b = t_ncdf.read_nc(t_ncdf.write_nc(ds, tmp_path / 'b.nc', nc_format='NETCDF3_64BIT_OFFSET'))
    with open(tmp_path / 'a.nc', 'rb') as fh:
        assert fh.read(4) == b'\x89HDF'
    for name in list(ds.coords) + list(ds.variables):
        np.testing.assert_array_equal(np.asarray(a[name].data), np.asarray(b[name].data))
        assert np.asarray(a[name].data).dtype == np.asarray(b[name].data).dtype
    # the netCDF4 reader gives a string array, the netCDF-3 one the list
    assert [str(v) for v in a.attrs['model_times_used']] == b.attrs['model_times_used']


@pytest.mark.parametrize('change,match', [
    (lambda ds: ds.variables.__setitem__('big', t_ncdf.Variable(('z',), np.array([0, 2**40]))),
     'int32 range'),
    (lambda ds: ds.variables.__setitem__('u', t_ncdf.Variable(('z',), np.array([1, 2], np.uint8))),
     'uint8'),
    (lambda ds: ds.variables.__setitem__('c', t_ncdf.Variable(('z',), np.array([1j, 2j]))),
     'complex'),
    (lambda ds: ds.attrs.__setitem__('times', ['a\nb', 'c']), 'newline'),
    (lambda ds: ds.attrs.__setitem__('none', []), 'empty'),
    (lambda ds: ds.attrs.__setitem__('big', 2**40), 'int32 range'),
    (lambda ds: ds.attrs.__setitem__('_nc3_bools', 'x'), 'reserve'),
    (lambda ds: ds.attrs.__setitem__('obj', None), 'cannot store'),
])
def test_netcdf3_refuses_what_it_cannot_hold(tmp_path, change, match):
    ds = _encoded_dataset()
    change(ds)
    with pytest.raises(ValueError, match=match):
        t_ncdf.write_nc(ds, tmp_path / 'a.nc', nc_format='NETCDF3_64BIT_OFFSET')


def test_netcdf3_has_no_groups_or_append(tmp_path):
    ds = _encoded_dataset()
    for kwargs in ({'group': 'science'}, {'mode': 'a'}):
        with pytest.raises(ValueError, match='NETCDF4'):
            t_ncdf.write_nc(ds, tmp_path / 'a.nc', nc_format='NETCDF3_64BIT_OFFSET', **kwargs)
    with pytest.raises(ValueError, match='nc_format'):
        t_ncdf.write_nc(ds, tmp_path / 'a.nc', nc_format='NETCDF3_CLASSIC')
