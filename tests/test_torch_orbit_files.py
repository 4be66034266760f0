"""Orbit files, the projection factor and the LOS classes that read them:
the port vs the JAX package (CPU).

The statevector files are synthetic (the reference's orbit files are not in
the repo): an ESA EOF XML and a 7-column text file written by
``raider_tpu_torch.scripts.point_inputs`` from the circular orbit of
tests/test_orbit.py, and an ISCE2-style shelve written here with
module-level classes. Both packages' readers and ``get_orbit`` return equal
arrays; ``state_to_los_factor`` agrees within 1e-12 (the same float64
geometry, evaluated in a different order).
"""

import datetime as dt
import shelve

import numpy as np
import pytest
import torch

from raider_tpu.geometry import los as j_los
from raider_tpu.geometry import orbit as j_orbit
from raider_tpu_torch.geometry import los as t_los
from raider_tpu_torch.geometry import orbit as t_orbit
from raider_tpu_torch.io import write_envi
from raider_tpu_torch.scripts import point_inputs

from tests.test_orbit import synthetic_orbit

T0 = dt.datetime(2020, 1, 30, 13, 52, 45)
FACTOR_TOL = 1e-12


class StateVector:
    def __init__(self, time, position, velocity):
        self.time = time
        self.position = position
        self.velocity = velocity


class FrameOrbit:
    def __init__(self, svs):
        self.stateVectors = svs


class Frame:
    def __init__(self, svs):
        self.orbit = FrameOrbit(svs)


@pytest.fixture(scope='module')
def orbit():
    return synthetic_orbit(T0)


@pytest.fixture(scope='module')
def files(tmp_path_factory, orbit):
    d = tmp_path_factory.mktemp('orbits')
    f = {'eof': point_inputs.write_eof(d, orbit),
         'txt': point_inputs.write_txt_orbit(d / 'orbit.txt', orbit)}
    # a second EOF whose validity window (by its name) does not hold T0
    later = t_orbit.Orbit(times=orbit.times, pos=orbit.pos, vel=orbit.vel,
                          ref_time=T0 + dt.timedelta(days=3))
    f['eof_later'] = point_inputs.write_eof(d, later, mission='S1B')
    times = [T0 + dt.timedelta(seconds=float(t)) for t in orbit.times]
    f['shelve'] = str(d / 'frame_db')
    with shelve.open(f['shelve']) as db:
        db['frame'] = Frame([StateVector(t, p.tolist(), v.tolist())
                             for t, p, v in zip(times, orbit.pos, orbit.vel)])
    f['empty_shelve'] = str(d / 'empty_db')
    with shelve.open(f['empty_shelve']) as db:
        db['frame'] = Frame([])
    f['bad'] = str(d / 'bad.txt')
    with open(f['bad'], 'w') as fh:
        fh.write('2020-01-30T13:52:45 1 2 3 4\n')
    return f


def assert_read_equal(a, b):
    assert a[0] == b[0]
    for x, y in zip(a[1:], b[1:]):
        assert x.dtype == y.dtype == np.float64
        np.testing.assert_array_equal(x, y)


@pytest.mark.parametrize('reader,key', [('read_ESA_orbit_file', 'eof'), ('read_txt_file', 'txt'),
                                        ('read_shelve_file', 'shelve')])
def test_readers_match_jax(files, orbit, reader, key):
    got = getattr(t_orbit, reader)(files[key])
    assert_read_equal(got, getattr(j_orbit, reader)(files[key]))
    # the files hold the orbit to their printed precision (6 decimals)
    assert got[0][0] == T0 + dt.timedelta(seconds=float(orbit.times[0]))
    np.testing.assert_allclose(got[1], orbit.pos, rtol=0, atol=5e-7 + 1e-8)
    np.testing.assert_allclose(got[2], orbit.vel, rtol=0, atol=5e-7 + 1e-8)


@pytest.mark.parametrize('source', ['eof', 'txt', 'shelve', 'both_eofs', 'eof_and_txt',
                                    'eof_later_only'])
@pytest.mark.parametrize('pad', [600, 100, 15, None])
def test_get_orbit_matches_jax(files, source, pad):
    arg = {'both_eofs': [files['eof_later'], files['eof']],
           'eof_and_txt': [files['txt'], files['eof']],
           'eof_later_only': files['eof_later']}.get(source, files.get(source))
    ref = T0 + dt.timedelta(seconds=3.5)
    try:
        j = j_orbit.get_orbit(arg, ref, pad=pad)
    except ValueError:
        # two files of the same statevectors, 3 of them within the pad:
        # fewer than 4 once de-duplicated, refused by both
        assert source == 'eof_and_txt' and pad == 15
        with pytest.raises(ValueError, match='At least 4'):
            t_orbit.get_orbit(arg, ref, pad=pad)
        return
    t = t_orbit.get_orbit(arg, ref, pad=pad)
    assert isinstance(t, t_orbit.Orbit) and t.ref_time == j.ref_time
    for k in ('times', 'pos', 'vel'):
        np.testing.assert_array_equal(getattr(t, k), getattr(j, k))
    assert t.direction == j.direction
    assert np.all(np.diff(t.times) > 0) and t.times.size >= 4


def test_get_orbit_refusals(files):
    for pkg in (j_orbit, t_orbit):
        with pytest.raises(ValueError):
            pkg.get_orbit(files['bad'], T0)
        with pytest.raises(ValueError):
            pkg.read_shelve_file(files['empty_shelve'])


def test_eof_name_filters(files):
    for pkg in (j_orbit, t_orbit):
        assert pkg.filter_ESA_orbit_file(files['eof'], T0)
        assert not pkg.filter_ESA_orbit_file(files['eof_later'], T0)
        assert pkg.pick_ESA_orbit_file([files['eof_later'], files['eof']], T0) == files['eof']
        with pytest.raises(AssertionError):
            pkg.pick_ESA_orbit_file([files['eof_later']], T0)
    times = np.arange(0.0, 101.0, 10.0)
    stamps = [T0 + dt.timedelta(seconds=t) for t in times]
    for args in ((times, times[0], 3600 * 3), (times, times[0], 5), (times, times[4], 15),
                 (times, times[0], 400), (stamps, stamps[4], 15)):
        np.testing.assert_array_equal(t_orbit.cut_times(*args), j_orbit.cut_times(*args))


def _targets(n=64, seed=5):
    rng = np.random.default_rng(seed)
    return rng.uniform(33.0, 34.0, n), rng.uniform(-118.5, -117.0, n), rng.uniform(0.0, 3000.0, n)


def test_state_to_los_factor_matches_jax(orbit, files):
    """From the orbit in memory and from its EOF file (each package reading
    the file), on float64 tensors and on numpy arrays."""
    lat, lon, hgt = _targets()
    in_memory = t_orbit.Orbit(orbit.times, orbit.pos, orbit.vel, orbit.ref_time)
    for j_orb, t_orb in ((orbit, in_memory),
                         (j_orbit.get_orbit(files['eof'], T0), t_orbit.get_orbit(files['eof'], T0))):
        ref = np.asarray(j_orbit.state_to_los_factor(j_orb, lat, lon, hgt))
        for pts in ((torch.as_tensor(lat), lon, hgt), (lat, lon, hgt)):
            got = t_orbit.state_to_los_factor(t_orb, *pts)
            assert got.dtype == torch.float64 and got.shape == (64,)
            np.testing.assert_allclose(got.numpy(), ref, rtol=0, atol=FACTOR_TOL)
        assert np.all((ref > 0.2) & (ref < 1.0))


@pytest.mark.parametrize('key', ['eof', 'txt', 'shelve'])
def test_conventional_from_an_orbit_file(files, key):
    lat, lon, hgt = _targets(16)
    delays = np.linspace(2.0, 2.6, 16)
    outs = []
    for pkg, pts in ((j_los, (lat, lon, hgt)), (t_los, (lat, lon, hgt)),
                     (t_los, tuple(torch.as_tensor(a) for a in (lat, lon, hgt)))):
        los = pkg.Conventional(files[key], time=T0)
        los.setPoints(*pts)
        outs.append(los(torch.as_tensor(delays) if isinstance(pts[0], torch.Tensor) else delays))
    np.testing.assert_allclose(outs[1], outs[0], rtol=FACTOR_TOL, atol=0)
    assert isinstance(outs[2], torch.Tensor)
    np.testing.assert_array_equal(outs[2].numpy(), outs[1])
    assert np.all(outs[1] > delays)


def test_conventional_from_an_incidence_raster(tmp_path):
    rng = np.random.default_rng(9)
    inc = rng.uniform(20.0, 45.0, (4, 5)).astype(np.float32)
    hd = rng.uniform(-180.0, 180.0, (4, 5)).astype(np.float32)
    path = str(tmp_path / 'los.dat')
    write_envi(np.stack([inc, hd]), path, nodata=-9999.0)
    delays = np.full((4, 5), 2.0)
    outs = []
    for pkg in (j_los, t_los):
        los = pkg.Conventional(path)
        los.setPoints(np.zeros((4, 5)), np.zeros((4, 5)), np.zeros((4, 5)))
        outs.append(los(delays))
    np.testing.assert_array_equal(outs[1], outs[0])
    np.testing.assert_allclose(outs[1], 2.0 / np.cos(np.deg2rad(inc.astype(np.float64))),
                               rtol=1e-12)
    with pytest.raises(ValueError):
        t_los.inc_hd_to_enu(np.array([-1.0]), np.array([0.0]))
    for inc_d, hd_d in ((0, 18), (35, 0), (35, 180), (35, 90), (12.5, -33.0)):
        np.testing.assert_array_equal(t_los.inc_hd_to_enu(inc_d, hd_d),
                                      j_los.inc_hd_to_enu(inc_d, hd_d))
    enu = t_los.inc_hd_to_enu(inc.astype(np.float64), hd.astype(np.float64))
    back = point_inputs.inc_hd_from_look(enu)
    np.testing.assert_allclose(back[0], inc, rtol=1e-6)
    np.testing.assert_allclose(np.remainder(back[1] - hd + 180.0, 360.0) - 180.0, 0.0, atol=1e-4)


def test_raytracing_reads_its_orbit_file(files):
    """Raytracing(filename=, time=) loads its orbit at construction, and
    setTime reloads it with the constructor's pad."""
    j = j_los.Raytracing(filename=files['eof'], time=T0, pad=100)
    t = t_los.Raytracing(filename=files['eof'], time=T0, pad=100)
    np.testing.assert_array_equal(t._orbit.times, j._orbit.times)
    assert t.getSensorDirection() == j.getSensorDirection()
    later = T0 + dt.timedelta(seconds=200)
    j.setTime(later)
    t.setTime(later)
    np.testing.assert_array_equal(t._orbit.times, j._orbit.times)
    np.testing.assert_array_equal(t._orbit.pos, j._orbit.pos)
    assert t._orbit.times.size == 19 and t._orbit.ref_time == later
    assert t_los.Raytracing(filename=files['eof'])._orbit is None


def test_zenith_look_vectors_match_jax():
    lat, lon, hgt = _targets(8)
    z = t_los.Zenith()
    z.setPoints(torch.as_tensor(lat), torch.as_tensor(lon), torch.as_tensor(hgt))
    z.setLookVectors()
    ref = np.asarray(j_los.getZenithLookVecs(lat, lon, hgt))
    np.testing.assert_allclose(z._look_vecs.numpy(), ref, rtol=0, atol=1e-15)
    np.testing.assert_allclose(t_los.getZenithLookVecs(lat, lon, hgt).numpy(), ref,
                               rtol=0, atol=1e-15)
    z = t_los.Zenith()
    with pytest.raises(ValueError):
        z.setLookVectors()
    llh = np.stack([lat, lon, hgt], -1)
    z.setPoints(llh)
    np.testing.assert_array_equal(z._heights, hgt)
