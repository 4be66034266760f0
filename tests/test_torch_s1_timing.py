"""Sentinel-1 azimuth timing: raider_tpu_torch.workflows.s1_timing vs raider_tpu's (CPU).

``get_n_closest_datetimes`` (datetime arithmetic in the port, pandas'
floor and ceil in the JAX package) agrees exactly on drawn times for steps
of 1, 3, 6, 12 and 24 h; the azimuth time grid (geo2rdr in float64 on the
device) agrees to 1 ms and its NaT mask exactly; the inverse weights agree
to 1e-12.
"""

import datetime as dt

import numpy as np
import pytest
from hypothesis import given, settings
from hypothesis import strategies as st

from raider_tpu.geometry.orbit import Orbit as JOrbit
from raider_tpu.workflows import s1_timing as j_s1
from raider_tpu_torch.convert import orbit_from_reference
from raider_tpu_torch.workflows import s1_timing as t_s1

from tests.test_orbit import synthetic_orbit

T0 = dt.datetime(2020, 1, 30, 13, 52, 45)


@settings(max_examples=200, deadline=None)
@given(st.datetimes(dt.datetime(1950, 1, 1), dt.datetime(2100, 1, 1)),
       st.sampled_from([1, 3, 6, 12, 24]), st.integers(1, 6))
def test_n_closest_datetimes(ref, step, n):
    got = t_s1.get_n_closest_datetimes(ref, n, step)
    want = j_s1.get_n_closest_datetimes(ref, n, step)
    assert got == want and all(type(t) is dt.datetime for t in got)
    assert t_s1.get_times_for_azimuth_interpolation(ref, step) == \
        j_s1.get_times_for_azimuth_interpolation(ref, step)


@pytest.mark.parametrize('ref', [dt.datetime(2020, 1, 30, 12, 0), dt.datetime(2020, 1, 30, 0, 0),
                                 dt.datetime(2020, 1, 30, 23, 59, 59, 999999),
                                 dt.datetime(1969, 12, 31, 23, 30)])
def test_n_closest_on_and_off_the_grid(ref):
    for step in (1, 3, 6, 12, 24):
        for n in range(1, 6):
            assert t_s1.get_n_closest_datetimes(ref, n, step) == \
                j_s1.get_n_closest_datetimes(ref, n, step)
    with pytest.raises(ValueError):
        t_s1.get_n_closest_datetimes(ref, 3, 7)


def _meshes():
    lat = np.linspace(33.0, 34.0, 7)
    lon = np.linspace(-118.2, -117.2, 9)
    hgt = np.array([-100.0, 0.0, 2000.0, 15000.0])
    m, n, p = hgt.size, lat.size, lon.size
    lat3 = np.broadcast_to(lat[None, :, None], (m, n, p))
    lon3 = np.broadcast_to(lon[None, None, :], (m, n, p))
    hgt3 = np.broadcast_to(hgt[:, None, None], (m, n, p))
    return lon3, lat3, hgt3


def test_azimuth_time_grid_matches_jax():
    orbit = synthetic_orbit(T0)
    lon, lat, hgt = _meshes()
    lat = lat.copy()
    lat[0, 0, 0] = np.nan                        # a NaN target gives NaT
    got = t_s1.get_azimuth_time_grid(lon, lat, hgt, orbit_from_reference(orbit), device='cpu')
    want = j_s1.get_azimuth_time_grid(lon, lat, hgt, orbit)
    assert got.dtype == want.dtype == np.dtype('datetime64[ms]') and got.shape == want.shape
    assert np.array_equal(np.isnat(got), np.isnat(want)) and np.isnat(got[0, 0, 0])
    ok = ~np.isnat(got)
    assert np.max(np.abs((got[ok] - want[ok]).astype(np.int64))) <= 1


def test_s1_grid_from_a_local_orbit_and_the_constant_branch(monkeypatch, tmp_path):
    from raider_tpu_torch.scripts import point_inputs

    eof = point_inputs.write_eof(tmp_path, orbit_from_reference(synthetic_orbit(T0)))
    lon, lat, hgt = _meshes()
    for mod in (j_s1, t_s1):
        monkeypatch.setattr(mod, 'get_slc_ids_from_time', lambda lon, lat, time: ['S1A_x'])
        monkeypatch.setattr(mod, 'get_orbits_from_slc_ids_hyp3lib',
                            lambda ids, orbit_directory=None: [eof])
    got = t_s1.get_s1_azimuth_time_grid(lon, lat, hgt, T0, device='cpu')
    want = j_s1.get_s1_azimuth_time_grid(lon, lat, hgt, T0)
    assert np.max(np.abs((got - want).astype(np.int64))) <= 1
    # the look-up fails: the grid is the time everywhere, in both packages
    for mod in (j_s1, t_s1):
        monkeypatch.setattr(mod, 'get_slc_ids_from_time',
                            lambda lon, lat, time: (_ for _ in ()).throw(OSError('offline')))
    got = t_s1.get_s1_azimuth_time_grid(lon, lat, hgt, T0, device='cpu')
    assert np.array_equal(got, j_s1.get_s1_azimuth_time_grid(lon, lat, hgt, T0))
    assert (got == np.datetime64(T0, 'ms')).all()


@pytest.mark.parametrize('window', [None, 2.0])
def test_inverse_weights_match_jax(window):
    rng = np.random.default_rng(5)
    base = np.datetime64(T0, 'ms')
    grid = base + rng.integers(-3_600_000, 3_600_000, (4, 6, 5)).astype('timedelta64[ms]')
    dates = [T0.replace(minute=0, second=0) + dt.timedelta(hours=h) for h in (0, 1, -1)]
    got = t_s1.get_inverse_weights_for_dates(grid, dates, temporal_window_hours=window)
    want = j_s1.get_inverse_weights_for_dates(grid, dates, temporal_window_hours=window)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g, w, rtol=0, atol=1e-12)
    assert np.max(np.abs(np.sum(got, axis=0) - 1.0)) <= 1e-12
    with pytest.raises(ValueError):
        t_s1.get_inverse_weights_for_dates(grid, [dates[0], dates[0]])


def test_orbit_conversion_is_the_reference():
    orbit = synthetic_orbit(T0)
    assert isinstance(orbit, JOrbit)
    conv = orbit_from_reference(orbit)
    assert np.array_equal(conv.pos, orbit.pos) and conv.ref_time == orbit.ref_time
