"""raider_tpu_torch geodesy and geometry vs the JAX package's float64 host
path (CPU), on identical seeded inputs.

Tolerances: ECEF coordinates 1e-12 relative; heights 1e-6 m (the port's
cube root is pow(x, 1/3), JAX's is cbrt); orbit positions 1e-6 m and
velocities 1e-9 m/s (the same Hermite polynomial, derivatives carried
through Horner's rule instead of forward-mode autodiff); geo2rdr times
1e-9 s; ray intersections 1e-6 m.
"""

import datetime as dt

import numpy as np
import pytest
import torch

from raider_tpu.geodesy import ellipsoid as j_ell
from raider_tpu.geodesy import gravity as j_grav
from raider_tpu.geometry import orbit as j_orbit
from raider_tpu.geometry import rays as j_rays
from raider_tpu_torch.convert import orbit_from_reference
from raider_tpu_torch.geodesy import crs as t_crs
from raider_tpu_torch.geodesy import ellipsoid as t_ell
from raider_tpu_torch.geodesy import gravity as t_grav
from raider_tpu_torch.geometry import orbit as t_orbit
from raider_tpu_torch.geometry import rays as t_rays

from tests.test_orbit import synthetic_orbit

T0 = dt.datetime(2020, 1, 30, 13, 52, 45)


def _llh(n=500, seed=0):
    rng = np.random.default_rng(seed)
    return (rng.uniform(-89.0, 89.0, n), rng.uniform(-180.0, 180.0, n),
            rng.uniform(-500.0, 30000.0, n))


@pytest.fixture(scope='module')
def orbits():
    j = synthetic_orbit(T0)
    return j, orbit_from_reference(j)


def test_lla2ecef_matches_jax():
    lat, lon, h = _llh()
    ref = np.stack([np.asarray(v) for v in j_ell.lla2ecef(lat, lon, h)])
    out = torch.stack(t_ell.lla2ecef(lat, lon, h)).numpy()
    np.testing.assert_allclose(out, ref, rtol=1e-12, atol=1e-6)


@pytest.mark.parametrize('seed', [0, 1])
def test_ecef2lla_round_trip_matches_jax(seed):
    lat, lon, h = _llh(seed=seed)
    x, y, z = (np.asarray(v) for v in j_ell.lla2ecef(lat, lon, h))
    j_lat, j_lon, j_h = (np.asarray(v) for v in j_ell.ecef2lla(x, y, z))
    t_lat, t_lon, t_h = (v.numpy() for v in t_ell.ecef2lla(x, y, z))
    np.testing.assert_allclose(t_h, j_h, rtol=0, atol=1e-6)
    np.testing.assert_allclose(t_h, h, rtol=0, atol=1e-6)
    np.testing.assert_allclose(t_lat, j_lat, rtol=1e-12, atol=1e-12)
    np.testing.assert_allclose(t_lon, j_lon, rtol=1e-12, atol=1e-12)


def test_gravity_matches_jax():
    lat, _, h = _llh()
    np.testing.assert_allclose(t_grav.get_Re(lat).numpy(), np.asarray(j_grav.get_Re(lat)),
                               rtol=1e-12)
    np.testing.assert_allclose(t_grav.geo_to_ht(lat, h).numpy(),
                               np.asarray(j_grav.geo_to_ht(lat, h)), rtol=1e-12, atol=1e-9)


def test_geodetic_normal_matches_jax():
    lat, lon, _ = _llh()
    np.testing.assert_allclose(t_ell.geodetic_normal(lat, lon).numpy(),
                               np.asarray(j_ell.geodetic_normal(lat, lon)), rtol=1e-12, atol=1e-15)


@pytest.mark.parametrize('value,expect', [(4326, t_crs.Geographic), ('EPSG:4978', t_crs.Geocentric),
                                          ({'grid_mapping_name': 'latitude_longitude'},
                                           t_crs.Geographic)])
def test_crs_parsing(value, expect):
    assert isinstance(t_crs.crs_from_user(value), expect)


def test_geographic_geocentric_transform_matches_jax():
    from raider_tpu.geodesy import crs as j_crs

    lat, lon, h = _llh()
    ref = j_crs.transform_points(j_crs.Geographic(), j_crs.Geocentric(), lon, lat, h)
    out = t_crs.transform_points(t_crs.Geographic(), t_crs.Geocentric(), lon, lat, h)
    np.testing.assert_allclose(torch.stack(out).numpy(), np.stack([np.asarray(v) for v in ref]),
                               rtol=1e-12)
    back = t_crs.transform_points(t_crs.Geocentric(), t_crs.Geographic(), *out)
    np.testing.assert_allclose(back[2].numpy(), h, atol=1e-6)


def test_interpolate_orbit_matches_jax(orbits):
    j, t = orbits
    tq = np.random.default_rng(4).uniform(j.times[0], j.times[-1], 300)
    jp, jv = (np.asarray(v) for v in j_orbit.interpolate_orbit(j.times, j.pos, j.vel, tq))
    tp, tv = t_orbit.interpolate_orbit(t.times, t.pos, t.vel, tq)
    np.testing.assert_allclose(tp.numpy(), jp, rtol=0, atol=1e-6)
    np.testing.assert_allclose(tv.numpy(), jv, rtol=0, atol=1e-9)
    # exact at the statevectors
    tp5, tv5 = t_orbit.interpolate_orbit(t.times, t.pos, t.vel, t.times[5])
    np.testing.assert_allclose(tp5.numpy(), t.pos[5], atol=1e-7)
    np.testing.assert_allclose(tv5.numpy(), t.vel[5], atol=1e-8)


def _targets(j):
    lats = np.array([33.0, 33.5, 34.0, 33.2])
    lons = np.array([-118.0, -117.5, -117.0, -117.7])
    x, y, z = (np.asarray(v) for v in j_ell.lla2ecef(lats, lons, np.zeros(4)))
    targ = np.stack([x, y, z], -1)
    # a sub-satellite point at t=700 s (outside the +-600 s span) and a NaN
    p_out, _ = j._posvel(700.0)
    return np.vstack([targ, 6.371e6 * p_out / np.linalg.norm(p_out), np.full(3, np.nan)])


def test_geo2rdr_matches_jax(orbits):
    j, t = orbits
    targ = _targets(j)
    jaz, jsr, jpos, jvel = (np.asarray(v) for v in j_orbit.geo2rdr(j.times, j.pos, j.vel, targ))
    taz, tsr, tpos, tvel = (v.numpy() for v in t_orbit.geo2rdr(t.times, t.pos, t.vel, targ))
    np.testing.assert_array_equal(np.isnan(taz), np.isnan(jaz))
    assert np.isnan(taz[-2:]).all() and np.isnan(tsr[-2:]).all() and np.isfinite(taz[:-2]).all()
    np.testing.assert_allclose(taz[:-2], jaz[:-2], rtol=0, atol=1e-9)
    np.testing.assert_allclose(tsr[:-2], jsr[:-2], rtol=1e-12)
    np.testing.assert_allclose(tpos[:-2], jpos[:-2], rtol=0, atol=1e-6)


@pytest.mark.parametrize('ht', [0.0, 1800.0])
def test_build_ray_matches_jax(orbits, ht):
    j, t = orbits
    zs = np.concatenate([np.arange(-500.0, 3000.0, 250.0), np.arange(3000.0, 10000.0, 500.0),
                         np.arange(10000.0, 30001.0, 1000.0)])
    rng = np.random.default_rng(5)
    lats, lons = rng.uniform(33.0, 34.0, 40), rng.uniform(-118.5, -117.0, 40)
    x, y, z = (np.asarray(v) for v in j_ell.lla2ecef(lats, lons, np.full(40, ht)))
    xyz = np.stack([x, y, z], -1)
    _, sr, sat, _ = (np.asarray(v) for v in j_orbit.geo2rdr(j.times, j.pos, j.vel, xyz))
    look = (sat - xyz) / sr[:, None]
    jl, jlo, jhi = j_rays.build_ray(zs, ht, xyz, look, 29999.0)
    tl, tlo, thi = t_rays.build_ray(zs, ht, torch.as_tensor(xyz), torch.as_tensor(look), 29999.0)
    np.testing.assert_allclose(tl.numpy(), jl, rtol=0, atol=1e-6)
    np.testing.assert_allclose(tlo.numpy(), jlo, rtol=0, atol=1e-6)
    np.testing.assert_allclose(thi.numpy(), jhi, rtol=0, atol=1e-6)


@pytest.mark.parametrize('ht', [-600.0, 0.0, 1234.5, 29990.0, 31000.0])
def test_level_chains_match_jax(ht):
    zs = np.concatenate([np.arange(-500.0, 3000.0, 250.0), np.arange(3000.0, 30001.0, 1000.0)])
    for fn in ('level_heights', 'clip_chain'):
        a = getattr(t_rays, fn)(zs, ht, 29999.0)
        b = getattr(j_rays, fn)(zs, ht, 29999.0)
        assert (a is None) == (b is None)
        if a is not None:
            np.testing.assert_array_equal(a, b)
