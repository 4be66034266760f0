"""Projected CRSs: raider_tpu_torch.geodesy.crs vs raider_tpu.geodesy.crs (CPU).

Lambert conformal conic, polar stereographic and transverse Mercator/UTM,
forward and inverse on 10^4 seeded points in float64, the CF and WKT round
trips, and transform_points between each pair.

Tolerances: inverse longitudes and latitudes 1e-12 deg. Forward x/y
4e-9 m: the terms that make a projected coordinate reach 4e6-8e6 m (rho of
the cones, the meridian arc), where one rounding is 9.3e-10 m, and the two
libms (XLA's on the CPU, glibc's under torch) differ by an ulp or two in
each. The transverse Mercator forward is held to 1e-7 m against JAX, whose
CPU ``arctanh`` is off by up to 1.6e-14 relative near |x| -> 1 (glibc's by
2.2e-16), and to 4e-9 m against the same series evaluated in numpy
float64. transform_points between two projections chains an inverse with
a forward: 2e-8 m (the inverses agree to ~1e-13 deg, ~1e-8 m on the
ground), and 1e-7 m when either end is transverse Mercator (its inverse
also calls JAX's ``arctanh``: 3.8e-13 deg).
"""

import numpy as np
import pytest
import torch

from raider_tpu.geodesy import crs as J
from raider_tpu_torch.convert import crs_from_reference
from raider_tpu_torch.geodesy import crs as T

XY_TOL = 4e-9
CHAIN_TOL = 2e-8
DEG_TOL = 1e-12
N = 10_000


def _pairs():
    """(name, JAX CRS, port CRS, lon range, lat range)."""
    out = []
    for name, j, box in [
        ('lcc_hrrr', J.LambertConformalConic(lat_0=38.5, lon_0=262.5, lat_1=38.5, lat_2=38.5,
                                             ellipsoid=J.SPHERE_6371229), (-135, -60, 20, 55)),
        ('lcc_2sp_wgs84', J.LambertConformalConic(lat_0=33.5, lon_0=-117.5, lat_1=30.0,
                                                  lat_2=60.0, x_0=1e5, y_0=-2e5),
         (-130, -100, 20, 50)),
        ('ps_hrrr_ak', J.PolarStereographic(lat_0=90.0, lon_0=225.0, lat_ts=60.0,
                                            ellipsoid=J.SPHERE_6371229), (-180, 180, 40, 85)),
        ('ps_south_k0', J.PolarStereographic(lat_0=-90.0, lon_0=0.0, k0=0.994),
         (-180, 180, -85, -50)),
        ('utm_11n', J.utm_crs(11), (-120, -114, 20, 50)),
        ('utm_23s', J.utm_crs(23, south=True), (-48, -42, -30, -1)),
        ('tm_lat0', J.TransverseMercator(lon_0=-3.0, lat_0=49.0, k0=0.9996012717, x_0=4e5,
                                         y_0=-1e5), (-8, 2, 49, 61)),
    ]:
        t = crs_from_reference(j)
        if j.utm_zone if isinstance(j, J.TransverseMercator) else False:
            t = T.utm_crs(j.utm_zone, south=j.utm_south)   # CF carries no zone number
        out.append((name, j, t, box))
    return out


PAIRS = _pairs()
IDS = [p[0] for p in PAIRS]


def _points(box, seed=0):
    rng = np.random.default_rng(seed)
    w, e, s, n = box
    return rng.uniform(w, e, N), rng.uniform(s, n, N)


def _tm_forward_np(c, lon, lat):
    """The port's transverse Mercator series in numpy float64 (glibc)."""
    ell = c.ellipsoid
    alpha, _, a_cap = T._tm_series(ell.f / (2.0 - ell.f))
    e = ell.e
    lat_r, lon_r = np.deg2rad(lat), np.deg2rad(lon - c.lon_0)
    s = np.sin(lat_r)
    t = np.sinh(np.arctanh(s) - e * np.arctanh(e * s))
    xi_p = np.arctan2(t, np.cos(lon_r))
    eta_p = np.arcsinh(np.sin(lon_r) / np.sqrt(t * t + np.cos(lon_r) ** 2))
    xi, eta = xi_p, eta_p
    for j in range(6):
        xi = xi + alpha[j] * np.sin(2 * (j + 1) * xi_p) * np.cosh(2 * (j + 1) * eta_p)
        eta = eta + alpha[j] * np.cos(2 * (j + 1) * xi_p) * np.sinh(2 * (j + 1) * eta_p)
    big_a = a_cap * ell.a
    y = c.k0 * big_a * xi + c.y_0
    if c.lat_0 != 0.0:
        y = y - c.k0 * big_a * c._xi_of_lat0()
    return c.k0 * big_a * eta + c.x_0, y


@pytest.mark.parametrize('name,j,t,box', PAIRS, ids=IDS)
def test_forward_inverse_match_jax(name, j, t, box):
    lon, lat = _points(box)
    jx, jy = (np.asarray(v) for v in j.forward(lon, lat))
    tx, ty = t.forward(torch.as_tensor(lon), torch.as_tensor(lat))
    assert tx.dtype == torch.float64 and tx.device.type == 'cpu'
    tx, ty = tx.numpy(), ty.numpy()
    if isinstance(t, T.TransverseMercator):
        nx, ny = _tm_forward_np(t, lon, lat)
        np.testing.assert_allclose(tx, nx, rtol=0, atol=XY_TOL)
        np.testing.assert_allclose(ty, ny, rtol=0, atol=XY_TOL)
        fwd_tol = 1e-7
    else:
        fwd_tol = XY_TOL
    np.testing.assert_allclose(tx, jx, rtol=0, atol=fwd_tol)
    np.testing.assert_allclose(ty, jy, rtol=0, atol=fwd_tol)

    jl, jb = (np.asarray(v) for v in j.inverse(jx, jy))
    tl, tb = (v.numpy() for v in t.inverse(jx, jy))
    np.testing.assert_allclose(tl, jl, rtol=0, atol=DEG_TOL)
    np.testing.assert_allclose(tb, jb, rtol=0, atol=DEG_TOL)
    assert (tl >= -180.0).all() and (tl < 180.0).all()
    np.testing.assert_allclose(np.mod(tl - lon + 180.0, 360.0) - 180.0, 0.0, atol=1e-8)
    np.testing.assert_allclose(tb, lat, atol=1e-8)


@pytest.mark.parametrize('name,j,t,box', PAIRS, ids=IDS)
def test_cf_and_wkt_round_trips(name, j, t, box):
    assert t.to_cf() == j.to_cf()
    assert T.crs_from_cf(t.to_cf()).to_cf() == j.to_cf()
    assert t.to_wkt() == j.to_wkt()
    assert T.crs_from_wkt(t.to_wkt()).to_cf() == J.crs_from_wkt(j.to_wkt()).to_cf()
    assert T.crs_from_user(t.to_wkt()) == T.crs_from_wkt(t.to_wkt())
    # forward through the CF round trip is bit-exact
    lon, lat = _points(box, seed=1)
    back = T.crs_from_cf(t.to_cf())
    for a, b in zip(t.forward(lon, lat), back.forward(lon, lat)):
        assert torch.equal(a, b)


TRANSFORMS = [  # (source, destination, source points' lon/lat box)
    ('lcc_hrrr', 'lcc_2sp_wgs84', (-125, -100, 25, 50)),
    ('lcc_2sp_wgs84', 'lcc_hrrr', (-125, -100, 25, 50)),
    ('lcc_hrrr', 'utm_11n', (-121, -113, 25, 50)),
    ('utm_11n', 'lcc_hrrr', (-120, -114, 20, 50)),
    ('ps_hrrr_ak', 'lcc_hrrr', (-170, -130, 50, 70)),
    ('utm_23s', 'ps_south_k0', (-48, -42, -60, -50)),
    ('tm_lat0', 'ps_hrrr_ak', (-8, 2, 49, 61)),
]


@pytest.mark.parametrize('src,dst,box', TRANSFORMS, ids=[f'{a}-{b}' for a, b, _ in TRANSFORMS])
def test_transform_points_between_pairs(src, dst, box):
    crs = {name: (j, t) for name, j, t, _ in PAIRS}
    (js, ts), (jd, td) = crs[src], crs[dst]
    lon, lat = _points(box, seed=4)
    x, y = (np.asarray(v) for v in js.forward(lon, lat))
    ref = [np.asarray(v) for v in J.transform_points(js, jd, x, y)]
    out = [v.numpy() for v in T.transform_points(ts, td, x, y)]
    tm = isinstance(td, T.TransverseMercator) or isinstance(ts, T.TransverseMercator)
    tol = 1e-7 if tm else CHAIN_TOL
    for a, b in zip(out, ref):
        np.testing.assert_allclose(a, b, rtol=0, atol=tol)


@pytest.mark.parametrize('name,j,t,box', PAIRS, ids=IDS)
def test_geographic_and_geocentric_legs(name, j, t, box):
    lon, lat = _points(box, seed=2)
    h = np.random.default_rng(3).uniform(-100.0, 9000.0, N)
    x, y = (np.asarray(v) for v in j.forward(lon, lat))
    for jdst, tdst in ((J.Geographic(), T.Geographic()), (J.Geocentric(), T.Geocentric())):
        ref = [np.asarray(v) for v in J.transform_points(j, jdst, x, y, h)]
        out = [np.asarray(v) for v in T.transform_points(t, tdst, x, y, h)]
        tol = DEG_TOL if tdst.is_geographic else 1e-6
        for a, b in zip(out, ref):
            np.testing.assert_allclose(a, b, rtol=0, atol=tol)


@pytest.mark.parametrize('value', [
    32611, 'EPSG:32723', 32601, 32760,
    {'grid_mapping_name': 'lambert_conformal_conic'},
    {'grid_mapping_name': 'lambert_conformal_conic', 'standard_parallel': [30.0, 60.0],
     'longitude_of_central_meridian': -97.0, 'latitude_of_projection_origin': 40.0,
     'earth_radius': 6370000.0},
    {'grid_mapping_name': 'polar_stereographic'},
    {'grid_mapping_name': 'polar_stereographic', 'straight_vertical_longitude_from_pole': 225.0,
     'latitude_of_projection_origin': 90.0, 'standard_parallel': 60.0,
     'earth_radius': 6371229.0},
    {'grid_mapping_name': 'transverse_mercator', 'longitude_of_central_meridian': 9.0,
     'scale_factor_at_central_meridian': 0.9996, 'false_easting': 500000.0},
    {'crs_wkt': J.utm_crs(33).to_wkt()},
], ids=lambda v: str(v)[:40])
def test_crs_from_user_parses_what_jax_parses(value):
    """EPSG 326xx/327xx, the three CF grid mappings and WKT: the values the
    port once refused now give the JAX package's CRS."""
    out, ref = T.crs_from_user(value), J.crs_from_user(value)
    assert type(out).__name__ == type(ref).__name__
    assert out.to_cf() == ref.to_cf()
    assert out.to_epsg() == ref.to_epsg()


def test_edge_cases_match_jax():
    """lon_0 far from 0 (HRRR 262.5, HRRR-AK 225), the polar-stereographic
    antimeridian and pole, the LCC cone cut (lon_0 - 180 = 82.5)."""
    lcc = crs_from_reference(J.LambertConformalConic(lat_0=38.5, lon_0=262.5, lat_1=38.5,
                                                     lat_2=38.5, ellipsoid=J.SPHERE_6371229))
    ps = crs_from_reference(J.PolarStereographic(lat_0=90.0, lon_0=225.0, lat_ts=60.0,
                                                 ellipsoid=J.SPHERE_6371229))
    jl = J.crs_from_cf(lcc.to_cf())
    jp = J.crs_from_cf(ps.to_cf())
    lons = np.array([82.4, 82.6, -277.6, 179.999, -179.999, 180.0, -180.0, 10.0])
    lats = np.array([38.5, 38.5, 38.5, 65.0, 65.0, 65.0, 65.0, 90.0])
    for j, t in ((jl, lcc), (jp, ps)):
        jx, jy = (np.asarray(v) for v in j.forward(lons, lats))
        tx, ty = (v.numpy() for v in t.forward(lons, lats))
        np.testing.assert_allclose(tx, jx, rtol=0, atol=XY_TOL)
        np.testing.assert_allclose(ty, jy, rtol=0, atol=XY_TOL)
        a = [np.asarray(v) for v in j.inverse(jx, jy)]
        b = [v.numpy() for v in t.inverse(jx, jy)]
        np.testing.assert_allclose(b[0], a[0], rtol=0, atol=1e-10)
        np.testing.assert_allclose(b[1], a[1], rtol=0, atol=DEG_TOL)
        assert ((b[0] >= -180.0) & (b[0] < 180.0)).all()
    # polar-stereographic forward is continuous across the antimeridian
    xw, yw = (float(v) for v in ps.forward(179.999, 65.0))
    xe, ye = (float(v) for v in ps.forward(-179.999, 65.0))
    assert np.hypot(xw - xe, yw - ye) < 300.0
    # the pole maps to the origin and back to latitude 90
    lon2, lat2 = (float(v) for v in ps.inverse(0.0, 0.0))
    assert abs(lat2 - 90.0) < 1e-9 and -180.0 <= lon2 < 180.0


def test_utm_south_round_trip_and_epsg():
    crs = T.crs_from_epsg(32723)
    assert crs == T.utm_crs(23, south=True) and crs.to_epsg() == 32723
    rng = np.random.default_rng(5)
    lon, lat = rng.uniform(-45.0, -39.0, 200), rng.uniform(-6.0, -1.0, 200)
    x, y = crs.forward(lon, lat)
    assert bool(((y > 0) & (y < 1e7)).all())
    lon2, lat2 = crs.inverse(x, y)
    np.testing.assert_allclose(lon2.numpy(), lon, atol=1e-9)
    np.testing.assert_allclose(lat2.numpy(), lat, atol=1e-9)
    with pytest.raises(ValueError):
        T.utm_crs(61)
