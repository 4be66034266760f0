"""Every table mode of the raytrace integrate: raider_tpu_torch vs the JAX package (CPU).

  * ``_quantize_i16`` is bit-exact against JAX (raw int16 cube, scale and
    offset), NaN/inf cells, a constant field and a float64 cube included;
  * the pack16 / pack4 tables and the int16 tables of pack16_i16 and
    brick_i16 (with their deq) are exact against JAX;
  * ``integrate_rays`` in each mode (the packed modes go through
    ``_integrate_packed``) matches JAX at rtol 2e-6 with equal NaN masks;
  * ``integrate_bricks_ref`` with deq matches ``_integrate_bricks(deq=...)``
    and the Pallas kernel with ``has_deq`` in interpret mode;
  * ``pack_mode_for`` gives JAX's answer on the headline, midcube, bigcube
    and float64 shapes and at the capacity-band edges;
  * the engine's ``_build_cube_ray`` with each non-brick mode forced (byte
    limits monkeypatched in both packages) matches the JAX engine to 1e-5 m.
"""

import datetime as dt

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from raider_tpu.delay import engine as j_engine
from raider_tpu.delay import raytrace as j_rt
from raider_tpu.geodesy.crs import Geographic as JGeographic
from raider_tpu.geometry.los import Raytracing as JRay
from raider_tpu.geometry.rays import level_heights
from raider_tpu_torch.convert import dataset_from_reference, orbit_from_reference
from raider_tpu_torch.delay import engine as t_engine
from raider_tpu_torch.delay import raytrace as t_rt
from raider_tpu_torch.geodesy import Geographic
from raider_tpu_torch.geometry import Raytracing

from test_brick_kernel import contiguous_rays
from tests.test_orbit import synthetic_orbit
from tests.test_raytrace import synthetic_wm_dataset

YS = np.arange(33.0, 34.01, 0.1)
XS = np.arange(-118.0, -116.99, 0.1)
RTOL = 2e-6
MODES = ('pack16', 'pack16_i16', 'pack4', 'brick', 'brick_i16')


def _cubes(seed, shape, dtype=np.float32):
    rng = np.random.default_rng(seed)
    return (rng.uniform(0.1, 100.0, shape).astype(dtype),
            rng.uniform(50.0, 300.0, shape).astype(dtype))


def _quant_case(case):
    rng = np.random.default_rng(7)
    if case == 'constant':
        return np.full((4, 5, 6), 7.25, np.float32)
    cube = rng.uniform(0.1, 100.0, (9, 6, 5))
    if case == 'float64':
        return cube
    cube = cube.astype(np.float32)
    if case == 'nan_cells':
        cube[1, 2, 3] = np.nan
        cube[2, 2, 2] = np.inf
        cube[3, 0, 0] = -np.inf
    elif case == 'all_nan':
        cube[:] = np.nan
    return cube


@pytest.mark.parametrize('case', ['random', 'nan_cells', 'constant', 'float64', 'all_nan'])
def test_quantize_i16_bit_exact(case):
    cube = _quant_case(case)
    j_raw, j_sc, j_of = (np.asarray(a) for a in j_rt._quantize_i16(jnp.asarray(cube)))
    t_raw, t_sc, t_of = (a.numpy() for a in t_rt._quantize_i16(torch.as_tensor(cube)))
    assert t_raw.dtype == np.int16 and t_sc.dtype == t_of.dtype == np.float32
    np.testing.assert_array_equal(t_raw, j_raw)
    np.testing.assert_array_equal(t_sc, j_sc)
    np.testing.assert_array_equal(t_of, j_of)
    if case == 'constant':
        assert (t_raw == 0).all()
    if case in ('nan_cells', 'all_nan'):
        assert ((t_raw == t_rt._I16_NAN) == ~np.isfinite(cube)).all()


@pytest.mark.parametrize('mode, dtype', [(m, np.float32) for m in MODES]
                         + [(m, np.float64) for m in MODES if not m.endswith('i16')])
def test_tables_exact(mode, dtype):
    wet, hyd = _cubes(1, (9, 6, 5), dtype)
    j_tab, _ = j_rt.pack_cubes(wet, hyd, mode=mode)
    t_tab, t_mode = t_rt.pack_cubes(torch.as_tensor(wet), torch.as_tensor(hyd), mode=mode)
    assert t_mode == mode
    if mode.endswith('i16'):
        (j_tab, j_deq), (t_tab, t_deq) = j_tab, t_tab
        np.testing.assert_array_equal(t_deq.numpy(), np.asarray(j_deq))
        assert t_tab.dtype == torch.int16
    np.testing.assert_array_equal(t_tab.numpy(), np.asarray(j_tab))


def _mutate_bad(bnd_y, bnd_x, bnd_z, ray_len):
    bnd_y[:, 7] = np.nan
    bnd_x[:, 11] += 30.0
    ray_len[:, 13] = np.nan


@pytest.mark.parametrize('mode', MODES)
@pytest.mark.parametrize('bad_rays', [False, True])
def test_integrate_rays_matches_jax(mode, bad_rays):
    zs = -500.0 + 26500.0 * np.linspace(0.0, 1.0, 30) ** 1.4
    heights = level_heights(zs, 0.0, 25000.0)
    wet, hyd = _cubes(2, (zs.size, YS.size, XS.size))
    rng = np.random.default_rng(3)
    bnd_y, bnd_x, bnd_z, d2, ray_len, hstep = contiguous_rays(heights, 300, rng)
    if bad_rays:
        _mutate_bad(bnd_y, bnd_x, bnd_z, ray_len)
    rays = [a.astype(np.float32) for a in (bnd_y, bnd_x, bnd_z, d2, ray_len,
                                           np.full(300, 6371000.0))]
    plm = np.nanmax(ray_len, axis=1)
    j_tab, _ = j_rt.pack_cubes(wet, hyd, mode=mode)
    jw, jh = j_rt.integrate_rays(wet, hyd, YS, XS, zs, *rays, plm, packed2d=j_tab, mode=mode,
                                 heights=heights, hstep_max=hstep)
    t_tab, _ = t_rt.pack_cubes(torch.as_tensor(wet), torch.as_tensor(hyd), mode=mode)
    tw, th = t_rt.integrate_rays(torch.as_tensor(wet), torch.as_tensor(hyd), YS, XS, zs,
                                 *[torch.as_tensor(a) for a in rays], plm, packed2d=t_tab,
                                 mode=mode, heights=heights, hstep_max=hstep)
    for a, b in ((tw.numpy(), np.asarray(jw)), (th.numpy(), np.asarray(jh))):
        np.testing.assert_array_equal(np.isnan(a), np.isnan(b))
        np.testing.assert_allclose(a, b, rtol=RTOL, equal_nan=True)
    share = np.isnan(tw.numpy()).mean()
    assert (0 < share < 0.1) if bad_rays else share < 0.05


def test_integrate_bricks_deq_matches_jax():
    """The brick_i16 twin against the JAX traced integrate and the Pallas
    kernel with has_deq (interpret mode), on a regular chain whose samples
    sit away from cell boundaries (the Pallas window test has a 1e-4 band)."""
    zs = np.arange(-500.0, 8001.0, 1000.0)
    heights = level_heights(zs, 0.0, 7500.0)
    wet, hyd = _cubes(4, (zs.size, YS.size, XS.size))
    rng = np.random.default_rng(5)
    bnd_y, bnd_x, bnd_z, d2, ray_len, hstep = contiguous_rays(heights, 128, rng)
    rays = [a.astype(np.float32) for a in (bnd_y, bnd_x, bnd_z, d2, ray_len,
                                           np.full(128, 6371000.0))]
    plm = np.nanmax(ray_len, axis=1)
    (j_tab, j_deq), _ = j_rt.pack_cubes(wet, hyd, mode='brick_i16')
    (t_tab, t_deq), _ = t_rt.pack_cubes(torch.as_tensor(wet), torch.as_tensor(hyd),
                                        mode='brick_i16')
    j_plan = j_rt._pad_group_plan(j_rt.build_group_plan(plm, heights, hstep, YS, XS, zs),
                                  j_rt._PLAN_BUCKET)
    t_plan = t_rt._pad_group_plan(t_rt.build_group_plan(plm, heights, hstep, YS, XS, zs),
                                  t_rt._PLAN_BUCKET)
    axes = dict(ys=tuple(YS.tolist()), xs=tuple(XS.tolist()), zs=tuple(zs.tolist()))
    traced = j_rt._integrate_bricks(
        j_tab, *[jnp.asarray(a) for a in rays],
        *[getattr(j_plan, k) for k in ('anchor', 'lvl', 'frac', 'wa_lvl', 'wa', 'wb_lvl', 'wb',
                                        'dzoff', 'zlo', 'zinv', 'pad')],
        **axes, z_clip=True, G=j_plan.G, planes=j_plan.planes, wy=j_plan.wy, wx=j_plan.wx,
        deq=j_deq)
    groups, planes, wy, wx = j_rt.static_plan_from(j_plan)
    pallas = j_rt._static_brick_pallas_fn(groups, planes, wy, wx, axes['ys'], axes['xs'],
                                          axes['zs'], True, interpret=True, has_deq=True)(
        j_tab, *[jnp.asarray(a) for a in rays], j_deq)
    tw, th = t_rt.integrate_bricks_ref(t_tab, *[torch.as_tensor(a) for a in rays], t_plan,
                                       YS, XS, zs, deq=t_deq)
    assert np.isfinite(tw.numpy()).all()
    for ref in (traced, pallas):
        for a, b in ((tw.numpy(), np.asarray(ref[0])), (th.numpy(), np.asarray(ref[1]))):
            np.testing.assert_allclose(a, b, rtol=RTOL)


def _edge(cells):
    return (1, 1, int(cells))


# the capacity band's edges at the (7,3,3,6) spec: rows pad to 128 values
F32_BRICK_EDGE = 6 * 1024**3 // (128 * 4)
I16_BRICK_EDGE = 6 * 1024**3 // (128 * 2)
SHAPES = {
    'headline': (50, 400, 400), 'engine_cube': (51, 400, 400), 'midcube': (50, 640, 640),
    'bigcube': (50, 1059, 1799), 'f32_brick_edge': _edge(F32_BRICK_EDGE),
    'past_f32_brick_edge': _edge(F32_BRICK_EDGE + 1), 'i16_brick_edge': _edge(I16_BRICK_EDGE),
    'past_i16_brick_edge': _edge(I16_BRICK_EDGE + 1),
    'pack16_edge': _edge(3 * 1024**3 // 64 + 1), 'pack16_i16_edge': _edge(6 * 1024**3 // 32 + 1),
}


@pytest.mark.parametrize('name', list(SHAPES))
@pytest.mark.parametrize('dtype', [np.float32, np.float64])
@pytest.mark.parametrize('grouped', [True, False])
def test_pack_mode_for_matches_jax(monkeypatch, name, dtype, grouped):
    monkeypatch.delenv('RAIDER_TPU_BRICK_I16', raising=False)
    shape = SHAPES[name]
    assert (t_rt.pack_mode_for(shape, dtype, grouped=grouped)
            == j_rt.pack_mode_for(shape, dtype, grouped=grouped))


def test_pack_mode_ladder_answers():
    assert t_rt.pack_mode_for(SHAPES['headline'], np.float32, grouped=True) == 'brick'
    assert t_rt.pack_mode_for(SHAPES['midcube'], np.float32, grouped=True) == 'brick_i16'
    assert t_rt.pack_mode_for(SHAPES['bigcube'], np.float32, grouped=True) == 'pack16_i16'
    assert t_rt.pack_mode_for(SHAPES['midcube'], np.float64, grouped=True) == 'pack16'
    assert t_rt.pack_mode_for(SHAPES['bigcube'], np.float64, grouped=True) == 'pack4'


# (brick spec limit, pack16 limit, pack16_i16 limit) that force each mode on
# the 49x13x17 synthetic cube: f32 brick 5.4 MB, int16 brick 2.7 MB,
# f32 pack16 0.7 MB, int16 pack16 0.35 MB
FORCED = {'brick_i16': (4 * 2**20, None, None), 'pack16': (0, None, None),
          'pack16_i16': (0, 0, None), 'pack4': (0, 0, 0)}


@pytest.mark.parametrize('mode', list(FORCED))
def test_build_cube_ray_forced_modes_match_jax(monkeypatch, mode):
    brick_limit, p16, p16i = FORCED[mode]
    monkeypatch.delenv('RAIDER_TPU_BRICK_I16', raising=False)
    for mod in (j_rt, t_rt):
        monkeypatch.setattr(mod, '_BRICK_SPECS', ((7, 3, 3, 6, brick_limit),))
        if p16 is not None:
            monkeypatch.setattr(mod, '_PACK16_BYTE_LIMIT', p16)
        if p16i is not None:
            monkeypatch.setattr(mod, '_PACK16_I16_BYTE_LIMIT', p16i)
    shape = (49, 13, 17)
    assert t_rt.pack_mode_for(shape, np.float32, grouped=True) == mode
    assert j_rt.pack_mode_for(shape, np.float32, grouped=True) == mode
    rng = np.random.default_rng(11)
    wet_c, hydro_c = rng.uniform(0.1, 100.0, shape), rng.uniform(50.0, 300.0, shape)
    ds = synthetic_wm_dataset(wet_cube=wet_c, hydro_cube=hydro_c)
    t = dt.datetime(2020, 1, 30, 13, 52, 45)
    orbit = synthetic_orbit(t)
    xpts = np.linspace(-118.4, -117.2, 8)
    ypts = np.linspace(33.2, 33.8, 7)
    zpts = np.array([0.0, 2000.0])
    jw, jh = j_engine._build_cube_ray(j_engine.WeatherCube(ds), xpts, ypts, zpts,
                                      JRay(orbit=orbit, time=t), JGeographic(), zref=25000.0,
                                      compute_dtype=np.float32)
    tw, th = t_engine._build_cube_ray(t_engine.WeatherCube(dataset_from_reference(ds), 'cpu'),
                                      xpts, ypts, zpts,
                                      Raytracing(orbit=orbit_from_reference(orbit), time=t),
                                      Geographic(), zref=25000.0, compute_dtype=torch.float32)
    for a, b in ((tw, np.asarray(jw)), (th, np.asarray(jh))):
        np.testing.assert_array_equal(np.isnan(a), np.isnan(b))
        assert np.isfinite(a).mean() > 0.9
        assert np.nanmax(np.abs(a - b)) <= 1e-5
