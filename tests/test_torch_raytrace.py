"""Brick integrate: raider_tpu_torch.delay.raytrace vs the JAX package (CPU).

  * the brick table is bit-equal to the JAX ``_pack_bricks``;
  * the grouped plan is the JAX plan, array for array;
  * ``integrate_bricks_ref`` matches the JAX ``_integrate_bricks`` on the
    same plan to rtol 1e-5 (float32; 1e-12 in float64) with identical NaN
    masks, including rays that leave the grid and a forced window
    violation (a motion bound too small for the rays);
  * one small case matches the Pallas kernel in interpret mode, away from
    cell boundaries (its window test has a 1e-4 band);
  * constant refractivity closes: delay = N * 1e-6 * ray length to 1e-6.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from raider_tpu.delay import raytrace as j_rt
from raider_tpu.geometry.rays import clip_chain, level_heights
from raider_tpu_torch.delay import raytrace as t_rt

from test_brick_kernel import contiguous_rays

YS = np.arange(33.0, 34.01, 0.1)
XS = np.arange(-118.0, -116.99, 0.1)
RTOL = {np.float32: 1e-5, np.float64: 1e-12}
PLAN_KEYS = ('anchor', 'pad', 'lvl', 'frac', 'wa_lvl', 'wa', 'wb_lvl', 'wb', 'dzoff', 'zlo', 'zinv')


def _scene(zs, heights, dtype, seed=0, n_rays=257, mutate=None):
    rng = np.random.default_rng(seed)
    wet = rng.uniform(0.5, 2.0, (zs.size, YS.size, XS.size)).astype(dtype)
    hydro = rng.uniform(1.0, 4.0, (zs.size, YS.size, XS.size)).astype(dtype)
    bnd_y, bnd_x, bnd_z, d2, ray_len, hstep_max = contiguous_rays(heights, n_rays, rng)
    if mutate is not None:
        mutate(bnd_y, bnd_x, bnd_z, ray_len)
    re = np.full(n_rays, 6371000.0)
    rays = [a.astype(dtype) for a in (bnd_y, bnd_x, bnd_z, d2, ray_len, re)]
    return wet, hydro, rays, np.nanmax(ray_len, axis=1), hstep_max


def _mutate_bad(bnd_y, bnd_x, bnd_z, ray_len):
    bnd_y[:, 7] = np.nan
    bnd_x[:, 11] += 30.0
    ray_len[:, 13] = np.nan


def _mutate_fast(bnd_y, bnd_x, bnd_z, ray_len):
    # the first 60 rays move 6x faster than the motion bound the plan is
    # built with: their groups overflow the brick window
    for b in (bnd_y, bnd_x):
        b[:, :60] = b[0, :60] + 6.0 * (b[:, :60] - b[0, :60])


SCENES = {    # level chain, ray mutation
    'regular': (lambda zs: level_heights(zs, 0.0, 9000.0), None),
    'clip_chain': (lambda zs: clip_chain(zs, 1200.0, 8600.0), None),
    'bad_rays': (lambda zs: clip_chain(zs, 0.0, 9000.0), _mutate_bad),
    'window': (lambda zs: level_heights(zs, 0.0, 3000.0), _mutate_fast),
}


@pytest.mark.parametrize('dtype', [np.float32, np.float64])
def test_pack_bricks_bit_equal(dtype):
    rng = np.random.default_rng(1)
    wet = rng.uniform(0.5, 2.0, (9, 6, 5)).astype(dtype)
    hyd = rng.uniform(1.0, 4.0, (9, 6, 5)).astype(dtype)
    ref = np.asarray(j_rt._pack_bricks(jnp.asarray(wet), jnp.asarray(hyd), 7, 3, 3))
    out, mode = t_rt.pack_cubes(torch.as_tensor(wet), torch.as_tensor(hyd), grouped=True)
    assert mode == 'brick'
    np.testing.assert_array_equal(out.numpy(), ref)


@pytest.mark.parametrize('scene', list(SCENES))
@pytest.mark.parametrize('dtype', [np.float32, np.float64])
def test_twin_matches_integrate_bricks(scene, dtype):
    zs = np.arange(-500.0, 10001.0, 500.0)
    chain, mutate = SCENES[scene]
    heights = chain(zs)
    wet, hydro, rays, plm, hstep = _scene(zs, heights, dtype, mutate=mutate)
    spec = j_rt._brick_spec_for(wet.shape, dtype)
    j_plan = j_rt.build_group_plan(plm, heights, hstep, YS, XS, zs, group_max=spec[3],
                                   planes=spec[0], wy=spec[1], wx=spec[2])
    t_plan = t_rt.build_group_plan(plm, heights, hstep, YS, XS, zs, group_max=spec[3],
                                   planes=spec[0], wy=spec[1], wx=spec[2])
    for k in PLAN_KEYS:
        np.testing.assert_array_equal(getattr(t_plan, k), getattr(j_plan, k))
    j_table = j_rt._pack_bricks(jnp.asarray(wet), jnp.asarray(hydro), *spec[:3])
    jw, jh = j_rt._integrate_bricks(
        j_table, *[jnp.asarray(a) for a in rays], *[getattr(j_plan, k) for k in PLAN_KEYS[:1]],
        *[getattr(j_plan, k) for k in ('lvl', 'frac', 'wa_lvl', 'wa', 'wb_lvl', 'wb', 'dzoff',
                                        'zlo', 'zinv', 'pad')],
        ys=tuple(YS.tolist()), xs=tuple(XS.tolist()), zs=tuple(zs.tolist()), z_clip=True,
        G=j_plan.G, planes=j_plan.planes, wy=j_plan.wy, wx=j_plan.wx)
    t_table, _ = t_rt.pack_cubes(torch.as_tensor(wet), torch.as_tensor(hydro), grouped=True)
    tw, th = t_rt.integrate_bricks_ref(t_table, *[torch.as_tensor(a) for a in rays], t_plan,
                                       YS, XS, zs)
    for a, b in ((tw.numpy(), np.asarray(jw)), (th.numpy(), np.asarray(jh))):
        np.testing.assert_array_equal(np.isnan(a), np.isnan(b))
        np.testing.assert_allclose(a, b, rtol=RTOL[dtype], equal_nan=True)
    nan_share = np.isnan(tw.numpy()).mean()
    if scene in ('bad_rays', 'window'):
        assert 0 < nan_share < 1
    else:
        assert nan_share == 0


def test_twin_matches_pallas_interpret():
    """The static Pallas kernel (interpret mode), a regular chain whose
    samples sit away from cell boundaries."""
    zs = np.arange(-500.0, 8001.0, 1000.0)
    heights = level_heights(zs, 0.0, 7500.0)
    wet, hydro, rays, plm, hstep = _scene(zs, heights, np.float32, n_rays=128)
    plan = j_rt.build_group_plan(plm, heights, hstep, YS, XS, zs)
    groups, planes, wy, wx = j_rt.static_plan_from(plan)
    fn = j_rt._static_brick_pallas_fn(groups, planes, wy, wx, tuple(YS.tolist()),
                                      tuple(XS.tolist()), tuple(zs.tolist()), True,
                                      interpret=True)
    j_table = j_rt._pack_bricks(jnp.asarray(wet), jnp.asarray(hydro), planes, wy, wx)
    jw, jh = fn(j_table, *[jnp.asarray(a) for a in rays])
    t_table, _ = t_rt.pack_cubes(torch.as_tensor(wet), torch.as_tensor(hydro), grouped=True)
    t_plan = t_rt.build_group_plan(plm, heights, hstep, YS, XS, zs)
    tw, th = t_rt.integrate_bricks_ref(t_table, *[torch.as_tensor(a) for a in rays], t_plan,
                                       YS, XS, zs)
    assert np.isfinite(tw.numpy()).all()
    np.testing.assert_allclose(tw.numpy(), np.asarray(jw), rtol=2e-5)
    np.testing.assert_allclose(th.numpy(), np.asarray(jh), rtol=2e-5)


@pytest.mark.parametrize('dtype', [np.float32, np.float64])
def test_constant_refractivity_closure(dtype):
    """Constant N: delay = N * 1e-6 * (sum of segment lengths), to 1e-6."""
    zs = np.arange(-500.0, 10001.0, 500.0)
    heights = level_heights(zs, 0.0, 9000.0)
    _, _, rays, plm, hstep = _scene(zs, heights, dtype)
    shape = (zs.size, YS.size, XS.size)
    wet = torch.full(shape, 1.5, dtype=torch.from_numpy(np.zeros(1, dtype)).dtype)
    hyd = torch.full_like(wet, 2.5)
    w, h = t_rt.integrate_rays(wet, hyd, YS, XS, zs, *[torch.as_tensor(a) for a in rays], plm,
                               heights=heights, hstep_max=hstep)
    length = rays[4].astype(np.float64).sum(0)
    np.testing.assert_allclose(w.numpy(), 1.5e-6 * length, rtol=1e-6)
    np.testing.assert_allclose(h.numpy(), 2.5e-6 * length, rtol=1e-6)


def test_integrate_rays_matches_jax():
    """The slice entry point (plan build, padding, integrate) on both sides."""
    zs = -500.0 + 27000.0 * np.linspace(0.0, 1.0, 18) ** 1.6
    heights = clip_chain(zs, 0.0, 26000.0)
    wet, hydro, rays, plm, hstep = _scene(zs, heights, np.float32, seed=3)
    jw, jh = j_rt.integrate_rays(wet, hydro, YS, XS, zs, *rays, plm, heights=heights,
                                 hstep_max=hstep)
    tw, th = t_rt.integrate_rays(torch.as_tensor(wet), torch.as_tensor(hydro), YS, XS, zs,
                                 *[torch.as_tensor(a) for a in rays], plm, heights=heights,
                                 hstep_max=hstep)
    np.testing.assert_allclose(tw.numpy(), np.asarray(jw), rtol=1e-5)
    np.testing.assert_allclose(th.numpy(), np.asarray(jh), rtol=1e-5)


@pytest.mark.parametrize('mode', ['pack16', 'pack16_i16', 'pack4', 'brick_i16'])
def test_unported_modes_name_the_roadmap(mode):
    """The modes ROADMAP A3 listed as unported now pack (int16 modes with
    their deq); an unknown mode raises."""
    cube = torch.ones((3, 4, 5))
    table, got = t_rt.pack_cubes(cube, cube, mode=mode)
    assert got == mode
    if mode.endswith('i16'):
        table, deq = table
        assert table.dtype == torch.int16 and tuple(deq.shape) == (4,)
    assert table.shape[0] == cube.numel()
    with pytest.raises(ValueError, match='unknown table mode'):
        t_rt.pack_cubes(cube, cube, mode=mode + '_x')
