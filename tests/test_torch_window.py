"""Windowed integrate: raider_tpu_torch.delay.pallas_window vs the JAX package (CPU).

Every scene of tests/test_pallas_window.py (``make_scene``) goes through the
JAX ``integrate_rays_windowed(..., interpret=True)`` and through the port on
CPU tensors, which run the twin of kernel B3:

  * ``used`` is the same (coherent batches taken; the incoherent batch and
    the non-uniform axis declined; the odd grid and the top-row anchors);
  * NaN masks are equal; wet and hydro agree to rtol 2e-6 in float32. The
    twin rounds every operation to float32 in the Pallas kernel's order;
    XLA on the CPU fuses multiply-adds in the interpret-mode kernel (the
    lerps, the x-blend as a dot over the 256-wide window) and sums the
    (plane, y) mix in its own order: a few float32 ulps per sample, over
    ~40 samples per ray;
  * the pre-pass anchors are identical integers, including values placed
    where a true division, a multiply by float32(1/step) and the JAX
    pre-pass would pick different cells.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from raider_tpu.delay import pallas_window as j_pw
from raider_tpu.delay.raytrace import _PLAN_BUCKET as J_BUCKET
from raider_tpu.delay.raytrace import _pad_group_plan as j_pad_plan
from raider_tpu.delay.raytrace import build_group_plan as j_build_plan
from raider_tpu_torch import kernels
from raider_tpu_torch.delay import pallas_window as t_pw
from raider_tpu_torch.delay import raytrace as t_rt
from raider_tpu_torch.scripts import window_ablation

from tests.test_pallas_window import make_scene
from _window_cases import boundary_points

RTOL = 2e-6


def _nan_oob(sc):
    sc['low'][:, :5, :] = np.nan
    sc['high'][:, :5, :] = np.nan
    sc['ray_len'][:, :5] = np.nan
    sc['low'][:, 7, 1] += 5.0     # out of the grid
    sc['high'][:, 7, 1] += 5.0


def _non_uniform(sc):
    sc['ys'] = np.sort(np.random.default_rng(7).uniform(33.0, 33.64, 64))


SCENES = {   # make_scene arguments, mutation, the JAX package's `used` (None: either)
    'coherent': (dict(), None, True),
    'nan_oob': (dict(), _nan_oob, True),
    'incoherent': (dict(azimuth=0.0, azi_jitter=np.pi, zen=(60.0, 72.0)), None, False),
    'non_uniform': (dict(), _non_uniform, False),
    'odd_grid': (dict(nyo=33, nxo=41), None, True),
    'top_rows': (dict(ny_cube=54, ypix_band=(33.50, 33.52), azimuth=np.pi), None, None),
}
_CACHE = {}


def _plans(sc):
    per_level_max = np.nanmax(sc['ray_len'], axis=1)
    args = (per_level_max, sc['heights'], sc['hstep_max'], sc['ys'], sc['xs'], sc['zs'])
    return (j_pad_plan(j_build_plan(*args), J_BUCKET),
            t_rt._pad_group_plan(t_rt.build_group_plan(*args), t_rt._PLAN_BUCKET))


def _f32(a):
    return np.asarray(a, np.float32)


def scene_run(name):
    """(scene, JAX plan, port plan, JAX result, port result), once per scene."""
    if name not in _CACHE:
        kw, mutate, _ = SCENES[name]
        sc = make_scene(np.random.default_rng(sum(map(ord, name))), **kw)
        if mutate is not None:
            mutate(sc)
        j_plan, t_plan = _plans(sc)
        arrays = [_f32(sc[k]) for k in ('wet', 'hydro')]
        rays = [_f32(sc[k]) for k in ('low', 'high', 'd2', 'ray_len', 're')]
        j = j_pw.integrate_rays_windowed(*arrays, sc['ys'], sc['xs'], sc['zs'], *rays, j_plan,
                                         sc['shape'], interpret=True)
        t = t_pw.integrate_rays_windowed(*[torch.from_numpy(a) for a in arrays],
                                         sc['ys'], sc['xs'], sc['zs'],
                                         *[torch.from_numpy(a) for a in rays], t_plan,
                                         sc['shape'], device='cpu')
        _CACHE[name] = (sc, j_plan, t_plan, j, t)
    return _CACHE[name]


@pytest.mark.parametrize('name', list(SCENES))
def test_windowed_matches_jax(name):
    sc, _, _, (jw, jh, j_used), (tw, th, t_used) = scene_run(name)
    assert t_used is j_used
    if SCENES[name][2] is not None:
        assert j_used is SCENES[name][2]
    if not j_used:
        assert tw is None and th is None
        return
    for a, b in ((tw, jw), (th, jh)):
        a, b = a.numpy(), np.asarray(b)
        assert a.shape == b.shape == (sc['shape'][0] * sc['shape'][1],)
        np.testing.assert_array_equal(np.isnan(a), np.isnan(b))
        np.testing.assert_allclose(a[np.isfinite(b)], b[np.isfinite(b)], rtol=RTOL)
    if name == 'nan_oob':
        assert np.isnan(tw.numpy()[:5]).all() and np.isnan(tw.numpy()[7])
    else:
        assert torch.isfinite(tw).all() and torch.isfinite(th).all()


@pytest.mark.parametrize('shape', [(40, 48), (33, 41), (8, 64), (17, 130)])
def test_tile_order_matches_jax_construction(shape):
    """perm and sel against the JAX wrapper's edge padding and argsort/unique."""
    nyo, nxo = shape
    typ, txp = -(-nyo // 8) * 8, -(-nxo // 64) * 64
    pix = np.pad(np.arange(nyo * nxo).reshape(nyo, nxo), ((0, typ - nyo), (0, txp - nxo)),
                 mode='edge')
    want = pix.reshape(typ // 8, 8, txp // 64, 64).transpose(0, 2, 1, 3).reshape(-1)
    order = np.argsort(want, kind='stable')
    _, first_pos = np.unique(want[order], return_index=True)
    perm, sel = t_pw._tile_order(nyo, nxo, 'cpu')
    np.testing.assert_array_equal(perm.numpy(), want)
    np.testing.assert_array_equal(sel.numpy(), order[first_pos])


def _permuted(sc):
    perm = t_pw._tile_order(*sc['shape'], 'cpu')[0].numpy()
    low, high = _f32(sc['low'])[:, perm], _f32(sc['high'])[:, perm]
    return perm.size // t_pw.TILE, low, high, _f32(sc['d2'])[:, perm], _f32(sc['re'])[perm]


def _anchors_both(low, high, d2, re, j_plan, t_plan, n_tiles, yparams, xparams):
    j = j_pw._window_anchors(*[jnp.asarray(low[..., k]) for k in range(3)],
                             *[jnp.asarray(high[..., k]) for k in range(3)],
                             jnp.asarray(d2), jnp.asarray(re),
                             jnp.asarray(j_plan.lvl, jnp.int32), jnp.asarray(j_plan.frac, jnp.float32),
                             jnp.asarray(j_plan.pad.astype(np.int32)),
                             n_tiles=n_tiles, yparams=yparams, xparams=xparams)
    t = t_pw._window_anchors(torch.from_numpy(np.ascontiguousarray(low[..., 0])),
                             torch.from_numpy(np.ascontiguousarray(low[..., 1])),
                             torch.from_numpy(np.ascontiguousarray(high[..., 0])),
                             torch.from_numpy(np.ascontiguousarray(high[..., 1])),
                             t_plan.lvl, t_plan.frac, t_plan.pad, n_tiles, yparams, xparams)
    return [np.asarray(a) for a in j], list(t)


@pytest.mark.parametrize('name', [n for n in SCENES if n != 'non_uniform'])
def test_window_anchors_match_jax(name):
    sc, j_plan, t_plan, _, _ = scene_run(name)
    n_tiles, low, high, d2, re = _permuted(sc)
    yparams, xparams = t_pw._uniform_params(sc['ys']), t_pw._uniform_params(sc['xs'])
    assert (yparams, xparams) == (j_pw._uniform_params(sc['ys']), j_pw._uniform_params(sc['xs']))
    j, t = _anchors_both(low, high, d2, re, j_plan, t_plan, n_tiles, yparams, xparams)
    for a, b in zip(t, j):
        assert a.shape == b.shape == (n_tiles, j_plan.anchor.size)
        np.testing.assert_array_equal(a, b)
    assert (j[2] >= 0).any()


def test_window_anchors_at_cell_boundaries():
    """Points within a few ulps of cell boundaries, one per tile, on an axis
    whose step has a float32 reciprocal unlike float32(1/step). Group 0 takes
    them at f = 0 (the lerp is exact), chosen where a true division and a
    multiply by the reciprocal pick different cells; group 1 lerps to them at
    f = 0.37 from ends where the fused and the separately rounded lerp pick
    different cells (``tests/_window_cases.py``, ``boundary_points``)."""
    bp = boundary_points(np.random.default_rng(11))
    low, high, plan, pick0 = bp['low'], bp['high'], bp['plan'], bp['pick0']
    xparams = t_pw._uniform_params(bp['xs'])
    d2 = np.zeros((1, low.shape[1]), np.float32)
    re = np.full(low.shape[1], 6371000.0, np.float32)
    j, t = _anchors_both(low, high, d2, re, plan, plan, bp['n_tiles'], bp['yparams'], xparams)
    for a, b in zip(t, j):
        np.testing.assert_array_equal(a, b)
    # the JAX pre-pass, and so the port, did not take a true division
    assert (t[0][:pick0.size, 0] != np.floor(pick0 / bp['s32'])).all()


def test_cpu_wrapper_runs_the_twin():
    sc, _, t_plan, _, _ = scene_run('nan_oob')
    args = [torch.from_numpy(_f32(sc[k])) for k in ('wet', 'hydro')]
    rays = [torch.from_numpy(_f32(sc[k])) for k in ('low', 'high', 'd2', 'ray_len', 're')]
    b = t_pw.prepare_windowed(*args, sc['ys'], sc['xs'], sc['zs'], *rays, t_plan, sc['shape'],
                              device='cpu')
    before = dict(kernels.LAUNCHES)
    w, h = t_pw.window_integrate(b)
    assert kernels.LAUNCHES == before
    rw, rh = t_pw.window_integrate_ref(b)
    torch.testing.assert_close(w, rw, rtol=0, atol=0, equal_nan=True)
    torch.testing.assert_close(h, rh, rtol=0, atol=0, equal_nan=True)
    assert w.shape == (b.ay.shape[0] * t_pw.TILE,)


@pytest.mark.parametrize('bad', ['float64_cube', 'anchor_shape', 'anchor_dtype', 'plan_level',
                                 'plan_plane'])
def test_window_wrapper_rejects_bad_inputs(bad):
    sc, _, t_plan, _, _ = scene_run('coherent')
    args = [torch.from_numpy(_f32(sc[k])) for k in ('wet', 'hydro')]
    rays = [torch.from_numpy(_f32(sc[k])) for k in ('low', 'high', 'd2', 'ray_len', 're')]
    b = t_pw.prepare_windowed(*args, sc['ys'], sc['xs'], sc['zs'], *rays, t_plan, sc['shape'],
                              device='cpu')
    if bad == 'float64_cube':
        b.cube_w = b.cube_w.double()
    elif bad == 'anchor_shape':
        b.ay = b.ay[:-1]
    elif bad == 'anchor_dtype':
        b.ax = b.ax.long()
    elif bad == 'plan_level':
        b.lvl = b.lvl + b.lo.shape[1]
    else:
        b.dzo = b.dzo + b.cube_w.shape[0]
    with pytest.raises(ValueError):
        t_pw.window_integrate(b)


def test_windowed_matches_port_brick():
    """The port's windowed and brick paths on the same coherent rays (the
    JAX package's own test holds its two paths to rtol 3e-6)."""
    sc, _, t_plan, _, (tw, th, used) = scene_run('coherent')
    assert used
    f = lambda k: torch.from_numpy(_f32(sc[k]))
    bw, bh = t_rt.integrate_rays(f('wet'), f('hydro'), sc['ys'], sc['xs'], sc['zs'],
                                 f('bnd_y'), f('bnd_x'), f('bnd_z'), f('d2'), f('ray_len'),
                                 f('re'), np.nanmax(sc['ray_len'], axis=1),
                                 heights=sc['heights'], hstep_max=sc['hstep_max'])
    torch.testing.assert_close(tw, bw, rtol=3e-6, atol=0)
    torch.testing.assert_close(th, bh, rtol=3e-6, atol=0)


def test_window_ablation_on_the_cpu():
    """The ablation entry point's scene and checks at a tiny size."""
    sc = window_ablation.build_scene(64, grid=(20, 60, 60), device='cpu')
    lines = []
    rec = window_ablation.run(sc, say=lines.append)
    assert len(lines) == 1 and rec['max_rel'] < window_ablation.TOL
    assert rec['rays'] == 64 * 64 and rec['finite'] == 1.0 and rec['nan_masks_equal']
