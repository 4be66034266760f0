"""raider_tpu_torch.ops vs raider_tpu.ops on identical seeded inputs (CPU).

Tolerances: float64 to rtol 1e-12 (the same formulas; only the order of a
few roundings can differ), float32 to rtol 1e-6 (a few float32 ulps).
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from raider_tpu.ops import integrate as j_integrate
from raider_tpu.ops import interp as j_interp
from raider_tpu_torch.ops import integrate as t_integrate
from raider_tpu_torch.ops import interp as t_interp

RTOL = {np.float64: 1e-12, np.float32: 1e-6}
ATOL = {np.float64: 1e-12, np.float32: 1e-6}
DTYPES = [np.float64, np.float32]


def _axis(n, lo, hi, uniform, rng):
    if uniform:
        return np.linspace(lo, hi, n)
    return np.sort(np.concatenate([[lo, hi], rng.uniform(lo, hi, n - 2)]))


def _close(a, b, dtype):
    np.testing.assert_allclose(np.asarray(a), np.asarray(b),
                               rtol=RTOL[dtype], atol=ATOL[dtype], equal_nan=True)


@pytest.mark.parametrize('dtype', DTYPES)
@pytest.mark.parametrize('nz', [2, 17])
def test_cumtrapz_from_top(dtype, nz):
    rng = np.random.default_rng(nz)
    vals = rng.uniform(0.0, 300.0, (4, 5, nz)).astype(dtype)
    zs = np.sort(rng.uniform(-500.0, 25000.0, nz)).astype(dtype)
    ref = j_integrate.cumtrapz_from_top(jnp.asarray(vals), jnp.asarray(zs))
    out = t_integrate.cumtrapz_from_top(torch.as_tensor(vals), torch.as_tensor(zs))
    assert out.dtype == torch.from_numpy(vals).dtype
    assert np.all(out[..., -1].numpy() == 0)
    # totals of up to 17 positive terms: the reversed cumsum rounds per step
    _close(out, ref, dtype)


@pytest.mark.parametrize('dtype', DTYPES)
@pytest.mark.parametrize('uniform', [True, False])
def test_interp_along_axis(dtype, uniform):
    rng = np.random.default_rng(1)
    ny, nx, n, m = 3, 4, 12, 9
    base = _axis(n, -200.0, 20000.0, uniform, rng)
    xs = (base + rng.uniform(-50.0, 50.0, (ny, nx, 1))).astype(dtype)   # per-column ladders
    ys = rng.uniform(200.0, 300.0, (ny, nx, n)).astype(dtype)
    new_xs = np.broadcast_to(np.linspace(-1000.0, 21000.0, m), (ny, nx, m)).astype(dtype)
    ref = j_interp.interp_along_axis(xs, ys, new_xs, axis=2)
    out = t_interp.interp_along_axis(torch.as_tensor(xs), torch.as_tensor(ys),
                                     torch.as_tensor(new_xs), axis=2)
    _close(out, ref, dtype)
    assert np.isnan(out.numpy()[..., 0]).all() and np.isnan(out.numpy()[..., -1]).all()


def _cube_and_points(dtype, uniform, seed=2):
    rng = np.random.default_rng(seed)
    ys = _axis(9, 30.0, 34.0, uniform, rng)
    xs = _axis(11, -120.0, -115.0, uniform, rng)
    zs = _axis(7, -500.0, 15000.0, uniform, rng)
    cube = rng.uniform(0.0, 100.0, (zs.size, ys.size, xs.size)).astype(dtype)
    # points inside, plus a ring outside every axis (NaN fill)
    py = rng.uniform(29.5, 34.5, 300).astype(dtype)
    px = rng.uniform(-120.5, -114.5, 300).astype(dtype)
    pz = rng.uniform(-1000.0, 16000.0, 300).astype(dtype)
    return ys, xs, zs, cube, py, px, pz


@pytest.mark.parametrize('dtype', DTYPES)
@pytest.mark.parametrize('uniform', [True, False])
def test_interp3d_points(dtype, uniform):
    ys, xs, zs, cube, py, px, pz = _cube_and_points(dtype, uniform)
    ref = np.asarray(j_interp.interp3d_points(jnp.asarray(cube), ys, xs, zs, py, px, pz))
    out = t_interp.interp3d_points(torch.as_tensor(cube), ys, xs, zs, torch.as_tensor(py),
                                   torch.as_tensor(px), torch.as_tensor(pz)).numpy()
    outside = ((py < ys[0]) | (py > ys[-1]) | (px < xs[0]) | (px > xs[-1])
               | (pz < zs[0]) | (pz > zs[-1]))
    assert outside.any() and (~outside).any()
    np.testing.assert_array_equal(np.isnan(out), outside)
    np.testing.assert_array_equal(np.isnan(out), np.isnan(ref))
    _close(out, ref, dtype)


@pytest.mark.parametrize('dtype', DTYPES)
@pytest.mark.parametrize('uniform', [True, False])
def test_interp3d_separable(dtype, uniform):
    ys, xs, zs, cube, *_ = _cube_and_points(dtype, uniform, seed=3)
    qy = np.linspace(29.9, 34.0, 13)       # first row outside: a NaN row
    qx = np.linspace(-119.5, -115.0, 6)
    qz = np.array([0.0, 500.0, 14000.0])
    w = [j_interp.grid_weights(a, q) for a, q in ((zs, qz), (ys, qy), (xs, qx))]
    for a, q, wj in zip((zs, ys, xs), (qz, qy, qx), w):
        np.testing.assert_array_equal(t_interp.grid_weights(a, q), wj)
    ref = np.asarray(j_interp.interp3d_separable(jnp.asarray(cube), *[jnp.asarray(x) for x in w]))
    out = t_interp.interp3d_separable(torch.as_tensor(cube), *w).numpy()
    assert out.dtype == dtype
    assert np.isnan(out[:, 0]).all() and np.isfinite(out[:, 1:]).all()
    _close(out, ref, dtype)


@pytest.mark.parametrize('axis', [np.linspace(0.0, 1.0, 11), np.array([0.0, 1.0, 2.5, 4.5]),
                                  np.array([3.0])])
def test_axis_uniform_step_matches_jax(axis):
    assert t_interp.axis_uniform_step(axis) == j_interp.axis_uniform_step(axis)


def test_locate_divides_truly():
    """The uniform locate divides by the step (never multiplies by its
    reciprocal): cell choices at boundaries follow the JAX formula."""
    axis = np.linspace(0.0, 0.7, 8)            # step 0.1, not exact in binary
    p = torch.tensor(np.arange(0, 8) * np.float32(0.1), dtype=torch.float32)
    idx, frac, ok = t_interp._locate(axis, p)
    j_idx, j_frac, _ = j_interp._locate(axis, jnp.asarray(p.numpy()))
    np.testing.assert_array_equal(idx.numpy(), np.asarray(j_idx))
    np.testing.assert_array_equal(frac.numpy(), np.asarray(j_frac))
    assert ok.all()
