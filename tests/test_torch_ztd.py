"""ZTD totals: raider_tpu_torch.ops.ztd vs the JAX Pallas kernel (CPU).

The twin runs the kernel's top-down float32 scan; the JAX kernel runs in
Pallas interpret mode, as tests/test_pallas_ztd.py runs it. Max relative
difference 2e-6: float32 sums of up to 33 positive terms, accumulated in
the same order.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from raider_tpu.ops.pallas_ztd import ztd_totals as j_ztd_totals
from raider_tpu_torch.ops.integrate import cumtrapz_from_top
from raider_tpu_torch.ops.ztd import ztd_totals, ztd_totals_ref

K1, K2, K3 = 0.776, 0.233, 3.75e3
SHAPES = [(33, 12, 150), (8, 8, 128), (5, 3, 7)]


def _inputs(shape):
    rng = np.random.default_rng(3)
    t = rng.uniform(220, 300, shape).astype(np.float32)
    p = rng.uniform(1e3, 1e5, shape).astype(np.float32)
    e = rng.uniform(1, 1000, shape).astype(np.float32)
    zs = np.sort(rng.uniform(-500, 25000, shape[0])).astype(np.float32)
    return t, p, e, zs


def _max_rel(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    nz = b != 0
    assert np.array_equal(a[~nz], b[~nz])
    return float(np.max(np.abs(a[nz] - b[nz]) / np.abs(b[nz])))


@pytest.mark.parametrize('shape', SHAPES)
def test_twin_matches_pallas_interpret(shape):
    t, p, e, zs = _inputs(shape)
    jw, jh = j_ztd_totals(jnp.asarray(t), jnp.asarray(p), jnp.asarray(e), jnp.asarray(zs),
                          K1, K2, K3, interpret=True)
    tw, th = ztd_totals_ref(*(torch.as_tensor(a) for a in (t, p, e, zs)), K1, K2, K3)
    assert tw.dtype == torch.float32
    assert _max_rel(tw.numpy(), jw) <= 2e-6
    assert _max_rel(th.numpy(), jh) <= 2e-6
    assert np.all(tw.numpy()[-1] == 0) and np.all(th.numpy()[-1] == 0)


@pytest.mark.parametrize('shape', SHAPES)
def test_twin_matches_cumtrapz(shape):
    """Refractivity then the reversed cumulative trapezoid (float64)."""
    t, p, e, zs = _inputs(shape)
    t64, p64, e64 = (torch.as_tensor(a, dtype=torch.float64) for a in (t, p, e))
    zs64 = torch.as_tensor(zs, dtype=torch.float64)
    wet_n = K2 * e64 / t64 + K3 * e64 / t64**2
    hyd_n = K1 * p64 / t64
    ref_w = torch.movedim(cumtrapz_from_top(torch.movedim(wet_n, 0, -1), zs64), -1, 0)
    ref_h = torch.movedim(cumtrapz_from_top(torch.movedim(hyd_n, 0, -1), zs64), -1, 0)
    tw, th = ztd_totals_ref(*(torch.as_tensor(a) for a in (t, p, e, zs)), K1, K2, K3)
    np.testing.assert_allclose(tw.numpy(), ref_w.numpy(), rtol=2e-6, atol=1e-9)
    np.testing.assert_allclose(th.numpy(), ref_h.numpy(), rtol=2e-6, atol=1e-9)


def test_cpu_wrapper_runs_the_twin():
    from raider_tpu_torch import kernels

    t, p, e, zs = (torch.as_tensor(a) for a in _inputs((6, 4, 5)))
    before = dict(kernels.LAUNCHES)
    w, h = ztd_totals(t, p, e, zs, K1, K2, K3)
    rw, rh = ztd_totals_ref(t, p, e, zs, K1, K2, K3)
    assert torch.equal(w, rw) and torch.equal(h, rh)
    assert kernels.LAUNCHES == before


@pytest.mark.parametrize('bad', ['rank', 'one_level', 'p_shape', 'e_dtype', 'zs_len'])
def test_wrapper_rejects_bad_inputs(bad):
    t, p, e, zs = (torch.as_tensor(a) for a in _inputs((6, 4, 5)))
    if bad == 'rank':
        t = t[0]
    elif bad == 'one_level':
        t, p, e, zs = t[:1], p[:1], e[:1], zs[:1]
    elif bad == 'p_shape':
        p = p[:, :3]
    elif bad == 'e_dtype':
        e = e.double()
    else:
        zs = zs[:-1]
    with pytest.raises(ValueError):
        ztd_totals(t, p, e, zs, K1, K2, K3)
