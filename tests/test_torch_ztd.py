"""ZTD totals: raider_tpu_torch.ops.ztd vs the JAX Pallas kernel (CPU).

The twin runs the kernel's top-down float32 scan; the JAX kernel runs in
Pallas interpret mode, as tests/test_pallas_ztd.py runs it. Max relative
difference 2e-6: float32 sums of up to 136 positive terms, accumulated in
the same order. The port takes the cubes in (z, y, x) rows or as the
(z, y, x) view of the weather model's (y, x, z) columns.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from raider_tpu.ops.pallas_ztd import ztd_totals as j_ztd_totals
from raider_tpu_torch.ops.integrate import cumtrapz_from_top
from raider_tpu_torch.ops.ztd import column_strides, ztd_totals, ztd_totals_ref

K1, K2, K3 = 0.776, 0.233, 3.75e3
SHAPES = [(33, 12, 150), (8, 8, 128), (5, 3, 7)]


def _inputs(shape):
    rng = np.random.default_rng(3)
    t = rng.uniform(220, 300, shape).astype(np.float32)
    p = rng.uniform(1e3, 1e5, shape).astype(np.float32)
    e = rng.uniform(1, 1000, shape).astype(np.float32)
    zs = np.sort(rng.uniform(-500, 25000, shape[0])).astype(np.float32)
    return t, p, e, zs


def _column_inputs(shape):
    """Seeded (y, x, z) cubes of an (nz, ny, nx) grid, and the level heights."""
    nz, ny, nx = shape
    rng = np.random.default_rng(5)
    t = rng.uniform(220, 300, (ny, nx, nz)).astype(np.float32)
    p = rng.uniform(1e3, 1e5, (ny, nx, nz)).astype(np.float32)
    e = rng.uniform(1, 1000, (ny, nx, nz)).astype(np.float32)
    zs = np.sort(rng.uniform(-500, 25000, nz)).astype(np.float32)
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


@pytest.mark.parametrize('shape', [(137, 3, 5), (51, 7, 13), (2, 1, 1)])
def test_twin_on_columns_matches_pallas_interpret(shape):
    """The twin on the (z, y, x) views of (y, x, z) cubes against the Pallas
    kernel on the moved-axis arrays; the wrapper returns the same bits as
    contiguous (z, y, x) cubes."""
    t, p, e, zs = _column_inputs(shape)
    jw, jh = j_ztd_totals(*(jnp.asarray(np.moveaxis(a, -1, 0)) for a in (t, p, e)),
                          jnp.asarray(zs), K1, K2, K3, interpret=True)
    cols = [torch.movedim(torch.as_tensor(a), -1, 0) for a in (t, p, e)]
    # one column reads the same as one row
    assert column_strides(cols[0]) == ((1, shape[0]) if shape[1] * shape[2] > 1 else (1, 1))
    tw, th = ztd_totals_ref(*cols, torch.as_tensor(zs), K1, K2, K3)
    assert tw.shape == shape and tw.is_contiguous() and th.is_contiguous()
    assert _max_rel(tw.numpy(), jw) <= 2e-6
    assert _max_rel(th.numpy(), jh) <= 2e-6
    ww, wh = ztd_totals(*cols, torch.as_tensor(zs), K1, K2, K3)
    assert ww.is_contiguous() and torch.equal(ww, tw) and torch.equal(wh, th)
    rw, rh = ztd_totals(*(c.contiguous() for c in cols), torch.as_tensor(zs), K1, K2, K3)
    assert torch.equal(rw, tw) and torch.equal(rh, th)


def test_column_strides():
    rows = torch.zeros(4, 6, 5)
    assert column_strides(rows) == (30, 1)
    assert column_strides(torch.movedim(torch.zeros(6, 5, 4), -1, 0)) == (1, 4)
    assert column_strides(rows.transpose(1, 2).contiguous().transpose(1, 2)) is None
    assert column_strides(torch.zeros(8, 6, 5)[::2]) is None


@pytest.mark.parametrize('bad', ['swapped_yx', 'cropped_columns', 'mixed'])
def test_wrapper_rejects_other_layouts(bad):
    """Neither rows nor columns (or t, p, e in different layouts): the wrapper
    raises on every device rather than copy."""
    t, p, e, zs = (torch.as_tensor(a) for a in _inputs((6, 4, 5)))
    if bad == 'swapped_yx':
        t, p, e = (a.transpose(1, 2).contiguous().transpose(1, 2) for a in (t, p, e))
    elif bad == 'cropped_columns':
        t, p, e = (torch.movedim(a, 0, -1).contiguous()[1:3, 1:4].movedim(-1, 0)
                   for a in (t, p, e))
    else:
        p = torch.movedim(torch.movedim(p, 0, -1).contiguous(), -1, 0)
    with pytest.raises(ValueError, match='layout|contiguous'):
        ztd_totals(t, p, e, zs, K1, K2, K3)
