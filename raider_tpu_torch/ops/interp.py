"""Regular/rectilinear-grid linear interpolation on torch tensors.

Counterpart of ``raider_tpu/ops/interp.py``. Semantics match scipy's
``RegularGridInterpolator`` with ``bounds_error=False, fill_value=nan``:
out-of-range queries return NaN. Grid axes must be ascending. No Pallas
kernel lives here on the JAX side, so plain torch is the port.
"""

import numpy as np
import torch


def interp_along_axis(xs, ys, new_xs, axis: int = -1, fill_value=float('nan')):
    """Linear interpolation along ``axis`` with per-column sample points.

    ``xs`` (ascending along ``axis``, may vary per column) broadcasts with
    ``ys``; ``new_xs`` shares their leading dims. The bracketing index is
    the count of samples <= the query, as in the JAX compare-and-sum, taken
    here with a batched binary search (``searchsorted(right=True)``), which
    gives the same count for ascending, NaN-free columns.
    """
    xs = torch.movedim(xs, axis, -1)
    ys = torch.movedim(ys, axis, -1)
    new_xs = torch.movedim(new_xs, axis, -1)
    xs, ys = torch.broadcast_tensors(xs, ys)
    new_xs = new_xs.expand(xs.shape[:-1] + new_xs.shape[-1:])

    n = xs.shape[-1]
    idx = torch.searchsorted(xs.contiguous(), new_xs.contiguous(), right=True)
    idx = idx.clamp(1, n - 1)
    x_lo = torch.gather(xs, -1, idx - 1)
    x_hi = torch.gather(xs, -1, idx)
    y_lo = torch.gather(ys, -1, idx - 1)
    y_hi = torch.gather(ys, -1, idx)

    t = (new_xs - x_lo) / (x_hi - x_lo)
    out = y_lo + t * (y_hi - y_lo)
    oob = (new_xs < xs[..., :1]) | (new_xs > xs[..., -1:])
    out = torch.where(oob, torch.full_like(out, fill_value), out)
    return torch.movedim(out, -1, axis)


def axis_uniform_step(axis_np) -> float | None:
    """The uniform-axis predicate, shared by every consumer.

    Returns the locate step ``(hi - lo) / (n - 1)`` when the axis is uniform
    enough for :func:`_locate`'s fast path, else None. The brick integrate
    kernel (``delay.raytrace.integrate_bricks``) takes its uniform flag and
    step from this same function, so the kernel and ``_locate`` can never
    disagree on the formula that picks a cell.
    """
    axis_np = np.asarray(axis_np)
    n = axis_np.shape[0]
    if n < 2:
        return None
    d = np.diff(axis_np)
    if not np.allclose(d, d[0], rtol=1e-6, atol=0.0):
        return None
    return (float(axis_np[-1]) - float(axis_np[0])) / (n - 1)


def _locate(axis_np: np.ndarray, coords):
    """Bracketing cell index + fractional offset along one rectilinear axis.

    ``axis_np`` is a host (numpy) axis: a uniform axis locates with one
    division ``(p - lo) / step``, a non-uniform one with a binary search.
    Returns (idx in [0, n-2] as int64, frac, in_bounds).
    """
    axis_np = np.asarray(axis_np)
    n = axis_np.shape[0]
    lo = float(axis_np[0])
    hi = float(axis_np[-1])
    in_bounds = (coords >= lo) & (coords <= hi)
    if n < 2:
        # degenerate single-node axis: everything clamps to cell 0
        return torch.zeros_like(coords, dtype=torch.int64), torch.zeros_like(coords), in_bounds

    step = axis_uniform_step(axis_np)
    if step is not None:
        # a true division, as in the JAX package and the brick kernel: the
        # divisor is a tensor on the coordinates' device because torch turns
        # a CUDA division by a Python scalar into a multiply by its reciprocal
        pos = (coords - lo) / torch.tensor(step, dtype=coords.dtype, device=coords.device)
        # NaN goes to cell 0 (the kernel's fmax does the same) instead of
        # converting to an undefined integer
        idx = torch.floor(pos).nan_to_num(0.0).clamp(0, n - 2).to(torch.int64)
        frac = pos - idx
    else:
        grid = torch.as_tensor(axis_np, dtype=coords.dtype, device=coords.device)
        idx = (torch.searchsorted(grid, coords.contiguous(), right=True) - 1).clamp(0, n - 2)
        x_lo = grid[idx]
        x_hi = grid[idx + 1]
        frac = (coords - x_lo) / (x_hi - x_lo)
    return idx, frac, in_bounds


def interp3d_points(cube_zyx, ys, xs, zs, pts_y, pts_x, pts_z):
    """Trilinear interpolation of a (z, y, x) cube at scattered points.

    Grid axes are host arrays; the point tensors share any common shape.
    An 8-corner gather; NaN outside the grid.
    """
    ys, xs, zs = (np.asarray(a) for a in (ys, xs, zs))
    iy, fy, by = _locate(ys, pts_y)
    ix, fx, bx = _locate(xs, pts_x)
    iz, fz, bz = _locate(zs, pts_z)

    nz, ny, nx = cube_zyx.shape
    flat = cube_zyx.reshape(-1)

    def corner(dz, dy, dx):
        return flat[((iz + dz) * ny + (iy + dy)) * nx + (ix + dx)]

    fy = fy.to(cube_zyx.dtype)
    fx = fx.to(cube_zyx.dtype)
    fz = fz.to(cube_zyx.dtype)
    c00 = corner(0, 0, 0) * (1 - fx) + corner(0, 0, 1) * fx
    c01 = corner(0, 1, 0) * (1 - fx) + corner(0, 1, 1) * fx
    c10 = corner(1, 0, 0) * (1 - fx) + corner(1, 0, 1) * fx
    c11 = corner(1, 1, 0) * (1 - fx) + corner(1, 1, 1) * fx
    c0 = c00 * (1 - fy) + c01 * fy
    c1 = c10 * (1 - fy) + c11 * fy
    out = c0 * (1 - fz) + c1 * fz
    ok = by & bx & bz
    return torch.where(ok, out, torch.full_like(out, float('nan')))


def grid_weights(axis_np: np.ndarray, query_np) -> np.ndarray:
    """Dense interpolation weight matrix W (nq, n) for one axis (numpy).

    At most two non-zeros per row: out[q] = sum_k W[q, k] f[k].
    Out-of-range rows are all-NaN so the NaN fill propagates through the
    contractions of :func:`interp3d_separable`.
    """
    axis_np = np.asarray(axis_np, dtype=np.float64)
    q = np.asarray(query_np, dtype=np.float64).ravel()
    n = axis_np.shape[0]
    idx = np.clip(np.searchsorted(axis_np, q, side='right') - 1, 0, n - 2)
    x_lo = axis_np[idx]
    x_hi = axis_np[idx + 1]
    frac = (q - x_lo) / (x_hi - x_lo)
    w = np.zeros((q.size, n))
    rows = np.arange(q.size)
    w[rows, idx] = 1.0 - frac
    w[rows, idx + 1] = frac
    oob = (q < axis_np[0]) | (q > axis_np[-1])
    w[oob, :] = np.nan
    return w


def interp3d_separable(cube_zyx, w_z, w_y, w_x):
    """Axis-aligned grid-to-grid interpolation as three dense contractions.

        out[l, j, i] = W_z[l, c] W_y[j, b] W_x[i, a] cube[c, b, a]

    The weights (from :func:`grid_weights`) are cast to the cube's dtype.
    The contractions must run in full fp32, as the JAX side's
    ``precision='highest'`` does: a float32 cube on the GPU is refused while
    TF32 matmuls are allowed (``torch.backends.cuda.matmul.allow_tf32`` or a
    float32 matmul precision other than 'highest'), because TF32 keeps about
    three decimal digits. :func:`contract_z` and :func:`contract_yx` are its
    two halves.
    """
    return contract_yx(contract_z(cube_zyx, w_z), w_y, w_x)


def contract_z(cube_zyx, w_z):
    """The first contraction of :func:`interp3d_separable`:
    out[l, b, a] = W_z[l, c] cube[c, b, a]."""
    w_z, = _weights(cube_zyx, w_z)
    return torch.einsum('zyx,az->ayx', cube_zyx, w_z)


def contract_yx(cube_lyx, w_y, w_x):
    """The other two contractions of :func:`interp3d_separable`:
    out[l, j, i] = W_y[j, b] W_x[i, a] cube[l, b, a]. Each output row needs
    only its own row of ``w_y``, so the rows may be computed in blocks."""
    w_y, w_x = _weights(cube_lyx, w_y, w_x)
    out = torch.einsum('ayx,by->abx', cube_lyx, w_y)
    return torch.einsum('abx,cx->abc', out, w_x)


def _weights(cube, *ws):
    """The weights as tensors of the cube's dtype on its device, after the
    full-fp32 check of :func:`interp3d_separable`."""
    if (cube.is_cuda and cube.dtype == torch.float32
            and (torch.backends.cuda.matmul.allow_tf32
                 or torch.get_float32_matmul_precision() != 'highest')):
        raise RuntimeError('interp3d_separable needs full-fp32 matmuls: set '
                           'torch.backends.cuda.matmul.allow_tf32 = False and '
                           "torch.set_float32_matmul_precision('highest')")
    return [torch.as_tensor(w, dtype=cube.dtype, device=cube.device) for w in ws]
