"""Fused refractivity + per-node ZTD totals: kernel B1 and its twin.

Counterpart of ``raider_tpu/ops/pallas_ztd.py``. For (nz, ny, nx) cubes
t, p, e and level heights zs:

    wet_N   = k2 e / T + k3 e / T^2
    hydro_N = k1 p / T
    total[k] = 1e-6 * sum_{j >= k} 0.5 (N[j] + N[j+1]) dz[j]

:func:`ztd_totals` launches the CUDA kernel (``csrc/ztd_totals.cu``) for
CUDA tensors and runs :func:`ztd_totals_ref`, the plain-torch twin with the
kernel's order of operations, for CPU tensors. A kernel failure raises.

The cubes come in one of two layouts (:func:`column_strides`): contiguous
(z, y, x) rows, or ``torch.movedim(a, -1, 0)`` of contiguous (y, x, z)
cubes, the weather model's own layout, read without a copy. Any other
layout raises. The results are contiguous (z, y, x) cubes.
"""

import torch

from raider_tpu_torch import kernels


def _dz(zs, dtype):
    zs = zs.to(dtype)
    return zs[1:] - zs[:-1]


def ztd_totals_ref(t, p, e, zs, k1: float, k2: float, k3: float):
    """Plain-torch twin of kernel B1: a top-down scan, one level at a time."""
    n_w = k2 * e / t + k3 * e / (t * t)
    n_h = k1 * p / t
    d = _dz(zs, t.dtype) * 0.5e-6
    wet = torch.empty(t.shape, dtype=t.dtype, device=t.device)
    hyd = torch.empty(t.shape, dtype=t.dtype, device=t.device)
    wet[-1] = 0.0
    hyd[-1] = 0.0
    acc_w = torch.zeros_like(t[0])
    acc_h = torch.zeros_like(t[0])
    for k in range(t.shape[0] - 2, -1, -1):
        acc_w = acc_w + (n_w[k] + n_w[k + 1]) * d[k]
        acc_h = acc_h + (n_h[k] + n_h[k + 1]) * d[k]
        wet[k] = acc_w
        hyd[k] = acc_h
    return wet, hyd


def column_strides(a):
    """(stride_z, stride_col) of an (nz, ny, nx) cube seen as (nz, ny * nx)
    when kernel B1 can read it: ``(ny * nx, 1)`` for contiguous (z, y, x)
    rows, ``(1, nz)`` for the (z, y, x) view of a contiguous (y, x, z) cube;
    None for any other layout."""
    nz, ny, nx = a.shape
    if a.is_contiguous():
        return ny * nx, 1
    if torch.movedim(a, 0, -1).is_contiguous():
        return 1, nz
    return None


def ztd_totals(t, p, e, zs, k1: float, k2: float, k3: float):
    """Per-node cumulative zenith delays (wet_total, hydro_total), contiguous
    (z, y, x).

    t, p, e: (nz, ny, nx) tensors on one device, all three in one layout of
    :func:`column_strides` (float32 on CUDA); zs: (nz,). CPU tensors run the
    twin; CUDA tensors launch kernel B1.
    """
    shape = t.shape
    if len(shape) != 3 or shape[0] < 2:
        raise ValueError(f'ztd_totals needs (nz >= 2, ny, nx) cubes, got {tuple(shape)}')
    for name, a in (('p', p), ('e', e)):
        if a.shape != shape or a.device != t.device or a.dtype != t.dtype:
            raise ValueError(f'ztd_totals: {name} does not match t in shape/device/dtype')
    if zs.shape != (shape[0],):
        raise ValueError(f'ztd_totals: zs must be ({shape[0]},), got {tuple(zs.shape)}')
    strides = column_strides(t)
    if strides is None or any(column_strides(a) != strides for a in (p, e)):
        raise ValueError('ztd_totals: t, p and e must all be contiguous (z, y, x) cubes or all '
                         'the movedim(-1, 0) views of contiguous (y, x, z) cubes, got strides '
                         f'{t.stride()}, {p.stride()}, {e.stride()}')
    if t.device.type == 'cpu':
        return ztd_totals_ref(t, p, e, zs, k1, k2, k3)
    if t.device.type != 'cuda':
        raise ValueError(f'ztd_totals: unsupported device {t.device}')
    if t.dtype != torch.float32:
        raise ValueError('ztd_totals: the CUDA kernel takes float32 cubes')
    dz = _dz(zs.to(t.device), torch.float32).contiguous()
    wet = torch.empty(shape, dtype=torch.float32, device=t.device)
    hyd = torch.empty(shape, dtype=torch.float32, device=t.device)
    kernels.launch_ztd_totals(t, p, e, dz, wet, hyd, float(k1), float(k2), float(k3),
                              stride_z=strides[0], stride_col=strides[1])
    return wet, hyd
