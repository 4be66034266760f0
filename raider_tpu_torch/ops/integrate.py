"""Vertical integration for zenith total delay (ZTD).

Counterpart of ``raider_tpu/ops/integrate.py``: the reference's per-level
``np.trapz`` loop as one reversed cumulative sum over the cube.
"""

import torch


def cumtrapz_from_top(values, zs, scale=1e-6):
    """Integral of ``values`` dz from each level to the top, times ``scale``.

    Args:
        values: (..., nz) tensor, z ascending along the last axis.
        zs:     (nz,) or broadcastable tensor of sample heights.
        scale:  multiplier (1e-6 converts N-units to delay in meters).

    Returns:
        (..., nz): out[..., k] = scale * trapz(values[..., k:], zs[k:]).
    """
    dz = torch.diff(zs, dim=-1)
    seg = 0.5 * (values[..., 1:] + values[..., :-1]) * dz
    rev = torch.flip(torch.cumsum(torch.flip(seg, (-1,)), dim=-1), (-1,))
    out = torch.cat([rev, torch.zeros_like(values[..., :1])], dim=-1)
    return scale * out
