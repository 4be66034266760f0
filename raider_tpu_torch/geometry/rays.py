"""Ray construction: intersections of look rays with weather-model levels.

Counterpart of ``raider_tpu/geometry/rays.py``. The level chains are host
numpy (static per output height); the Newton solves for every pixel's
intersections run on the device of the pixel tensors in float64.
"""

from typing import Optional, Tuple

import numpy as np
import torch

from raider_tpu_torch.constants import _ZREF
from raider_tpu_torch.geodesy.ellipsoid import ecef2lla

# levels solved per Newton batch: bounds the (levels, N) float64 temporaries
# of ecef2lla at ~1.2M rays to a few GB
_LEVEL_CHUNK = 8


def _toa_newton_batch(xyz, look_vecs, heights, factor, max_iter: int):
    """Intersections of every ray with each height in ``heights``.

    xyz, look_vecs: (..., 3) float64 tensors; heights: host (L,) array;
    factor: (...,) tensor or scalar. Returns (L, ..., 3).
    """
    out = []
    for h0 in range(0, len(heights), _LEVEL_CHUNK):
        h = torch.as_tensor(np.asarray(heights[h0:h0 + _LEVEL_CHUNK], dtype=np.float64),
                            device=xyz.device)
        hb = h.reshape((-1,) + (1,) * (xyz.dim() - 1))          # (l, 1..)
        pos = xyz + hb[..., None] * look_vecs
        for _ in range(max_iter):
            llh_h = ecef2lla(pos[..., 0], pos[..., 1], pos[..., 2])[2]
            pos = pos + look_vecs * ((hb - llh_h) / factor)[..., None]
        out.append(pos)
    return torch.cat(out, dim=0)


def level_heights(model_zs, ht: float, max_tropo_height: float = float(_ZREF)) -> Optional[np.ndarray]:
    """The chain of clamped level heights a ray starting at ``ht`` crosses.

    The reference's per-level clamping rules: the topmost model level is
    nudged down by 0.01 m; levels entirely below ``ht`` or above
    ``max_tropo_height`` drop out; interval ends clamp to
    [ht, max_tropo_height]; intervals thinner than 1 m drop out.

    Returns an (L+1,) ascending array of interval boundary heights, or None
    if no level contributes.
    """
    model_zs = np.asarray(model_zs, dtype=np.float64)
    bounds = []
    for zz in range(model_zs.size - 1):
        low_ht = model_zs[zz]
        high_ht = model_zs[zz + 1]
        if high_ht == model_zs[-1]:
            high_ht = high_ht - 0.01
        if (high_ht < ht) or (low_ht >= max_tropo_height):
            continue
        if low_ht < ht:
            low_ht = ht
        if high_ht > max_tropo_height:
            high_ht = max_tropo_height
        if abs(high_ht - low_ht) < 1.0:
            continue
        bounds.append((float(low_ht), float(high_ht)))
    if not bounds:
        return None
    # [first interval's low, then every interval's high]: the reference
    # reuses the previous upper intersection as the next lower endpoint
    heights = [bounds[0][0]] + [hi for _, hi in bounds]
    return np.asarray(heights, dtype=np.float64)


def clip_chain(model_zs, ht: float, max_tropo_height: float = float(_ZREF),
               nudge_top: bool = True) -> Optional[np.ndarray]:
    """Full-length clamped boundary chain: entry k is model level k clipped
    into [ht, max_tropo_height] (topmost level nudged down 0.01 m).

    Levels below ``ht`` or above the top become zero-length; a cell thinner
    than 1 m collapses onto the last kept boundary so the next kept cell
    absorbs its span. Returns None when no level contributes.
    """
    z = np.asarray(model_zs, dtype=np.float64).copy()
    if nudge_top:
        z[-1] -= 0.01
    c = np.clip(z, ht, max_tropo_height)
    keep = np.diff(c) >= 1.0
    if not keep.any():
        return None
    first = int(np.argmax(keep))
    b = np.empty_like(c)
    b[:first + 1] = c[first]
    carry = c[first]
    for k in range(first, c.size - 1):
        if keep[k]:
            carry = c[k + 1]
        b[k + 1] = carry
    return b


def build_ray(model_zs, ht: float, xyz, look_vecs,
              max_tropo_height: float = float(_ZREF)) -> Tuple:
    """Per-level ray segment lengths and ECEF endpoints for all pixels.

    The first two boundary intersections run the full 10-iteration Newton;
    the rest use 3 iterations with the cos(incidence) factor taken from
    the first segment, as the reference does.

    Args:
        model_zs:  (nz,) ascending model level heights (host)
        ht:        output level height
        xyz:       (..., 3) float64 pixel ECEF tensor at height ``ht``
        look_vecs: (..., 3) float64 unit look vectors (ground -> sensor)

    Returns:
        (ray_lengths (L, ...), low_xyzs (L, ..., 3), high_xyzs (L, ..., 3)),
        or (None, None, None) when nothing contributes. low and high are
        views of one (L+1, ..., 3) boundary tensor.
    """
    heights = level_heights(model_zs, ht, max_tropo_height)
    if heights is None:
        return None, None, None
    p01 = _toa_newton_batch(xyz, look_vecs, heights[:2], 1.0, 10)
    seg0 = torch.linalg.norm(p01[1] - p01[0], dim=-1)
    cos_factor = (heights[1] - heights[0]) / seg0
    if heights.size > 2:
        rest = _toa_newton_batch(xyz, look_vecs, heights[2:], cos_factor, 3)
        pts = torch.cat([p01, rest], dim=0)
    else:
        pts = p01
    low_xyzs = pts[:-1]
    high_xyzs = pts[1:]
    ray_lengths = torch.linalg.norm(high_xyzs - low_xyzs, dim=-1)
    return ray_lengths, low_xyzs, high_xyzs
