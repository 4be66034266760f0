"""Bounding-box interval arithmetic (counterpart of ``raider_tpu/utils/bbox.py``).

Axis-aligned boxes as plain intervals: the containment checks of the weather
models, with +/-360-degree longitude translates.
"""

from typing import List, Sequence, Tuple, Union

import numpy as np

Box = Tuple[float, float, float, float]  # (W, S, E, N)

WORLD: Box = (-180.0, -90.0, 180.0, 90.0)


def clip_bbox(bbox: Sequence[float], spacing: Union[int, float]) -> List[float]:
    """Clip an SNWE box outward to multiples of ``spacing``."""
    return [
        float(np.floor(bbox[0] / spacing) * spacing),
        float(np.ceil(bbox[1] / spacing) * spacing),
        float(np.floor(bbox[2] / spacing) * spacing),
        float(np.ceil(bbox[3] / spacing) * spacing),
    ]


def boxes_intersect(a: Box, b: Box) -> bool:
    aw, as_, ae, an = a
    bw, bs, be, bn = b
    return not (ae < bw or be < aw or an < bs or bn < as_)


def box_contains(outer: Box, inner: Box, buffer: float = 0.0) -> bool:
    ow, os_, oe, on = outer
    iw, is_, ie, in_ = inner
    return (
        ow - buffer <= iw
        and os_ - buffer <= is_
        and ie <= oe + buffer
        and in_ <= on + buffer
    )


def box_contains_with_translates(outer: Box, inner: Box, buffer_deg: float = 1e-5) -> bool:
    """Containment allowing +/-360-degree longitude translates of ``outer``
    when it extends past the world box (the union of its translates)."""
    if not box_contains(WORLD, outer):
        candidates = [
            outer,
            (outer[0] + 360.0, outer[1], outer[2] + 360.0, outer[3]),
            (outer[0] - 360.0, outer[1], outer[2] - 360.0, outer[3]),
        ]
        # the union of buffered translates contains `inner` iff inner's
        # latitude span fits and its longitude span is covered by the union
        # of the translated longitude intervals
        iw, is_, ie, in_ = inner
        lat_ok = any(c[1] - buffer_deg <= is_ and in_ <= c[3] + buffer_deg for c in candidates)
        if not lat_ok:
            return False
        intervals = sorted((c[0] - buffer_deg, c[2] + buffer_deg) for c in candidates)
        merged = [intervals[0]]
        for lo, hi in intervals[1:]:
            if lo <= merged[-1][1]:
                merged[-1] = (merged[-1][0], max(merged[-1][1], hi))
            else:
                merged.append((lo, hi))
        return any(lo <= iw and ie <= hi for lo, hi in merged)

    if box_contains(outer, WORLD):
        return True
    return box_contains(outer, inner, buffer=0.0)


def getBufferedExtent(lats, lons, buffer_size: float = 0.0):
    """SNWE bounding box around sets of lats/lons."""
    return (
        min(lats) - buffer_size,
        max(lats) + buffer_size,
        min(lons) - buffer_size,
        max(lons) + buffer_size,
    )


def isOutside(extent1, extent2) -> bool:
    """True when any of SNWE ``extent1`` lies outside ``extent2``; equal
    extents are "inside"."""
    return (extent1[0] < extent2[0] or extent1[1] > extent2[1]
            or extent1[2] < extent2[2] or extent1[3] > extent2[3])


def isInside(extent1, extent2) -> bool:
    """Every bound of ``extent1`` at or beyond the matching bound of
    ``extent2``."""
    return (extent1[0] <= extent2[0] and extent1[1] >= extent2[1]
            and extent1[2] <= extent2[2] and extent1[3] >= extent2[3])
