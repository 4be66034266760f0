"""2-D polygon predicates (counterpart of ``raider_tpu/utils/geom2d.py``).

The weather models' domain checks (the HRRR CONUS and Alaska coverage
polygons).
"""

from typing import Sequence, Tuple

Point = Tuple[float, float]


def point_in_polygon(pt: Point, poly: Sequence[Point]) -> bool:
    """Ray-casting point-in-polygon (boundary counts as inside)."""
    x, y = pt
    n = len(poly)
    inside = False
    for i in range(n):
        x1, y1 = poly[i]
        x2, y2 = poly[(i + 1) % n]
        # on-edge check
        cross = (x2 - x1) * (y - y1) - (y2 - y1) * (x - x1)
        if abs(cross) < 1e-12 and min(x1, x2) - 1e-12 <= x <= max(x1, x2) + 1e-12 \
                and min(y1, y2) - 1e-12 <= y <= max(y1, y2) + 1e-12:
            return True
        if (y1 > y) != (y2 > y):
            xin = x1 + (y - y1) * (x2 - x1) / (y2 - y1)
            if x < xin:
                inside = not inside
    return inside


def _segments_intersect(p1, p2, p3, p4) -> bool:
    def ccw(a, b, c):
        return (c[1] - a[1]) * (b[0] - a[0]) - (b[1] - a[1]) * (c[0] - a[0])

    d1 = ccw(p3, p4, p1)
    d2 = ccw(p3, p4, p2)
    d3 = ccw(p1, p2, p3)
    d4 = ccw(p1, p2, p4)
    if ((d1 > 0) != (d2 > 0)) and ((d3 > 0) != (d4 > 0)):
        return True
    return False


def _box_corners(box_wsen):
    w, s, e, n = box_wsen
    return [(w, s), (w, n), (e, n), (e, s)]


def polygon_contains_box(poly: Sequence[Point], box_wsen) -> bool:
    """True if every corner of the (W, S, E, N) box lies inside ``poly``
    (sufficient for convex coverage polygons)."""
    return all(point_in_polygon(c, poly) for c in _box_corners(box_wsen))


def polygon_intersects_box(poly: Sequence[Point], box_wsen) -> bool:
    corners = _box_corners(box_wsen)
    if any(point_in_polygon(c, poly) for c in corners):
        return True
    w, s, e, n = box_wsen
    if any(w <= px <= e and s <= py <= n for px, py in poly):
        return True
    box_edges = list(zip(corners, corners[1:] + corners[:1]))
    poly_edges = [(poly[i], poly[(i + 1) % len(poly)]) for i in range(len(poly))]
    return any(
        _segments_intersect(a1, a2, b1, b2)
        for a1, a2 in box_edges
        for b1, b2 in poly_edges
    )
