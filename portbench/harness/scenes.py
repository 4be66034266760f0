"""Seeded scene generators: orbits, frames and the answers a run samples.

The orbit is a copy of the port's smoke run (``chip_smoke.py::track_orbit``:
a 700 km circular polar orbit whose ground track runs along one longitude,
statevectors every 30 s over +-600 s), with the velocities of the circle
itself in place of finite differences, so that the reference can use the
circle while the program interpolates its statevectors. The frame size is
that of the smoke run's GUNW frame (``chip_smoke.py::GUNW_POLYGON``).
"""

import math

import numpy as np

from portbench.harness.fields import sub_seed


def orbit(track_lon_deg: float, ref_lat_deg: float, spec: dict) -> dict:
    """The circular orbit of ``spec`` (altitude_m, period_s, span_s, step_s)
    over ``track_lon_deg``, at ``ref_lat_deg`` at its reference time."""
    return dict(radius_m=6378137.0 + spec['altitude_m'], period_s=float(spec['period_s']),
                span_s=float(spec['span_s']), step_s=float(spec['step_s']),
                track_lon_deg=float(track_lon_deg), ref_lat_deg=float(ref_lat_deg))


def statevectors(o: dict):
    """(times (n,), ECEF positions (n, 3), velocities (n, 3)) of the orbit."""
    tt = np.arange(-o['span_s'], o['span_s'] + 0.5 * o['step_s'], o['step_s'])
    w = 2.0 * math.pi / o['period_s']
    ang = w * tt + math.radians(o['ref_lat_deg'])
    lon = math.radians(o['track_lon_deg'])
    r = o['radius_m']
    pos = np.stack([r * np.cos(ang) * math.cos(lon), r * np.cos(ang) * math.sin(lon),
                    r * np.sin(ang)], -1)
    vel = np.stack([-r * w * np.sin(ang) * math.cos(lon), -r * w * np.sin(ang) * math.sin(lon),
                    r * w * np.cos(ang)], -1)
    return tt, pos, vel


def frames(spec, cut_frame, seed: int) -> list:
    """The SNWE frames of a mix: the configuration's own frame
    (``"model_cut"``), or ``count`` frames of ``size_deg`` (lat, lon) drawn
    from the seed with their south-west corners inside ``sw_lat`` x
    ``sw_lon``."""
    if spec == 'model_cut':
        return [list(cut_frame)]
    rng = np.random.default_rng(sub_seed(seed, 4))
    dlat, dlon = spec['size_deg']
    out = []
    for _ in range(spec['count']):
        s = round(float(rng.uniform(*spec['sw_lat'])), 2)
        w = round(float(rng.uniform(*spec['sw_lon'])), 2)
        out.append([s, round(s + dlat, 2), w, round(w + dlon, 2)])
    return out


def heights(spec) -> list:
    if isinstance(spec, dict):
        return [float(h) for h in np.arange(spec['start'], spec['stop'] + 0.5 * spec['step'],
                                            spec['step'])]
    return [float(h) for h in spec]


def answer_sample(seed: int, k: int, shape, n: int):
    """(height, row, column) indices of ``n`` answers of request ``k``, drawn
    from the seed: the four corners at the lowest and at the highest height
    (the longest and shortest rays), the rest uniform."""
    nh, ny, nx = shape
    rng = np.random.default_rng(sub_seed(seed, 5, k))
    fixed = [(h, r, c) for h in (0, nh - 1) for r in (0, ny - 1) for c in (0, nx - 1)]
    h = np.concatenate([[f[0] for f in fixed], rng.integers(0, nh, n - len(fixed))])
    r = np.concatenate([[f[1] for f in fixed], rng.integers(0, ny, n - len(fixed))])
    c = np.concatenate([[f[2] for f in fixed], rng.integers(0, nx, n - len(fixed))])
    return h, r, c


def column_sample(seed: int, date: int, ny: int, nx: int, n: int):
    """(rows, columns) of ``n`` model columns of one date, drawn from the seed."""
    rng = np.random.default_rng(sub_seed(seed, 6, date))
    return rng.integers(0, ny, n), rng.integers(0, nx, n)
