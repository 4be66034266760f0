"""Satellite orbit: Hermite interpolation and a batched geo2rdr, in f64.

Counterpart of ``raider_tpu/geometry/orbit.py`` (interpolation and
geo2rdr; reading orbit files is not ported yet). The orbit is a small host
object; every evaluation moves its statevectors to the device of the query
tensor and runs there in float64.

Velocity and acceleration are the exact derivatives of the degree-7 Hermite
polynomial: the JAX package gets them with nested ``jax.jvp``; here the
first and second derivatives are carried through the Horner loop.
"""

import datetime as dt
from dataclasses import dataclass

import numpy as np
import torch

from raider_tpu_torch.geodesy.ellipsoid import as_f64


@dataclass(frozen=True)
class Orbit:
    """Orbit statevectors relative to a reference epoch.

    times: (n,) seconds since ``ref_time`` (strictly increasing, unique)
    pos:   (n, 3) ECEF positions [m]
    vel:   (n, 3) ECEF velocities [m/s]
    """

    times: np.ndarray
    pos: np.ndarray
    vel: np.ndarray
    ref_time: dt.datetime

    @property
    def direction(self) -> str:
        """'asc' or 'desc' from the z-trend."""
        start = int(np.argmin(self.times))
        end = int(np.argmax(self.times))
        return 'desc' if self.pos[start, 2] > self.pos[end, 2] else 'asc'

    def on(self, device):
        """(times, pos, vel) as float64 tensors on ``device``."""
        return tuple(torch.as_tensor(np.asarray(a), dtype=torch.float64, device=device)
                     for a in (self.times, self.pos, self.vel))


def _hermite_window(orbit_times, orbit_pos, orbit_vel, t):
    """The 4-statevector window around each query time ``t``."""
    n = orbit_times.shape[0]
    idx = torch.searchsorted(orbit_times, t.contiguous(), right=True) - 1
    i0 = (idx - 1).clamp(0, n - 4)
    win = i0[..., None] + torch.arange(4, device=t.device)   # (..., 4)
    return orbit_times[win], orbit_pos[win], orbit_vel[win]


def _hermite_coeffs(tw, pw, vw):
    """Leading Newton divided differences (..., 8, 3) with doubled nodes
    [t0, t0, t1, t1, t2, t2, t3, t3]; returns (coefficients, nodes)."""
    zt = torch.repeat_interleave(tw, 2, dim=-1)              # (..., 8)
    cur = torch.repeat_interleave(pw, 2, dim=-2)             # (..., 8, 3)
    lead = [cur[..., 0, :]]
    for order in range(1, 8):
        num = cur[..., 1:, :] - cur[..., :-1, :]
        den = (zt[..., order:] - zt[..., :8 - order])[..., None]
        nxt = num / den
        if order == 1:
            # repeated nodes: f[z_i, z_i] = f'(z_i) = velocity
            same = den[..., 0].abs() <= 1e-8
            fill = torch.zeros_like(nxt)
            fill[..., 0::2, :] = vw
            nxt = torch.where(same[..., None], fill, nxt)
        cur = nxt
        lead.append(cur[..., 0, :])
    return torch.stack(lead, dim=-2), zt


def _hermite_eval(tw, pw, vw, t, derivs: int = 0):
    """Position at ``t`` (..., 3) and its first ``derivs`` (0-2) derivatives,
    by Horner's rule on the Newton form, derivatives carried exactly."""
    c, zt = _hermite_coeffs(tw, pw, vw)
    res = c[..., 7, :]
    d1 = torch.zeros_like(res)
    d2 = torch.zeros_like(res)
    for k in range(6, -1, -1):
        dt_k = (t - zt[..., k])[..., None]
        if derivs >= 2:
            d2 = d2 * dt_k + 2.0 * d1
        if derivs >= 1:
            d1 = d1 * dt_k + res
        res = res * dt_k + c[..., k, :]
    return res, d1, d2


def interpolate_orbit(orbit_times, orbit_pos, orbit_vel, t):
    """Position and velocity at times ``t`` (any shape), float64.

    The orbit arrays may be numpy or tensors; the computation runs on the
    device of ``t`` when it is a tensor.
    """
    t = as_f64(t)
    ot, op, ov = (as_f64(a, t.device) for a in (orbit_times, orbit_pos, orbit_vel))
    tw, pw, vw = _hermite_window(ot, op, ov, t)
    p, v, _ = _hermite_eval(tw, pw, vw, t, derivs=1)
    return p, v


def geo2rdr(orbit_times, orbit_pos, orbit_vel, targ_xyz, maxiter: int = 15):
    """Zero-Doppler azimuth time and slant range for ECEF targets, batched.

    Solves dot(v_sat(t), x_sat(t) - x_targ) = 0 by ``maxiter`` fixed Newton
    iterations from the statevector span's midpoint, on the device of
    ``targ_xyz``. Roots outside the span, and NaN targets, give NaN.

    Returns (aztime (...,), slant_range (...,), sat_pos (..., 3), sat_vel (..., 3)).
    """
    targ = as_f64(targ_xyz)
    ot, op, ov = (as_f64(a, targ.device) for a in (orbit_times, orbit_pos, orbit_vel))
    t = torch.full(targ.shape[:-1], 0.5 * (float(ot[0]) + float(ot[-1])),
                   dtype=torch.float64, device=targ.device)
    for _ in range(maxiter):
        tw, pw, vw = _hermite_window(ot, op, ov, t)
        pos, vel, acc = _hermite_eval(tw, pw, vw, t, derivs=2)
        dr = pos - targ
        fn = torch.sum(vel * dr, dim=-1)
        fnprime = torch.sum(acc * dr, dim=-1) + torch.sum(vel * vel, dim=-1)
        t = t - fn / fnprime
    tw, pw, vw = _hermite_window(ot, op, ov, t)
    sat_pos, sat_vel, _ = _hermite_eval(tw, pw, vw, t, derivs=1)
    sr = torch.linalg.norm(sat_pos - targ, dim=-1)
    bad = torch.isnan(targ).any(dim=-1) | (t < ot[0]) | (t > ot[-1])
    nan = torch.full_like(t, float('nan'))
    return torch.where(bad, nan, t), torch.where(bad, nan, sr), sat_pos, sat_vel
