"""Satellite orbit: statevector files, Hermite interpolation, a batched
geo2rdr and the projection factor of a projected LOS, in f64.

Counterpart of ``raider_tpu/geometry/orbit.py``. The readers are host code
copied from it: ESA EOF XML, 7-column text (ISO time, x y z, vx vy vz) and
ISCE2 shelve databases, and ``get_orbit`` pads, sorts and de-duplicates
their statevectors around a reference time. The orbit is a small host
object; every evaluation moves its statevectors to the device of the query
tensor and runs there in float64.

Velocity and acceleration are the exact derivatives of the degree-7 Hermite
polynomial: the JAX package gets them with nested ``jax.jvp``; here the
first and second derivatives are carried through the Horner loop.
"""

import datetime as dt
import os
import xml.etree.ElementTree as ET
from dataclasses import dataclass
from pathlib import PosixPath
from typing import List, Tuple, Union

import numpy as np
import torch

from raider_tpu_torch.geodesy.ellipsoid import as_f64, geodetic_normal, lla2ecef


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


def read_ESA_orbit_file(filename) -> Tuple[list, np.ndarray, np.ndarray]:
    """Parse an ESA EOF orbit XML into (datetimes, pos, vel)."""
    tree = ET.parse(filename)
    root = tree.getroot()
    osv_list = root.find('.//List_of_OSVs')
    if osv_list is None:
        # positional fallback used by the reference
        osv_list = root[1][0]
    t, pos, vel = [], [], []
    for osv in osv_list:
        utc = osv.find('UTC').text
        t.append(dt.datetime.strptime(utc, 'UTC=%Y-%m-%dT%H:%M:%S.%f'))
        pos.append([float(osv.find(k).text) for k in ('X', 'Y', 'Z')])
        vel.append([float(osv.find(k).text) for k in ('VX', 'VY', 'VZ')])
    return t, np.asarray(pos, dtype=np.float64), np.asarray(vel, dtype=np.float64)


def read_txt_file(filename) -> Tuple[list, np.ndarray, np.ndarray]:
    """Parse 7-column statevector text: ISO time, x y z, vx vy vz."""
    t, pos, vel = [], [], []
    with open(filename) as f:
        for line in f:
            parts = line.strip().split()
            if not parts:
                continue
            try:
                t.append(dt.datetime.fromisoformat(parts[0]))
                vals = [float(v) for v in parts[1:7]]
                if len(vals) != 6:
                    # slicing never raises: a 4-6 column row would yield
                    # malformed (n, <3) velocity arrays downstream
                    raise ValueError('short row')
            except (ValueError, IndexError):
                raise ValueError(
                    f'I need {filename} to be a 7 column text file with columns '
                    f"t, x, y, z, vx, vy, vz (couldn't parse line {line!r})"
                )
            pos.append(vals[:3])
            vel.append(vals[3:])
    if len(t) < 4:
        raise ValueError(f'read_txt_file: file {filename} does not have enough statevectors')
    return t, np.asarray(pos, dtype=np.float64), np.asarray(vel, dtype=np.float64)


def read_shelve_file(filename) -> Tuple[list, np.ndarray, np.ndarray]:
    """Parse an ISCE2-style shelve database holding a ``frame`` object with
    ``frame.orbit.stateVectors`` (each with .time/.position/.velocity)
    into (datetimes, pos, vel)."""
    import shelve

    with shelve.open(str(filename), 'r') as db:
        obj = db['frame']
    svs = obj.orbit.stateVectors
    if len(svs) == 0:
        raise ValueError('read_shelve_file: the file has no statevectors')
    t = [sv.time for sv in svs]
    pos = np.asarray([sv.position for sv in svs], dtype=np.float64)
    vel = np.asarray([sv.velocity for sv in svs], dtype=np.float64)
    return t, pos, vel


def filter_ESA_orbit_file(orbit_xml: str, ref_time: dt.datetime) -> bool:
    """True if the EOF filename's validity window contains ref_time."""
    f = os.path.basename(str(orbit_xml))
    t0 = dt.datetime.strptime(f.split('_')[6].lstrip('V'), '%Y%m%dT%H%M%S')
    t1 = dt.datetime.strptime(f.split('_')[7].rstrip('.EOF'), '%Y%m%dT%H%M%S')
    return t0 < ref_time < t1


def pick_ESA_orbit_file(list_files: list, ref_time: dt.datetime):
    for path in list_files:
        if filter_ESA_orbit_file(path, ref_time):
            return path
    raise AssertionError('Given orbit files did not match given date/time')


def cut_times(times, ref_time, pad: float = 600.0) -> np.ndarray:
    """Boolean mask of statevector times within ``pad`` seconds of
    ``ref_time``. ``times`` and ``ref_time`` may be seconds (numeric) or
    datetimes."""
    times = np.asarray(times)
    if times.dtype.kind in 'Mm' or isinstance(ref_time, dt.datetime):
        diffs = np.array([(t - ref_time).total_seconds() for t in times])
    else:
        diffs = times.astype(np.float64) - float(ref_time)
    return np.abs(diffs) < pad


def get_orbit(orbit_file: Union[str, list, PosixPath], ref_time: dt.datetime,
              pad: int = 600) -> Orbit:
    """Load statevectors around ``ref_time`` into an :class:`Orbit`: those
    within ``pad`` seconds (when at least 4 are), sorted, one per time."""
    files = [orbit_file] if isinstance(orbit_file, (str, PosixPath)) else list(orbit_file)

    t_all: List[dt.datetime] = []
    pos_all, vel_all = [], []

    def _try_parse(path):
        errors = []
        # OSError included: shelve DBs may exist only with a dbm suffix
        # (path.dat/.dir), so opening `path` as text raises FileNotFoundError
        try:
            return read_txt_file(path)
        except (ValueError, UnicodeDecodeError, OSError) as e:
            errors.append(f'txt: {e}')
        try:
            return read_ESA_orbit_file(path)
        except Exception as e:
            errors.append(f'EOF: {e}')
        try:
            return read_shelve_file(path)
        except Exception as e:
            errors.append(f'shelve: {e}')
        raise ValueError(
            f'get_orbit: cannot parse the statevector file {path}: '
            + '; '.join(errors))

    def _filter_safe(path):
        # non-standard EOF names can't be windowed by filename; keep them
        try:
            return filter_ESA_orbit_file(path, ref_time)
        except (IndexError, ValueError):
            return True

    esa = [f for f in files if str(f).endswith('.EOF')]
    if esa and ref_time is not None:
        candidates = sorted(set(map(str, esa)))
        candidates = [f for f in candidates if _filter_safe(f)] or candidates
        # time-filter only the EOF subset; non-EOF statevector files the
        # caller passed alongside still contribute
        files = [f for f in files if not str(f).endswith('.EOF')] + candidates
    for f in files:
        t, pos, vel = _try_parse(f)
        t_all.extend(t)
        pos_all.append(pos)
        vel_all.append(vel)
    pos = np.concatenate(pos_all, axis=0)
    vel = np.concatenate(vel_all, axis=0)

    # make timezone-naive UTC
    t_all = [x.replace(tzinfo=None) for x in t_all]
    ref = ref_time.replace(tzinfo=None) if ref_time is not None else t_all[0]
    secs = np.array([(x - ref).total_seconds() for x in t_all], dtype=np.float64)

    if ref_time is not None and pad is not None:
        keep = np.abs(secs) < pad
        if keep.sum() >= 4:
            secs, pos, vel = secs[keep], pos[keep], vel[keep]

    order = np.argsort(secs)
    secs, pos, vel = secs[order], pos[order], vel[order]
    _, unique_idx = np.unique(secs, return_index=True)
    secs, pos, vel = secs[unique_idx], pos[unique_idx], vel[unique_idx]

    if secs.size < 4:
        raise ValueError('At least 4 statevectors are required for orbit interpolation')
    return Orbit(times=secs, pos=pos, vel=vel, ref_time=ref)


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


def state_to_los_factor(orbit: Orbit, lats, lons, heights) -> torch.Tensor:
    """cos(incidence) at targets: the projection factor of the projected
    (Conventional) LOS, the cosine between the unit target-to-sensor vector
    at zero Doppler and the local ellipsoid normal. Float64 on the device
    of ``lats`` (a tensor), else on the CPU."""
    lat = as_f64(lats)
    x, y, z = lla2ecef(lat, lons, heights)
    targ = torch.stack([x, y, z], dim=-1)
    _, _, sat_pos, _ = geo2rdr(*orbit.on(lat.device), targ)
    delta = sat_pos - targ
    delta = delta / torch.linalg.norm(delta, dim=-1, keepdim=True)
    return torch.sum(delta * geodetic_normal(lat, lons), dim=-1)
