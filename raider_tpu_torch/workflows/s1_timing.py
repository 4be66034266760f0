"""Sentinel-1 azimuth-time interpolation support.

The counterpart of ``raider_tpu/workflows/s1_timing.py``. The per-voxel
azimuth-time grid is one batched ``geo2rdr`` solve in float64 on the
device (the card unless the caller names another), rounded to
milliseconds on the host. Model epochs are found with ``datetime``
arithmetic (no pandas).
"""

import datetime as dt
from typing import List, Optional

import numpy as np
import torch

from raider_tpu_torch.geodesy.ellipsoid import lla2ecef
from raider_tpu_torch.geometry.orbit import Orbit, geo2rdr, get_orbit
from raider_tpu_torch.logger import logger
from raider_tpu_torch.utils import require_device

SPEED_OF_LIGHT = 299792458.0
_EPOCH = dt.datetime(1970, 1, 1)


def get_azimuth_time_grid(lon_mesh, lat_mesh, hgt_mesh, orb: Orbit, *,
                          device='cuda') -> np.ndarray:
    """Zero-Doppler azimuth time (+ range delay) per voxel, batched in
    float64 on ``device``.

    Returns a host datetime64[ms] array shaped like the input meshes (NaT
    where geo2rdr finds no root).
    """
    device = require_device(device)
    lat, lon, hgt = (torch.as_tensor(np.array(a, dtype=np.float64), device=device)
                     for a in (lat_mesh, lon_mesh, hgt_mesh))
    targ = torch.stack(lla2ecef(lat, lon, hgt), dim=-1)
    aztime, slant_range, _, _ = geo2rdr(*orb.on(device), targ)
    aztime = (aztime + slant_range / SPEED_OF_LIGHT).cpu().numpy()

    ref = np.datetime64(orb.ref_time.replace(tzinfo=None), 'ms')
    ms = np.round(aztime * 1000.0)
    out = ref + ms.astype('timedelta64[ms]')
    out = np.where(np.isnan(aztime), np.datetime64('NaT', 'ms'), out)
    return out.astype('datetime64[ms]')


def get_s1_azimuth_time_grid(lon, lat, hgt, time: dt.datetime, *,
                             device='cuda') -> np.ndarray:
    """Azimuth-time grid for the S1 pass nearest ``time``, computed on
    ``device``. Looks up the SLCs and their orbits (asf_search, s1_orbits);
    when the look-up fails, the grid is ``time`` everywhere, as in the JAX
    package (that is its semantics, not a fallback of the device)."""
    try:
        slc_ids = get_slc_ids_from_time(lon, lat, time)
        orb_files = get_orbits_from_slc_ids_hyp3lib(slc_ids)
        orb = get_orbit(orb_files, time, pad=600)
    except Exception as e:
        logger.warning('Using constant azimuth time grid: %s', e)
        shape = np.broadcast(np.asarray(lon), np.asarray(lat), np.asarray(hgt)).shape
        return np.full(shape, np.datetime64(time.replace(tzinfo=None), 'ms'))

    return get_azimuth_time_grid(lon, lat, hgt, orb, device=device)


def get_slc_ids_from_time(lon, lat, time: dt.datetime) -> list:
    """ASF catalog query for S1 SLCs over the AOI around ``time``."""
    import asf_search as asf

    lon = np.asarray(lon)
    lat = np.asarray(lat)
    wkt = (
        f'POLYGON(({lon.min()} {lat.min()},{lon.max()} {lat.min()},'
        f'{lon.max()} {lat.max()},{lon.min()} {lat.max()},{lon.min()} {lat.min()}))'
    )
    results = asf.geo_search(
        intersectsWith=wkt,
        processingLevel=asf.PRODUCT_TYPE.SLC,
        start=time - dt.timedelta(minutes=5),
        end=time + dt.timedelta(minutes=5),
        platform=asf.PLATFORM.SENTINEL1,
    )
    return [r.properties['sceneName'] for r in results]


def get_orbits_from_slc_ids_hyp3lib(slc_ids: list, orbit_directory: Optional[str] = None) -> list:
    """Fetch precise orbits for SLC ids, deduplicated and sorted."""
    import pathlib

    import s1_orbits

    orbit_dir = pathlib.Path(orbit_directory or 'orbits')
    orbit_dir.mkdir(exist_ok=True)
    orbits = {str(s1_orbits.fetch_for_scene(scene, orbit_dir)) for scene in slc_ids}
    return sorted(orbits)


def _floor_to(t: dt.datetime, step: dt.timedelta) -> dt.datetime:
    """pandas' ``Timestamp.floor``: the latest multiple of ``step`` since
    the Unix epoch at or before ``t`` (in ``t``'s wall time)."""
    naive = t.replace(tzinfo=None)
    return (_EPOCH + (naive - _EPOCH) // step * step).replace(tzinfo=t.tzinfo)


def _ceil_to(t: dt.datetime, step: dt.timedelta) -> dt.datetime:
    """pandas' ``Timestamp.ceil``: the earliest multiple of ``step`` since
    the Unix epoch at or after ``t``."""
    naive = t.replace(tzinfo=None)
    return (_EPOCH - (_EPOCH - naive) // step * step).replace(tzinfo=t.tzinfo)


def get_n_closest_datetimes(ref_time: dt.datetime, n_target_times: int,
                            time_step_hours: int) -> List[dt.datetime]:
    """The ``n_target_times`` model epochs (multiples of
    ``time_step_hours``) closest to ``ref_time``, nearest first, ties to
    the earlier."""
    if (24 % time_step_hours) != 0:
        raise ValueError(
            'The time step does not evenly divide 24 hours; time step has '
            'period > 1 day and depends when model starts'
        )
    iterations = int(np.ceil(n_target_times / 2))
    closest_times = []
    step = dt.timedelta(hours=time_step_hours)
    for k in range(iterations):
        t_ceil = _floor_to(ref_time - step * k, step)
        t_floor = _ceil_to(ref_time + step * k, step)
        closest_times.extend(list({t_ceil, t_floor}))
    closest_times = sorted(closest_times, key=lambda t: (abs(ref_time - t), t))
    return closest_times[:n_target_times]


def get_times_for_azimuth_interpolation(ref_time: dt.datetime, time_step_hours: int,
                                        buffer_in_seconds: int = 300) -> List[dt.datetime]:
    """2-3 model epochs needed for azimuth interpolation."""
    closest_times = get_n_closest_datetimes(ref_time, 3, time_step_hours)
    upper = time_step_hours * 3600 + buffer_in_seconds
    return [t for t in closest_times if abs((ref_time - t).total_seconds()) < upper]


def get_inverse_weights_for_dates(
    azimuth_time_array: np.ndarray,
    dates: List[dt.datetime],
    inverse_regularizer: float = 1e-9,
    temporal_window_hours: Optional[float] = None,
) -> List[np.ndarray]:
    """Per-pixel inverse-|dt| weights for each date."""
    n_dates = len(dates)
    if len(set(dates)) != n_dates:
        raise ValueError('Dates provided must be unique')
    if n_dates == 0:
        raise ValueError('No dates provided')
    if not all(isinstance(d, dt.datetime) for d in dates):
        raise TypeError('dates must be all datetimes')

    if temporal_window_hours is None:
        temporal_window_seconds = min(
            abs((date - dates[0]).total_seconds()) for date in dates[1:]
        )
    else:
        temporal_window_seconds = temporal_window_hours * 3600

    dates_np = [np.datetime64(d.replace(tzinfo=None)) for d in dates]
    abs_diff = [np.abs(azimuth_time_array - d) / np.timedelta64(1, 's') for d in dates_np]
    wgts = [1.0 / (diff + inverse_regularizer) for diff in abs_diff]
    masks = [(diff <= temporal_window_seconds).astype(int) for diff in abs_diff]
    if all(mask.sum() == 0 for mask in masks):
        raise ValueError('No dates provided are within temporal window')
    wgts_masked = [w * m for w, m in zip(wgts, masks)]
    wgts_sum = np.sum(np.stack(wgts_masked, axis=-1), axis=-1)
    return [w / wgts_sum for w in wgts_masked]
