"""Lines of sight: Zenith, Conventional (projected) and Raytracing.

Counterpart of ``raider_tpu/geometry/los.py``. Raytracing look vectors come
from one batched geo2rdr solve on the device of the pixel tensors; its
orbit is an :class:`Orbit` or a statevector file read through
``get_orbit``. A Conventional LOS divides delays by the projection factor
cos(incidence), taken from a 2-band incidence/heading raster or, when the
file is not a raster, from an orbit file (``state_to_los_factor`` on the
device of the points).
"""

from typing import Optional

import numpy as np
import torch

from raider_tpu_torch.geodesy.ellipsoid import as_f64, geodetic_normal
from raider_tpu_torch.geometry.orbit import Orbit, geo2rdr, get_orbit, state_to_los_factor


def sind(x):
    return np.sin(np.radians(x))


def cosd(x):
    return np.cos(np.radians(x))


class LOS:
    """Base class for handling look vectors."""

    def __init__(self) -> None:
        self._lats, self._lons, self._heights = None, None, None
        self._look_vecs = None
        self._ray_trace = False
        self._is_zenith = False
        self._is_projected = False
        self._time = None

    def setPoints(self, lats, lons=None, heights=None) -> None:
        """Target points: arrays or tensors of lat, lon (and height), or one
        (..., 3) lat/lon/height array as ``lats``."""
        if lats is None and self._lats is None:
            raise RuntimeError("You haven't given any point locations yet")
        if lons is None:
            llh = lats
            self._lats = llh[..., 0]
            self._lons = llh[..., 1]
            self._heights = llh[..., 2]
        elif heights is None:
            self._lats = lats
            self._lons = lons
            self._heights = np.zeros((len(lats), 1))
        else:
            self._lats = lats
            self._lons = lons
            self._heights = heights

    def setTime(self, datetime) -> None:
        self._time = datetime

    def is_Zenith(self) -> bool:
        return self._is_zenith

    def is_Projected(self) -> bool:
        return self._is_projected

    def ray_trace(self) -> bool:
        return self._ray_trace


class Zenith(LOS):
    """Zenith delays: look vectors are ellipsoid normals."""

    def __init__(self) -> None:
        super().__init__()
        self._is_zenith = True

    def setLookVectors(self) -> None:
        if self._lats is None:
            raise ValueError('Target points not set')
        if self._look_vecs is None:
            self._look_vecs = geodetic_normal(self._lats, self._lons)

    def __call__(self, delays):
        return delays


class Conventional(LOS):
    """Projected slant delays: zenith delay / cos(incidence).

    ``filename`` is a 2-band incidence/heading raster [deg] or, when it
    cannot be read as a raster, an orbit file read around the LOS's time.
    """

    def __init__(self, filename=None, los_convention: str = 'isce', time=None,
                 pad: int = 600) -> None:
        super().__init__()
        self._file = filename
        self._time = time
        self._pad = pad
        self._is_projected = True
        self._convention = los_convention
        if self._convention.lower() != 'isce':
            raise NotImplementedError()

    def __call__(self, delays):
        """``delays`` (array or tensor, the points' shape) divided by the
        projection factor; a tensor stays on its device."""
        if self._lats is None:
            raise ValueError('Target points not set')
        if self._file is None:
            raise ValueError('LOS file not set')

        try:
            from raider_tpu_torch.io.rasters import rio_open

            data, _ = rio_open(self._file)
            los_enu = inc_hd_to_enu(*data)
            factor = los_enu[..., -1]
        except (OSError, TypeError, ValueError):
            orbit = get_orbit(self._file, self._time, self._pad)
            factor = state_to_los_factor(orbit, self._lats, self._lons, self._heights)

        if isinstance(delays, torch.Tensor):
            return delays / as_f64(factor, delays.device)
        return delays / (factor.cpu().numpy() if isinstance(factor, torch.Tensor) else factor)


class Raytracing(LOS):
    """True slant raytracing: per-pixel look vectors from orbit geometry.

    The orbit is ``orbit``, or read from ``filename`` (a statevector file
    or a list of them) around ``time`` when both are given.
    """

    def __init__(self, filename=None, los_convention: str = 'isce', time=None,
                 look_dir: str = 'right', pad: int = 600,
                 orbit: Optional[Orbit] = None) -> None:
        super().__init__()
        self._ray_trace = True
        self._file = filename
        self._time = time
        self._pad = pad
        self._convention = los_convention
        self._orbit: Optional[Orbit] = orbit
        if self._convention.lower() != 'isce':
            raise NotImplementedError()
        if look_dir.lower() not in ('right', 'left'):
            raise RuntimeError(f'Unknown look direction: {look_dir}')
        self._look_dir = look_dir.lower()
        if orbit is None and self._time is not None and self._file is not None:
            self._orbit = get_orbit(self._file, self._time, pad=pad)

    def getSensorDirection(self) -> str:
        if self._orbit is None:
            raise ValueError('The orbit has not been set')
        return self._orbit.direction

    def getLookDirection(self) -> str:
        return self._look_dir

    def setTime(self, time, pad: Optional[int] = None) -> None:
        """Reload the orbit file around ``time``, with the constructor's pad
        unless ``pad`` is given."""
        self._time = time
        self._orbit = get_orbit(self._file, self._time,
                                pad=self._pad if pad is None else pad)

    def getLookVectors(self, ht, llh, xyz, yy=None):
        """Unit look vectors (target -> sensor, ECEF) for (..., 3) float64
        ECEF pixel tensors, on their device. Pixels whose geo2rdr fails
        (NaN input, root outside the orbit span) get NaN look vectors."""
        if self._orbit is None:
            raise ValueError('The orbit has not been set')
        _, slant_range, sat_pos, _ = geo2rdr(*self._orbit.on(xyz.device), xyz)
        return (sat_pos - xyz) / slant_range[..., None]


def getZenithLookVecs(lats, lons, heights):
    """Unit zenith look vectors in ECEF, (..., 3) float64."""
    return geodetic_normal(lats, lons)


def inc_hd_to_enu(incidence, heading):
    """Incidence/heading (deg) to ENU unit look vectors (host numpy)."""
    if np.any(incidence < 0):
        raise ValueError('inc_hd_to_enu: Incidence angle cannot be less than 0')
    east = sind(incidence) * cosd(heading + 90)
    north = sind(incidence) * sind(heading + 90)
    up = cosd(incidence)
    return np.stack((east, north, up), axis=-1)
