"""Lines of sight: Zenith and Raytracing.

Counterpart of ``raider_tpu/geometry/los.py``. Raytracing look vectors come
from one batched geo2rdr solve on the device of the pixel tensors. The
projected (Conventional) LOS and reading orbits from files are not ported
yet (ROADMAP A).
"""

from typing import Optional

from raider_tpu_torch.geometry.orbit import Orbit, geo2rdr


class LOS:
    """Base class for handling look vectors."""

    def __init__(self) -> None:
        self._lats, self._lons, self._heights = None, None, None
        self._look_vecs = None
        self._ray_trace = False
        self._is_zenith = False
        self._is_projected = False
        self._time = None

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

    def __call__(self, delays):
        return delays


class Raytracing(LOS):
    """True slant raytracing: per-pixel look vectors from orbit geometry."""

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
        if orbit is None and filename is not None:
            raise NotImplementedError('reading orbit files is not ported to '
                                      'raider_tpu_torch yet; pass orbit=')

    def getSensorDirection(self) -> str:
        if self._orbit is None:
            raise ValueError('The orbit has not been set')
        return self._orbit.direction

    def getLookDirection(self) -> str:
        return self._look_dir

    def getLookVectors(self, ht, llh, xyz, yy=None):
        """Unit look vectors (target -> sensor, ECEF) for (..., 3) float64
        ECEF pixel tensors, on their device. Pixels whose geo2rdr fails
        (NaN input, root outside the orbit span) get NaN look vectors."""
        if self._orbit is None:
            raise ValueError('The orbit has not been set')
        _, slant_range, sat_pos, _ = geo2rdr(*self._orbit.on(xyz.device), xyz)
        return (sat_pos - xyz) / slant_range[..., None]
