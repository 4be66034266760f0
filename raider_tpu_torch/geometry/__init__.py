"""Query geometry: areas of interest (AOI), lines of sight (LOS), orbits, rays."""

from raider_tpu_torch.geometry.aoi import AOI, BoundingBox  # noqa: F401
from raider_tpu_torch.geometry.los import LOS, Raytracing, Zenith  # noqa: F401
from raider_tpu_torch.geometry.orbit import Orbit  # noqa: F401
