"""Query geometry: areas of interest (AOI), lines of sight (LOS), orbits, rays."""

from raider_tpu_torch.geometry.aoi import (  # noqa: F401
    AOI,
    BoundingBox,
    GeocodedFile,
    Geocube,
    RasterRDR,
    StationFile,
    bounds_from_csv,
)
from raider_tpu_torch.geometry.los import LOS, Conventional, Raytracing, Zenith  # noqa: F401
from raider_tpu_torch.geometry.orbit import Orbit, get_orbit, state_to_los_factor  # noqa: F401
