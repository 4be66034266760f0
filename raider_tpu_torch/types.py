"""Shared type aliases: the counterpart of ``raider_tpu/types.py``."""

from typing import Literal, Tuple, Union

LookDir = Literal['right', 'left']
TimeInterpolationMethod = Literal['none', 'center_time', 'azimuth_time_grid']

CRSLike = Union[int, str, 'object']


class RIO:
    """Raster profile and statistics types."""

    GDAL = Tuple[float, float, float, float, float, float]

    class Statistics:
        def __init__(self, max: float, mean: float, min: float, std: float) -> None:
            self.max, self.mean, self.min, self.std = max, mean, min, std

    # a raster profile is a plain dict in this framework (io/rasters.py):
    # keys driver, width, height, count, crs, transform, dtype, nodata
    Profile = dict


class BB:
    """Bounding-box tuple conventions."""

    SNWE = Tuple[float, float, float, float]
    WSEN = Tuple[float, float, float, float]
    SN = Tuple[float, float]
    WE = Tuple[float, float]
