"""Areas of interest: where delays are computed.

Counterpart of ``raider_tpu/geometry/aoi.py`` for the cube path: the
``AOI`` base and ``BoundingBox``. The point-type AOIs (station files,
radar and geocoded rasters, geocubes) are not ported yet (ROADMAP A).
"""

import os
from typing import Optional

import numpy as np

from raider_tpu_torch.geodesy import CRS, Geographic, crs_from_user, transform_points
from raider_tpu_torch.logger import logger
from raider_tpu_torch.utils.bbox import clip_bbox


def transform_bbox(snwe_in, dest_crs=4326, src_crs=4326, buffer: float = 100.0):
    """Transform an SNWE bbox into another CRS by sampling a perimeter grid."""
    src = crs_from_user(src_crs)
    dst = crs_from_user(dest_crs)
    if src.is_geographic:
        buffer = buffer / 1.0e5
    if src == dst:
        return snwe_in
    xs = np.linspace(snwe_in[2] - buffer, snwe_in[3] + buffer, num=11)
    ys = np.linspace(snwe_in[0] - buffer, snwe_in[1] + buffer, num=11)
    xg, yg = np.meshgrid(xs, ys)
    xx, yy = (np.asarray(v) for v in transform_points(src, dst, xg, yg)[:2])
    return [np.nanmin(yy), np.nanmax(yy), np.nanmin(xx), np.nanmax(xx)]


class AOI:
    """Base area-of-interest."""

    def __init__(self, cube_spacing_in_m: Optional[float] = None) -> None:
        self._output_directory = os.getcwd()
        self._bounding_box = None
        self._proj: CRS = Geographic()
        self._geotransform = None
        self._cube_spacing_m = cube_spacing_in_m
        self._output_spacing = None
        self._type = 'unknown'

    def __repr__(self) -> str:
        return f'AOI: {self.__class__.__name__}({self._bounding_box}, {self._type})'

    def type(self) -> str:
        return self._type

    def bounds(self) -> list:
        return list(self._bounding_box).copy()

    def projection(self) -> CRS:
        return self._proj

    def get_output_spacing(self, crs=4326) -> float:
        """Output spacing in the units of ``crs``."""
        spacing = self._output_spacing
        return spacing if crs_from_user(crs).is_geographic else spacing * 1e5

    def set_output_spacing(self, ll_res: Optional[float] = None) -> None:
        if not (ll_res or self._cube_spacing_m):
            raise ValueError('Must pass lat/lon resolution if _cube_spacing_m is None')
        out_spacing = self._cube_spacing_m / 1e5 if self._cube_spacing_m else ll_res
        logger.debug('Output cube spacing: %s degrees', out_spacing)
        self._output_spacing = out_spacing

    def add_buffer(self, ll_res: float, digits: int = 2) -> None:
        """Buffer the AOI by 1.5 grid cells and clip to the output spacing."""
        S, N, W, E = self.bounds()
        buffer = 1.5 * ll_res
        S, N = max(S - buffer, -90.0), min(N + buffer, 90.0)
        W, E = W - buffer, E + buffer
        self.set_output_spacing(ll_res)
        S, N, W, E = clip_bbox([S, N, W, E], self._output_spacing)
        if max(abs(W), abs(E)) > 180:
            logger.warning('Bounds extend past +/- 180. Results may be incorrect.')
        self._bounding_box = [round(v, digits) for v in (S, N, W, E)]

    def set_output_directory(self, output_directory: str) -> None:
        self._output_directory = output_directory

    def set_output_xygrid(self, dst_crs=4326) -> None:
        """Define the output cube x/y grid (host numpy axes)."""
        out_proj = crs_from_user(dst_crs)
        out_snwe = transform_bbox(self.bounds(), src_crs=4326, dest_crs=out_proj)
        logger.debug('Output SNWE: %s', out_snwe)
        out_spacing = self.get_output_spacing(out_proj)
        self.xpts = np.arange(out_snwe[2], out_snwe[3] + out_spacing, out_spacing)
        self.ypts = np.arange(out_snwe[1], out_snwe[0] - out_spacing, -out_spacing)


class BoundingBox(AOI):
    """Simple SNWE bounding box."""

    def __init__(self, bbox, cube_spacing_in_m: Optional[float] = None) -> None:
        super().__init__(cube_spacing_in_m)
        self._bounding_box = bbox
        self._type = 'bounding_box'
