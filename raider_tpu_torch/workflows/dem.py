"""DEM acquisition and interpolation (capability: reference tools/RAiDER/dem.py).

Counterpart of ``raider_tpu/workflows/dem.py``, copied as it is. Downloading
GLO-30 requires the ``dem_stitcher`` service, which needs network egress: the
port reads a DEM file that is already on disk, and the stitching branch
imports ``dem_stitcher`` inside the function and raises where it is absent.
``interpolate_dem`` samples the DEM on the host with scipy.
"""

from pathlib import Path
from typing import Tuple

import numpy as np

from raider_tpu_torch.logger import logger


def download_dem(ll_bounds=None, writeDEM: bool = False, outName=None,
                 buf: float = 0.02, overwrite: bool = False,
                 dem_path: Path = Path('GLO30_fullres_dem.tif')) -> Tuple:
    """Download and/or load a GLO-30 DEM over the AOI
    (reference: dem.py:20-74). Reuses an existing file when present.
    ``outName`` is an alias for ``dem_path`` (the reference's parameter
    name); it wins when both are given."""
    if outName is not None:
        dem_path = Path(outName)
    if Path(dem_path).exists() and not overwrite:
        logger.info('Using existing DEM: %s', dem_path)
        from raider_tpu_torch.io.rasters import rio_open

        zvals, metadata = rio_open(dem_path)
        return zvals, metadata

    if ll_bounds is None:
        # no existing file and nothing to download over (reference: dem.py:33)
        raise ValueError('download_dem: you must supply either an existing '
                         'DEM file or ll_bounds to download over')

    try:
        import dem_stitcher  # noqa: F401
    except ImportError:
        raise ImportError(
            'DEM download requires the dem_stitcher package (and network '
            'access), which is unavailable in this environment. Provide '
            'station heights (Hgt_m), a height file, or a pre-downloaded DEM.'
        )
    # dem_stitcher path (network): stitch, optionally write, return
    import rasterio  # noqa: F401  (dem_stitcher implies rasterio)
    from dem_stitcher.stitcher import stitch_dem

    ll_bounds = np.array(ll_bounds)
    bounds = [
        np.floor(ll_bounds[2]) - buf, np.floor(ll_bounds[0]) - buf,
        np.ceil(ll_bounds[3]) + buf, np.ceil(ll_bounds[1]) + buf,
    ]
    zvals, metadata = stitch_dem(bounds, dem_name='glo_30', dst_ellipsoidal_height=True, dst_area_or_point='Area')
    if writeDEM:
        with rasterio.open(dem_path, 'w', **metadata) as ds:
            ds.write(zvals, 1)
            ds.update_tags(AREA_OR_POINT='Point')
        logger.info('Wrote DEM: %s', dem_path)
    return zvals, metadata


def interpolate_dem(dem_path, out_ll: Tuple[np.ndarray, np.ndarray], method: str = 'nearest') -> np.ndarray:
    """Interpolate a DEM raster to query lat/lons
    (reference: interpolator.py:133-217).

    DEMs stored in a projected CRS are handled by transforming the query
    points into the DEM's CRS and sampling the native grid — exact where the
    reference's reproject_raster (interpolator.py:188-217) first warps the
    raster to EPSG:4326 with nearest resampling.
    """
    from scipy.interpolate import RegularGridInterpolator

    from raider_tpu_torch.io.rasters import rio_open

    data, profile = rio_open(dem_path)
    gt = profile['transform'].to_gdal()
    ny, nx = data.shape[-2:]
    # pixel CENTERS: the geotransform origin is the outer corner, and the
    # reference interpolates on rioxarray center coords (interpolator.py:149)
    xs = gt[0] + (np.arange(nx) + 0.5) * gt[1]
    ys = gt[3] + (np.arange(ny) + 0.5) * gt[5]
    lats, lons = out_ll
    crs = profile.get('crs')
    if crs is not None and not getattr(crs, 'is_geographic', False):
        from raider_tpu_torch.geodesy import Geographic, transform_points

        qx, qy = transform_points(Geographic(), crs, np.asarray(lons, dtype=np.float64),
                                  np.asarray(lats, dtype=np.float64))[:2]
        lats, lons = np.asarray(qy), np.asarray(qx)
    if ys[0] > ys[-1]:
        ys = ys[::-1]
        data = data[..., ::-1, :]
    rgi = RegularGridInterpolator((ys, xs), data.squeeze(), method=method,
                                  bounds_error=False, fill_value=np.nan)
    pts = np.stack([np.asarray(lats).ravel(), np.asarray(lons).ravel()], axis=-1)
    out = rgi(pts)
    return out.reshape(np.broadcast(np.asarray(lats), np.asarray(lons)).shape)
