"""Datasets in memory, netCDF files for them (h5py only inside the readers),
and rasters: ENVI, VRT and GeoTIFF without GDAL."""

from raider_tpu_torch.io.geotiff import read_gtiff, write_gtiff  # noqa: F401
from raider_tpu_torch.io.ncdf import Dataset, Variable, read_nc, write_nc  # noqa: F401
from raider_tpu_torch.io.rasters import (  # noqa: F401
    GDALAffine,
    bounds_from_latlon_rasters,
    get_file_and_band,
    read_envi,
    read_vrt,
    rio_extents,
    rio_open,
    rio_profile,
    rio_stats,
    writeArrayToRaster,
    write_envi,
)
