"""Areas of interest: where delays are computed.

Counterpart of ``raider_tpu/geometry/aoi.py``: bounding boxes and geocubes
(cube-type AOIs, answered with a delay cube), and the point-type AOIs, GNSS
station CSV files, radar-coordinate lat/lon rasters and geocoded rasters
(answered at their points). The JAX package reads station CSVs with pandas;
the port reads them with the stdlib ``csv`` module and numpy, to the same
values (:func:`read_station_csv`), so no pandas is needed.
"""

import csv
import math
import os
from pathlib import Path
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

    def geotransform(self):
        return self._geotransform

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

    def calc_buffer_ray(self, direction: str, lookDir: str = 'right', incAngle: float = 30,
                        maxZ: float = 80, digits: int = 2) -> list:
        """The AOI's bounds extended east or west toward the sensor for
        raytracing. ``lookDir`` is a string or an object with ``.name``."""
        direction = direction.lower()
        lookDir = getattr(lookDir, 'name', lookDir).lower()
        if direction not in ('asc', 'desc'):
            raise ValueError(f'Incorrect orbital direction: {direction}')
        if lookDir not in ('right', 'left'):
            raise ValueError(f'Incorrect look direction: {lookDir}')

        S, N, W, E = self.bounds()
        lat_max = max(abs(S), abs(N))
        near = maxZ * np.tan(np.deg2rad(incAngle))
        buffer = near / (np.cos(np.deg2rad(lat_max)) * 100)

        if (lookDir, direction) in (('right', 'asc'), ('left', 'desc')):
            W = W - buffer
        else:
            E = E + buffer
        bounds = [round(float(v), digits) for v in (S, N, W, E)]
        if max(abs(bounds[2]), abs(bounds[3])) > 180:
            logger.warning('Bounds extend past +/- 180. Results may be incorrect.')
        return bounds

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

    def readLL(self):
        raise NotImplementedError

    def readZ(self):
        raise NotImplementedError


class BoundingBox(AOI):
    """Simple SNWE bounding box."""

    def __init__(self, bbox, cube_spacing_in_m: Optional[float] = None) -> None:
        super().__init__(cube_spacing_in_m)
        self._bounding_box = bbox
        self._type = 'bounding_box'


def read_station_csv(station_file):
    """A station CSV as (header, rows, lat, lon): its column names, its text
    rows, and the Lat and Lon columns as float64, duplicates of the
    (Lat, Lon) pair dropped with the first kept.

    The semantics of ``pd.read_csv(f).drop_duplicates(subset=['Lat', 'Lon'])``,
    read with the stdlib: columns may come in any order and extra ones are
    ignored, an empty field is NaN, and two pairs are duplicates when their
    values are equal, NaN counting as equal to NaN (and 0.0 to -0.0).
    """
    with open(station_file, newline='') as f:
        reader = csv.reader(f)
        header = next(reader)
        rows = [r for r in reader if r]
    i_lat, i_lon = header.index('Lat'), header.index('Lon')
    seen, kept = set(), []
    for r in rows:
        pair = (_csv_float(r, i_lat), _csv_float(r, i_lon))
        key = tuple('nan' if math.isnan(v) else v for v in pair)
        if key not in seen:
            seen.add(key)
            kept.append(r)
    lat = np.array([_csv_float(r, i_lat) for r in kept], dtype=np.float64)
    lon = np.array([_csv_float(r, i_lon) for r in kept], dtype=np.float64)
    return header, kept, lat, lon


def _csv_float(row: list, i: int) -> float:
    """Field ``i`` of a CSV row as a float: NaN when empty or missing."""
    field = row[i].strip() if i < len(row) else ''
    return float(field) if field else float('nan')


class StationFile(AOI):
    """CSV of stations with Lat, Lon, and optionally Hgt_m columns."""

    def __init__(self, station_file, demFile=None,
                 cube_spacing_in_m: Optional[float] = None) -> None:
        super().__init__(cube_spacing_in_m)
        self._filename = station_file
        self._demfile = demFile
        self._bounding_box = bounds_from_csv(station_file)
        self._type = 'station_file'

    def readLL(self):
        _, _, lat, lon = read_station_csv(self._filename)
        return lat, lon

    def readZ(self):
        header, rows, lat, lon = read_station_csv(self._filename)
        if 'Hgt_m' in header:
            i_hgt = header.index('Hgt_m')
            return np.array([_csv_float(r, i_hgt) for r in rows], dtype=np.float64)
        from raider_tpu_torch.workflows.dem import download_dem, interpolate_dem

        dem_file = self._demfile or os.path.join(self._output_directory, 'GLO30_fullres_dem.tif')
        download_dem(self._bounding_box, writeDEM=True, dem_path=Path(dem_file))
        # interpolate_dem samples (lat, lon) pairs and returns (n,)
        z_out = np.asarray(interpolate_dem(dem_file, (lat, lon)))
        # write the heights back as a new column, one row per station
        with open(self._filename, 'w', newline='') as f:
            writer = csv.writer(f)
            writer.writerow(header + ['Hgt_m'])
            for r, z in zip(rows, z_out):
                writer.writerow(r + ['' if np.isnan(z) else repr(float(z))])
        self._bounding_box = bounds_from_csv(self._filename)
        return z_out


class RasterRDR(AOI):
    """Radar-coordinate lat/lon(/height) rasters."""

    def __init__(self, lat_file, lon_file=None, hgt_file=None, dem_file=None,
                 convention: str = 'isce', cube_spacing_in_m: Optional[float] = None) -> None:
        super().__init__(cube_spacing_in_m)
        self._type = 'radar_rasters'
        self._latfile = lat_file
        self._lonfile = lon_file
        if self._latfile is None and self._lonfile is None:
            raise ValueError('You need to specify a 2-band file or two single-band files')
        if not os.path.exists(self._latfile):
            raise ValueError(f'{self._latfile} cannot be found!')
        if self._lonfile is not None and not os.path.exists(self._lonfile):
            raise ValueError(f'{self._lonfile} cannot be found!')
        from raider_tpu_torch.io.rasters import bounds_from_latlon_rasters

        try:
            self._bounding_box, self._proj, self._geotransform = \
                bounds_from_latlon_rasters(lat_file, lon_file)
        except ValueError:
            raise
        except Exception as e:
            raise ValueError(f'Could not read lat/lon rasters: {e}')
        self._hgtfile = hgt_file
        self._demfile = dem_file
        self._convention = convention

    def readLL(self):
        from raider_tpu_torch.io.rasters import rio_open

        lats, _ = rio_open(self._latfile)
        if self._lonfile is None:
            return lats, None
        lons, _ = rio_open(self._lonfile)
        return lats, lons

    def readZ(self):
        from raider_tpu_torch.io.rasters import rio_open

        if self._hgtfile is not None and os.path.exists(self._hgtfile):
            logger.info('Using existing heights at: %s', self._hgtfile)
            hgts, _ = rio_open(self._hgtfile)
            return hgts
        from raider_tpu_torch.workflows.dem import download_dem, interpolate_dem

        dem_file = self._demfile or os.path.join(self._output_directory, 'GLO30_fullres_dem.tif')
        download_dem(self._bounding_box, writeDEM=True, dem_path=Path(dem_file))
        return interpolate_dem(dem_file, self.readLL())


class GeocodedFile(AOI):
    """Geocoded raster file providing the query grid."""

    def __init__(self, path, is_dem: bool = False,
                 cube_spacing_in_m: Optional[float] = None) -> None:
        super().__init__(cube_spacing_in_m)
        from raider_tpu_torch.io.rasters import rio_extents, rio_profile, rio_stats

        self._filename = path
        self.p = rio_profile(path)
        self._bounding_box = rio_extents(self.p)
        self._is_dem = is_dem
        _, self._proj, self._geotransform = rio_stats(path)
        self._type = 'geocoded_file'

    def readLL(self):
        # the pixel size is (E - W) / w over rio_extents' bounds, which span
        # (w - 1) pixels: the JAX package's grid, kept as it is
        S, N, W, E = self._bounding_box
        w, h = self.p['width'], self.p['height']
        px = (E - W) / w
        py = (N - S) / h
        x = W + np.arange(w) * px
        y = S + np.arange(h) * py
        X, Y = np.meshgrid(x, y)
        return Y, X

    def readZ(self):
        from raider_tpu_torch.workflows.dem import download_dem, interpolate_dem

        dem_file = self._filename if self._is_dem else 'GLO30_fullres_dem.tif'
        download_dem(self._bounding_box, writeDEM=True, dem_path=Path(dem_file))
        return interpolate_dem(dem_file, self.readLL())


class Geocube(AOI):
    """Georeferenced cube file supplying lat/lon/height grids."""

    def __init__(self, path_cube, cube_spacing_in_m: Optional[float] = None) -> None:
        super().__init__(cube_spacing_in_m)
        self.path = path_cube
        self._type = 'Geocube'
        self._bounding_box = self.get_extent()

    @staticmethod
    def _latlon(ds):
        """Coordinate arrays under either naming convention: GUNW-style
        'latitude'/'longitude', or the delay cube's 'y'/'x' (EPSG:4326
        cubes written by tropo_delay)."""
        for la, lo in (('latitude', 'longitude'), ('y', 'x')):
            if la in ds and lo in ds:
                return np.asarray(ds[la].data), np.asarray(ds[lo].data)
        raise KeyError('No latitude/longitude or y/x coordinates in geocube')

    def get_extent(self):
        from raider_tpu_torch.io import read_nc

        ds = read_nc(self.path)
        lats, lons = self._latlon(ds)
        return [lats.min(), lats.max(), lons.min(), lons.max()]

    def readLL(self):
        from raider_tpu_torch.io import read_nc

        ds = read_nc(self.path)
        lats, lons = self._latlon(ds)
        # (ny, nx) grids with latitude varying along rows, as every other AOI
        lon_grid, lat_grid = np.meshgrid(lons, lats)
        return lat_grid, lon_grid

    def readZ(self):
        from raider_tpu_torch.io import read_nc

        ds = read_nc(self.path)
        for name in ('heights', 'z'):
            if name in ds:
                return np.asarray(ds[name].data)
        raise KeyError('No heights/z coordinate in geocube')


def bounds_from_csv(station_file) -> list:
    """SNWE bounds of a station CSV (NaN skipped, as pandas' min and max do)."""
    _, _, lat, lon = read_station_csv(station_file)
    return [np.nanmin(lat), np.nanmax(lat), np.nanmin(lon), np.nanmax(lon)]
