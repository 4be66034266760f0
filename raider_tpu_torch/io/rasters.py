"""Minimal raster IO without rasterio/GDAL.

Supports the formats the framework actually needs:
  * ENVI flat-binary rasters with .hdr sidecars (ISCE lat/lon/los .rdr files,
    and the reference's default delay raster output format,
    reference: tools/RAiDER/utilFcns.py:257-304)
  * GeoTIFF via a pure-python reader/writer (io/geotiff.py): striped/tiled,
    none/deflate/packbits compression, EPSG GeoKeys, GDAL_NODATA.

The profile dict mimics the rasterio profile keys used by the reference
(width, height, count, dtype, transform, crs, nodata).

Counterpart of ``raider_tpu/io/rasters.py``, copied as it is: both packages
write the same bytes. Reading an S1-GUNW profile goes through ``read_nc`` on
a netCDF4 group, so h5py is imported there only.
"""

import os
import re
from pathlib import Path
from typing import Optional, Tuple

import numpy as np

from raider_tpu_torch.geodesy import CRS, Geographic
from raider_tpu_torch.logger import logger

_ENVI_DTYPES = {
    '1': np.uint8, '2': np.int16, '3': np.int32, '4': np.float32,
    '5': np.float64, '6': np.complex64, '9': np.complex128,
    '12': np.uint16, '13': np.uint32, '14': np.int64, '15': np.uint64,
}
_ENVI_CODES = {np.dtype(v).name: k for k, v in _ENVI_DTYPES.items()}


class GDALAffine(tuple):
    """GDAL-style geotransform (x0, dx, rx, y0, ry, dy) with to_gdal()."""

    def to_gdal(self):
        return tuple(self)


def _parse_envi_header(hdr_path: str) -> dict:
    text = Path(hdr_path).read_text()
    # collapse { ... } blocks
    text = re.sub(r'\{([^}]*)\}', lambda m: m.group(1).replace('\n', ' '), text)
    fields = {}
    for line in text.splitlines():
        if '=' in line:
            k, v = line.split('=', 1)
            fields[k.strip().lower()] = v.strip()
    return fields


def _find_envi_header(path: str) -> Optional[str]:
    p = Path(path)
    for cand in (p.with_suffix(p.suffix + '.hdr'), p.with_suffix('.hdr'),
                 Path(str(p) + '.hdr')):
        if cand.exists():
            return str(cand)
    return None


def read_envi(path: str) -> Tuple[np.ndarray, dict]:
    hdr = _find_envi_header(path)
    if hdr is None:
        raise OSError(f'No ENVI header found for {path}')
    fields = _parse_envi_header(hdr)
    samples = int(fields['samples'])
    lines = int(fields['lines'])
    bands = int(fields.get('bands', 1))
    dtype = _ENVI_DTYPES[fields.get('data type', '4')]
    interleave = fields.get('interleave', 'bsq').lower()
    byte_order = int(fields.get('byte order', 0))

    data = np.fromfile(path, dtype=dtype)
    if byte_order == 1:
        data = data.byteswap()
    need = samples * lines * bands
    data = data[:need]
    if interleave == 'bil':
        data = data.reshape(lines, bands, samples).transpose(1, 0, 2)
    elif interleave == 'bip':
        data = data.reshape(lines, samples, bands).transpose(2, 0, 1)
    else:  # bsq
        data = data.reshape(bands, lines, samples)

    transform = None
    if 'map info' in fields:
        parts = [p.strip() for p in fields['map info'].split(',')]
        # ENVI map info: proj, ref x pix, ref y pix, x0, y0, dx, dy, ...
        try:
            x0, y0 = float(parts[3]), float(parts[4])
            dx, dy = float(parts[5]), float(parts[6])
            transform = GDALAffine((x0, dx, 0.0, y0, 0.0, -dy))
        except (IndexError, ValueError):
            pass

    profile = {
        'width': samples,
        'height': lines,
        'count': bands,
        'dtype': np.dtype(dtype).name,
        'transform': transform,
        'crs': None,
        'nodata': float(fields['data ignore value']) if 'data ignore value' in fields else None,
        'driver': 'ENVI',
    }
    return data, profile


def write_envi(array: np.ndarray, path: str, transform=None, nodata: float = 0.0) -> None:
    array = np.atleast_3d(array.T).T if array.ndim == 2 else array
    bands, lines, samples = (1,) + array.shape if array.ndim == 2 else array.shape
    arr = array.reshape(bands, lines, samples)
    arr.astype(arr.dtype).tofile(path)
    hdr_lines = [
        'ENVI',
        f'samples = {samples}',
        f'lines = {lines}',
        f'bands = {bands}',
        'header offset = 0',
        'file type = ENVI Standard',
        f'data type = {_ENVI_CODES[np.dtype(arr.dtype).name]}',
        'interleave = bsq',
        'byte order = 0',
        f'data ignore value = {nodata}',
    ]
    if transform is not None:
        gt = transform.to_gdal() if hasattr(transform, 'to_gdal') else tuple(transform)
        hdr_lines.append(
            'map info = {Geographic Lat/Lon, 1, 1, %s, %s, %s, %s, WGS-84}'
            % (gt[0], gt[3], gt[1], -gt[5])
        )
    Path(str(path) + '.hdr').write_text('\n'.join(hdr_lines) + '\n')


_VRT_DTYPES = {
    'Byte': np.uint8, 'Int16': np.int16, 'UInt16': np.uint16,
    'Int32': np.int32, 'UInt32': np.uint32, 'Float32': np.float32,
    'Float64': np.float64, 'CFloat32': np.complex64, 'CFloat64': np.complex128,
}


def read_vrt(path: str) -> Tuple[np.ndarray, dict]:
    """Read a GDAL VRT referencing flat-binary sources.

    Supports the two VRT flavors this pipeline encounters: raw-binary bands
    (``VRTRawRasterBand`` with Image/Pixel/LineOffset — the GACOS products
    written by workflows.gacos.makeVRT, reference generateGACOSVRT.py:6-42)
    and ``SimpleSource`` bands referencing ISCE rasters (lat/lon/los .rdr
    files with ENVI .hdr sidecars).
    """
    import xml.etree.ElementTree as ET

    root = ET.parse(str(path)).getroot()
    width = int(root.get('rasterXSize'))
    height = int(root.get('rasterYSize'))
    vrt_dir = os.path.dirname(os.path.abspath(str(path)))

    transform = None
    gt_el = root.find('GeoTransform')
    if gt_el is not None and gt_el.text:
        transform = GDALAffine(tuple(float(v) for v in gt_el.text.split(',')))
    crs = None
    srs_el = root.find('SRS')
    if srs_el is not None and srs_el.text:
        from raider_tpu_torch.geodesy.crs import crs_from_user

        try:
            crs = crs_from_user(srs_el.text.strip())
        except (ValueError, NotImplementedError):
            crs = None

    bands, nodata = [], None
    for band_el in root.findall('VRTRasterBand'):
        dtype = _VRT_DTYPES[band_el.get('dataType', 'Float32')]
        nd_el = band_el.find('NoDataValue')
        if nd_el is not None and nd_el.text:
            nodata = float(nd_el.text)
        if band_el.get('subClass') == 'VRTRawRasterBand':
            src = band_el.find('SourceFilename')
            fname = src.text
            if src.get('relativeToVRT') == '1':
                fname = os.path.join(vrt_dir, fname)
            image_off = int(band_el.findtext('ImageOffset', '0'))
            pixel_off = int(band_el.findtext('PixelOffset', str(np.dtype(dtype).itemsize)))
            line_off = int(band_el.findtext('LineOffset', str(np.dtype(dtype).itemsize * width)))
            byte_order = band_el.findtext('ByteOrder', 'LSB')
            raw = np.memmap(fname, dtype=np.uint8, mode='r')
            arr = np.lib.stride_tricks.as_strided(
                raw[image_off:].view(np.uint8), shape=(height, width, np.dtype(dtype).itemsize),
                strides=(line_off, pixel_off, 1),
            ).copy().view(dtype)[..., 0]
            if byte_order == 'MSB':
                arr = arr.byteswap()
            bands.append(np.asarray(arr))
        else:  # SimpleSource / ComplexSource
            src_el = band_el.find('.//SourceFilename')
            fname = src_el.text
            if src_el.get('relativeToVRT') == '1':
                fname = os.path.join(vrt_dir, fname)
            src_band = int(band_el.findtext('.//SourceBand', '1'))
            if _find_envi_header(fname) is not None:
                data, _ = read_envi(fname)
                bands.append(data[src_band - 1])
            else:
                flat = np.fromfile(fname, dtype=dtype)
                n_src_bands = max(1, flat.size // (height * width))
                bands.append(flat[:n_src_bands * height * width]
                             .reshape(n_src_bands, height, width)[src_band - 1])

    data = np.stack(bands)
    profile = {
        'width': width, 'height': height, 'count': len(bands),
        'dtype': data.dtype.name, 'transform': transform, 'crs': crs,
        'nodata': nodata, 'driver': 'VRT',
    }
    return data, profile


def _gunw_profile(path: str) -> dict:
    """Profile of an S1-GUNW netCDF's unwrappedPhase grid
    (reference: utilFcns.py:144-146 opens the NETCDF: subdataset)."""
    from raider_tpu_torch.geodesy import Geographic
    from raider_tpu_torch.io import read_nc

    ds = read_nc(str(path), group='science/grids/data')
    lats = np.asarray(ds['latitude'].data)
    lons = np.asarray(ds['longitude'].data)
    dy = float(lats[1] - lats[0])
    dx = float(lons[1] - lons[0])
    var = ds['unwrappedPhase'] if 'unwrappedPhase' in ds else None
    return {
        'width': lons.size, 'height': lats.size, 'count': 1,
        'dtype': np.asarray(var.data).dtype.name if var is not None else 'float32',
        'transform': GDALAffine((float(lons[0]) - dx / 2, dx, 0.0,
                                 float(lats[0]) - dy / 2, 0.0, dy)),
        'crs': Geographic(), 'nodata': 0.0, 'driver': 'netCDF',
    }


def _pam_nodata(path: str, band: int = 1) -> Optional[float]:
    """NoDataValue from a GDAL PAM ``.aux.xml`` sidecar, if present."""
    aux = str(path) + '.aux.xml'
    if not os.path.exists(aux):
        return None
    try:
        import xml.etree.ElementTree as ET

        root = ET.parse(aux).getroot()
        for rb in root.iter('PAMRasterBand'):
            if int(rb.get('band', '1')) == band:
                nd = rb.find('NoDataValue')
                if nd is not None and nd.text:
                    return float(nd.text)
    except Exception:
        return None
    return None


def _read_any(path: str) -> Tuple[np.ndarray, dict]:
    """Dispatch on format: VRT/GeoTIFF by extension or magic, else ENVI."""
    p = str(path)
    if p.endswith('.vrt'):
        data, profile = read_vrt(p)
    elif p.endswith(('.tif', '.tiff')):
        from raider_tpu_torch.io.geotiff import read_gtiff

        data, profile = read_gtiff(p)
    else:
        with open(p, 'rb') as f:
            magic = f.read(4)
        if magic[:2] in (b'II', b'MM') and _find_envi_header(p) is None:
            from raider_tpu_torch.io.geotiff import read_gtiff

            data, profile = read_gtiff(p)
        else:
            data, profile = read_envi(p)
    if profile.get('nodata') is None:
        # GDAL stores nodata for bare ENVI/ISCE rasters in PAM sidecars
        profile['nodata'] = _pam_nodata(p)
    return data, profile


def rio_open(path, userNDV: Optional[float] = None, band: Optional[int] = None):
    """Read a raster (ENVI binary + .hdr) -> (data, profile)
    (capability parity: reference utilFcns.py:164-202)."""
    path = str(path)
    if not os.path.exists(path):
        raise OSError(f'{path} not found')
    data, profile = _read_any(path)

    ndvs = [userNDV, profile.get('nodata')]
    if band is not None:
        out = data[band - 1].astype(np.float64)
    else:
        out = data.squeeze().astype(np.float64)
    for v in ndvs:
        if v is not None:
            out[out == v] = np.nan
    return out, profile


def rio_profile(path) -> dict:
    """Raster profile with the reference's path rewrites: S1-GUNW netCDFs
    resolve to their unwrappedPhase grid, and a ``.vrt`` sidecar is preferred
    when present (reference: utilFcns.py:140-151)."""
    p = str(path)
    if os.path.basename(p).startswith('S1-GUNW') and p.endswith('.nc'):
        return _gunw_profile(p)
    if not p.endswith('.vrt') and os.path.exists(p + '.vrt'):
        p = p + '.vrt'
    _, profile = _read_any(p)
    return profile


def rio_stats(path, band: int = 1):
    p = str(path)
    # prefer a .vrt sidecar, like the reference (utilFcns.py:230-232)
    if not p.endswith('.vrt') and os.path.exists(p + '.vrt'):
        p = p + '.vrt'
    data, profile = _read_any(p)
    b = data[band - 1].astype(np.float64)
    nodata = profile.get('nodata')
    if nodata is not None:
        b = np.where(b == nodata, np.nan, b)

    class _Stats:
        min = float(np.nanmin(b))
        max = float(np.nanmax(b))
        mean = float(np.nanmean(b))
        std = float(np.nanstd(b))

    gt = profile['transform'].to_gdal() if profile['transform'] is not None else None
    return _Stats(), profile.get('crs'), gt


def rio_extents(profile: dict):
    """SNWE bounds from a profile (reference: utilFcns.py:154-161)."""
    gt = profile['transform'].to_gdal()
    x_size = profile['width']
    y_size = profile['height']
    w = gt[0]
    e = gt[0] + (x_size - 1) * gt[1] + (y_size - 1) * gt[2]
    n = gt[3]
    s = gt[3] + (x_size - 1) * gt[4] + (y_size - 1) * gt[5]
    return min(s, n), max(s, n), min(w, e), max(w, e)


def bounds_from_latlon_rasters(lat_filestr: str, lon_filestr: str):
    """SNWE + CRS + geotransform from lat/lon rasters
    (reference: llreader.py:397-420)."""
    lat_file, lat_band = get_file_and_band(lat_filestr)
    lon_file, lon_band = get_file_and_band(lon_filestr)
    lat_stats, lat_proj, lat_gt = rio_stats(lat_file, band=lat_band)
    lon_stats, lon_proj, lon_gt = rio_stats(lon_file, band=lon_band)
    if lat_proj != lon_proj:
        raise ValueError('Projection information for Latitude and Longitude files does not match')
    if lat_gt != lon_gt:
        raise ValueError('Affine transform for Latitude and Longitude files does not match')
    snwe = (lat_stats.min, lat_stats.max, lon_stats.min, lon_stats.max)
    if lat_proj is None:
        logger.debug('Assuming lat/lon files are in EPSG:4326')
        lat_proj = Geographic()
    return snwe, lat_proj, lat_gt


def get_file_and_band(filestr: str):
    """Parse 'file;band' strings (reference: utilFcns.py:244-254)."""
    parts = str(filestr).split(';')
    if len(parts) == 1:
        return parts[0].strip(), 1
    if len(parts) == 2:
        return parts[0].strip(), int(parts[1].strip())
    raise ValueError(f'Cannot interpret {filestr} as valid filename')


def writeArrayToRaster(array, path, noDataValue: float = 0.0, fmt: str = 'ENVI',
                       proj: Optional[CRS] = None, gt=None) -> None:
    """Write a 2-D array to a raster (reference: utilFcns.py:257-304)."""
    if np.ndim(array) != 2:
        raise RuntimeError(f'writeArrayToRaster: cannot write shape {np.shape(array)}')
    if 'complex' in str(array.dtype):
        array = array.astype(np.complex64)
    elif 'float' in str(array.dtype):
        array = array.astype(np.float32)
    else:
        array = array.astype(np.uint8)
    if fmt.lower() not in ('envi', 'nc', 'gtiff'):
        raise ValueError(f'Unsupported raster format {fmt}')
    if fmt.lower() == 'gtiff' or str(path).endswith(('.tif', '.tiff')):
        from raider_tpu_torch.io.geotiff import write_gtiff

        write_gtiff(array, str(path), transform=gt, crs=proj, nodata=noDataValue)
    else:
        write_envi(array, str(path), transform=gt, nodata=noDataValue)
    logger.info('Wrote: %s', path)
