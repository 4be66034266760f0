"""Pure-python GeoTIFF reader/writer (no GDAL/rasterio dependency).

Capability parity: the reference reads and writes rasters through rasterio
(tools/RAiDER/utilFcns.py:140-305, fmt='GTiff' branch utilFcns.py:276-293).
This module implements the subset of the TIFF 6.0 + GeoTIFF 1.1 specs that
scientific rasters actually use:

read:  classic TIFF, either endianness, striped or tiled layout,
       chunky (PlanarConfig=1) or planar (=2) interleave,
       compression none / deflate (8, 32946) / LZW (5) / packbits (32773),
       horizontal-differencing predictor (2),
       uint8/16/32, int16/32, float32/64 samples,
       geo-referencing from ModelPixelScale+ModelTiepoint or
       ModelTransformation, CRS from the EPSG GeoKeys,
       nodata from GDAL_NODATA (tag 42113)
write: little-endian classic TIFF, striped, chunky interleave,
       optional deflate, ModelPixelScale+ModelTiepoint, EPSG GeoKeys
       (geographic or projected), GDAL_NODATA

Arrays are (bands, rows, cols) to match io.rasters conventions.

Counterpart of ``raider_tpu/io/geotiff.py``, copied as it is (struct, zlib,
numpy and the port's CRS classes): both packages write the same bytes.
"""

import struct
import zlib
from pathlib import Path
from typing import Optional, Tuple

import numpy as np

from raider_tpu_torch.geodesy import CRS, Geographic
from raider_tpu_torch.geodesy.crs import (
    Ellipsoid,
    LambertConformalConic,
    PolarStereographic,
    TransverseMercator,
    crs_from_epsg,
)

# TIFF tag ids
_T_WIDTH, _T_LENGTH = 256, 257
_T_BITS, _T_COMPRESSION, _T_PHOTOMETRIC = 258, 259, 262
_T_STRIP_OFFSETS, _T_SAMPLES_PER_PIXEL, _T_ROWS_PER_STRIP = 273, 277, 278
_T_STRIP_COUNTS, _T_PLANAR, _T_PREDICTOR = 279, 284, 317
_T_TILE_WIDTH, _T_TILE_LENGTH, _T_TILE_OFFSETS, _T_TILE_COUNTS = 322, 323, 324, 325
_T_SAMPLE_FORMAT = 339
_T_PIXEL_SCALE, _T_TIEPOINT, _T_TRANSFORM = 33550, 33922, 34264
_T_GEO_KEYS, _T_GEO_DOUBLES, _T_GEO_ASCII = 34735, 34736, 34737
_T_GDAL_METADATA = 42112
_T_GDAL_NODATA = 42113

# TIFF field types: (struct char, byte size)
_FIELD = {1: ('B', 1), 2: ('c', 1), 3: ('H', 2), 4: ('I', 4), 5: ('II', 8),
          6: ('b', 1), 7: ('B', 1), 8: ('h', 2), 9: ('i', 4), 10: ('ii', 8),
          11: ('f', 4), 12: ('d', 8)}

# GeoKey ids
_GK_MODEL_TYPE, _GK_RASTER_TYPE = 1024, 1025
_GK_GEOGRAPHIC_TYPE, _GK_PROJECTED_TYPE = 2048, 3072
_GK_SEMI_MAJOR, _GK_INV_FLATTENING = 2057, 2059
_GK_PROJECTION, _GK_PROJ_COORD_TRANS = 3074, 3075
_GK_STD_PARALLEL1, _GK_STD_PARALLEL2 = 3078, 3079
_GK_NAT_ORIGIN_LONG, _GK_NAT_ORIGIN_LAT = 3080, 3081
_GK_FALSE_EASTING, _GK_FALSE_NORTHING = 3082, 3083
_GK_FALSE_ORIGIN_LONG, _GK_FALSE_ORIGIN_LAT = 3084, 3085
_GK_FALSE_ORIGIN_EASTING, _GK_FALSE_ORIGIN_NORTHING = 3086, 3087
_GK_SCALE_AT_NAT_ORIGIN, _GK_VERT_POLE_LONG = 3092, 3095


def _sample_dtype(bits: int, fmt: int, bo: str) -> np.dtype:
    kind = {1: 'u', 2: 'i', 3: 'f'}.get(fmt, 'u')
    return np.dtype(f'{bo}{kind}{bits // 8}')


def _read_ifd(buf: bytes, off: int, bo: str) -> Tuple[dict, int]:
    (n,) = struct.unpack_from(bo + 'H', buf, off)
    entries = {}
    for i in range(n):
        eoff = off + 2 + 12 * i
        tag, ftype, count = struct.unpack_from(bo + 'HHI', buf, eoff)
        if ftype not in _FIELD:
            continue
        ch, sz = _FIELD[ftype]
        nbytes = sz * count
        if nbytes <= 4:
            voff = eoff + 8
        else:
            (voff,) = struct.unpack_from(bo + 'I', buf, eoff + 8)
        if ftype == 2:  # ascii
            entries[tag] = buf[voff:voff + count].split(b'\x00')[0].decode('latin-1')
        elif ftype in (5, 10):  # rational
            vals = struct.unpack_from(bo + ch * count, buf, voff)
            entries[tag] = tuple(vals[2 * k] / vals[2 * k + 1] for k in range(count))
        else:
            vals = struct.unpack_from(bo + ch * count, buf, voff)
            entries[tag] = vals if count > 1 else vals[0]
    (next_off,) = struct.unpack_from(bo + 'I', buf, off + 2 + 12 * n)
    return entries, next_off


def _lzw_decode(chunk: bytes) -> bytes:
    """TIFF-variant LZW (MSB-first bit order, early code-width change)."""
    CLEAR, EOI = 256, 257
    out = bytearray()
    table = []
    code_width = 9
    prev = None
    bitbuf = bitcnt = 0
    pos = 0
    n = len(chunk)
    while True:
        while bitcnt < code_width and pos < n:
            bitbuf = (bitbuf << 8) | chunk[pos]
            pos += 1
            bitcnt += 8
        if bitcnt < code_width:
            break
        code = (bitbuf >> (bitcnt - code_width)) & ((1 << code_width) - 1)
        bitcnt -= code_width
        if code == CLEAR:
            table = [bytes([i]) for i in range(256)] + [b'', b'']
            code_width = 9
            prev = None
            continue
        if code == EOI:
            break
        if prev is None:
            entry = table[code]
        elif code < len(table):
            entry = table[code]
            table.append(prev + entry[:1])
        else:
            entry = prev + prev[:1]
            table.append(entry)
        out += entry
        prev = entry
        # TIFF uses "early change": widen one code before the table fills
        if len(table) >= (1 << code_width) - 1 and code_width < 12:
            code_width += 1
    return bytes(out)


def _decompress(chunk: bytes, compression: int) -> bytes:
    if compression == 1:
        return chunk
    if compression in (8, 32946):
        return zlib.decompress(chunk)
    if compression == 5:
        return _lzw_decode(chunk)
    if compression == 32773:  # PackBits
        out = bytearray()
        i = 0
        while i < len(chunk):
            n = chunk[i]
            i += 1
            if n < 128:
                out += chunk[i:i + n + 1]
                i += n + 1
            elif n > 128:
                out += chunk[i:i + 1] * (257 - n)
                i += 1
        return bytes(out)
    raise OSError(
        f'GeoTIFF compression {compression} (e.g. JPEG=7) is not supported '
        'by the pure-python reader; re-save with LZW, DEFLATE, or none.'
    )


def _crs_from_geokeys(keys, doubles, ascii_s) -> Optional[CRS]:
    if not keys:
        return None
    # key directory: header (4 shorts) then (id, location, count, value) quads
    kv = {}
    for i in range(4, len(keys) - 3, 4):
        kid, loc, count, value = keys[i:i + 4]
        if loc == 0:
            kv[kid] = value
        elif loc == _T_GEO_DOUBLES and doubles is not None and value < len(doubles):
            kv[kid] = float(doubles[value])
    model = kv.get(_GK_MODEL_TYPE)
    try:
        if model == 2 or (model is None and _GK_GEOGRAPHIC_TYPE in kv):
            code = kv.get(_GK_GEOGRAPHIC_TYPE, 4326)
            return Geographic() if code in (4326, 4269, 4267, 0, 32767) else crs_from_epsg(code)
        if model == 1 and kv.get(_GK_PROJECTED_TYPE, 32767) != 32767:
            return crs_from_epsg(kv[_GK_PROJECTED_TYPE])
        if model == 1 and _GK_PROJ_COORD_TRANS in kv:
            return _crs_from_user_keys(kv)
    except (ValueError, NotImplementedError):
        return None
    return None


def _crs_from_user_keys(kv: dict) -> Optional[CRS]:
    """User-defined (EPSG-less) projections written by write_gtiff:
    LCC 2SP (CT 8/9), polar stereographic (CT 15), transverse Mercator
    (CT 1) with the ellipsoid from semi-major + inverse flattening
    (0 = sphere)."""
    if _GK_SEMI_MAJOR in kv:
        invf = kv.get(_GK_INV_FLATTENING, 0.0)
        ell = Ellipsoid(a=float(kv[_GK_SEMI_MAJOR]),
                        f=(1.0 / invf) if invf else 0.0)
    else:
        ell = Ellipsoid()
    ct = kv[_GK_PROJ_COORD_TRANS]
    if ct in (8, 9):
        lat_1 = kv.get(_GK_STD_PARALLEL1, kv.get(_GK_NAT_ORIGIN_LAT, 0.0))
        return LambertConformalConic(
            lat_0=kv.get(_GK_FALSE_ORIGIN_LAT, kv.get(_GK_NAT_ORIGIN_LAT, lat_1)),
            lon_0=kv.get(_GK_FALSE_ORIGIN_LONG, kv.get(_GK_NAT_ORIGIN_LONG, 0.0)),
            lat_1=lat_1, lat_2=kv.get(_GK_STD_PARALLEL2, lat_1),
            x_0=kv.get(_GK_FALSE_ORIGIN_EASTING, kv.get(_GK_FALSE_EASTING, 0.0)),
            y_0=kv.get(_GK_FALSE_ORIGIN_NORTHING, kv.get(_GK_FALSE_NORTHING, 0.0)),
            ellipsoid=ell)
    if ct == 15:
        lat = kv.get(_GK_NAT_ORIGIN_LAT, 90.0)
        variant_a = abs(lat) == 90.0
        return PolarStereographic(
            lat_0=lat if variant_a else (90.0 if lat > 0 else -90.0),
            lon_0=kv.get(_GK_VERT_POLE_LONG, kv.get(_GK_NAT_ORIGIN_LONG, 0.0)),
            lat_ts=None if variant_a else lat,
            k0=kv.get(_GK_SCALE_AT_NAT_ORIGIN, 1.0),
            x_0=kv.get(_GK_FALSE_EASTING, 0.0),
            y_0=kv.get(_GK_FALSE_NORTHING, 0.0), ellipsoid=ell)
    if ct == 1:
        return TransverseMercator(
            lat_0=kv.get(_GK_NAT_ORIGIN_LAT, 0.0),
            lon_0=kv.get(_GK_NAT_ORIGIN_LONG, 0.0),
            k0=kv.get(_GK_SCALE_AT_NAT_ORIGIN, 0.9996),
            x_0=kv.get(_GK_FALSE_EASTING, 0.0),
            y_0=kv.get(_GK_FALSE_NORTHING, 0.0), ellipsoid=ell)
    return None


def read_gtiff(path: str) -> Tuple[np.ndarray, dict]:
    """Read a GeoTIFF -> ((bands, rows, cols) array, rasterio-like profile)."""
    buf = Path(path).read_bytes()
    if buf[:2] == b'II':
        bo = '<'
    elif buf[:2] == b'MM':
        bo = '>'
    else:
        raise OSError(f'{path} is not a TIFF file')
    (magic,) = struct.unpack_from(bo + 'H', buf, 2)
    if magic == 43:
        raise OSError(f'{path} is a BigTIFF; only classic TIFF is supported')
    if magic != 42:
        raise OSError(f'{path} has bad TIFF magic {magic}')
    (ifd_off,) = struct.unpack_from(bo + 'I', buf, 4)
    tags, _ = _read_ifd(buf, ifd_off, bo)

    width, height = int(tags[_T_WIDTH]), int(tags[_T_LENGTH])
    spp = int(tags.get(_T_SAMPLES_PER_PIXEL, 1))
    bits = tags.get(_T_BITS, 8)
    bits = int(bits[0] if isinstance(bits, tuple) else bits)
    fmt = tags.get(_T_SAMPLE_FORMAT, 1)
    fmt = int(fmt[0] if isinstance(fmt, tuple) else fmt)
    compression = int(tags.get(_T_COMPRESSION, 1))
    planar = int(tags.get(_T_PLANAR, 1))
    predictor = int(tags.get(_T_PREDICTOR, 1))
    dtype = _sample_dtype(bits, fmt, bo)

    def _as_tuple(v):
        return v if isinstance(v, tuple) else (v,)

    out = np.zeros((spp, height, width), dtype=dtype.newbyteorder('='))

    def _place(block, row0, col0, rows, cols, plane):
        """block: raw bytes for a (rows, cols[, spp_chunk]) region."""
        chunk_spp = 1 if planar == 2 else spp
        arr = np.frombuffer(block, dtype=dtype)
        need = rows * cols * chunk_spp
        arr = arr[:need].reshape(rows, cols, chunk_spp)
        if predictor == 2:
            arr = np.cumsum(arr, axis=1, dtype=dtype)
        r1 = min(row0 + rows, height)
        c1 = min(col0 + cols, width)
        sub = arr[: r1 - row0, : c1 - col0]
        if planar == 2:
            out[plane, row0:r1, col0:c1] = sub[..., 0]
        else:
            out[:, row0:r1, col0:c1] = np.moveaxis(sub, -1, 0)

    if _T_TILE_OFFSETS in tags:
        tw, tl = int(tags[_T_TILE_WIDTH]), int(tags[_T_TILE_LENGTH])
        offsets = _as_tuple(tags[_T_TILE_OFFSETS])
        counts = _as_tuple(tags[_T_TILE_COUNTS])
        tiles_across = (width + tw - 1) // tw
        tiles_down = (height + tl - 1) // tl
        per_plane = tiles_across * tiles_down
        for idx, (o, c) in enumerate(zip(offsets, counts)):
            plane, t = divmod(idx, per_plane) if planar == 2 else (0, idx)
            ty, tx = divmod(t, tiles_across)
            _place(_decompress(buf[o:o + c], compression),
                   ty * tl, tx * tw, tl, tw, plane)
    else:
        rps = int(tags.get(_T_ROWS_PER_STRIP, height))
        offsets = _as_tuple(tags[_T_STRIP_OFFSETS])
        counts = _as_tuple(tags[_T_STRIP_COUNTS])
        strips_per_plane = (height + rps - 1) // rps
        for idx, (o, c) in enumerate(zip(offsets, counts)):
            plane, s = divmod(idx, strips_per_plane) if planar == 2 else (0, idx)
            row0 = s * rps
            rows = min(rps, height - row0)
            _place(_decompress(buf[o:o + c], compression),
                   row0, 0, rows, width, plane)

    # geo-referencing -> GDAL geotransform (x0, dx, rx, y0, ry, dy)
    transform = None
    if _T_TRANSFORM in tags:
        m = tags[_T_TRANSFORM]
        transform = (m[3], m[0], m[1], m[7], m[4], m[5])
    elif _T_PIXEL_SCALE in tags and _T_TIEPOINT in tags:
        sx, sy = tags[_T_PIXEL_SCALE][0], tags[_T_PIXEL_SCALE][1]
        tp = tags[_T_TIEPOINT]
        i, j, x, y = tp[0], tp[1], tp[3], tp[4]
        transform = (x - i * sx, sx, 0.0, y + j * sy, 0.0, -sy)

    meta_tags = {}
    if _T_GDAL_METADATA in tags:
        # GDAL metadata XML: <GDALMetadata><Item name="KEY">value</Item>...
        try:
            import xml.etree.ElementTree as _ET

            root = _ET.fromstring(str(tags[_T_GDAL_METADATA]).strip().rstrip('\x00'))
            for item in root.iter('Item'):
                meta_tags[item.get('name')] = item.text or ''
        except _ET.ParseError:
            pass

    nodata = None
    if _T_GDAL_NODATA in tags:
        try:
            nodata = float(str(tags[_T_GDAL_NODATA]).strip())
        except ValueError:
            pass

    crs = _crs_from_geokeys(
        _as_tuple(tags.get(_T_GEO_KEYS, ())),
        _as_tuple(tags.get(_T_GEO_DOUBLES, ())),
        tags.get(_T_GEO_ASCII, ''),
    )

    from raider_tpu_torch.io.rasters import GDALAffine

    profile = {
        'width': width, 'height': height, 'count': spp,
        'dtype': out.dtype.name,
        'transform': GDALAffine(transform) if transform is not None else None,
        'crs': crs, 'nodata': nodata, 'driver': 'GTiff', 'tags': meta_tags,
    }
    return out, profile


def _entry(tag: int, ftype: int, values, data_heap: list, heap_base: list):
    """Build one 12-byte IFD entry; long values go to the heap."""
    ch, sz = _FIELD[ftype]
    if ftype == 2:
        raw = values.encode('latin-1') + b'\x00'
        count = len(raw)
    else:
        values = values if isinstance(values, (tuple, list)) else (values,)
        count = len(values)
        raw = struct.pack('<' + ch * count, *values)
    if len(raw) <= 4:
        return struct.pack('<HHI', tag, ftype, count) + raw.ljust(4, b'\x00')
    off = heap_base[0]
    data_heap.append(raw if len(raw) % 2 == 0 else raw + b'\x00')
    heap_base[0] += len(data_heap[-1])
    return struct.pack('<HHII', tag, ftype, count, off)


def write_gtiff(array: np.ndarray, path: str, transform=None,
                crs: Optional[CRS] = None, nodata: Optional[float] = None,
                compress: bool = False, metadata: Optional[dict] = None) -> None:
    """Write (rows, cols) or (bands, rows, cols) to a striped GeoTIFF.

    ``metadata`` key/value strings are stored as GDAL metadata (TIFF tag
    42112), round-tripping through ``read_gtiff``'s profile['tags'] and
    readable by GDAL/rasterio (``src.tags()``).
    """
    arr = np.asarray(array)
    if arr.ndim == 2:
        arr = arr[None]
    bands, height, width = arr.shape
    dt = arr.dtype
    fmt = {'u': 1, 'i': 2, 'f': 3}[dt.kind]
    arr = arr.astype(dt.newbyteorder('<'))

    # chunky interleave, one strip per ~64 rows
    rps = max(1, min(height, max(1, 65536 // max(1, width * bands * dt.itemsize))))
    interleaved = np.moveaxis(arr, 0, -1)  # (rows, cols, bands)
    strips = []
    for r0 in range(0, height, rps):
        raw = interleaved[r0:r0 + rps].tobytes()
        strips.append(zlib.compress(raw, 6) if compress else raw)

    entries = []
    heap: list = []
    # layout: header(8) + ifd + next(4) + heap + strip data

    def _escape(s: str) -> str:
        return (str(s).replace('&', '&amp;').replace('<', '&lt;')
                .replace('>', '&gt;').replace('"', '&quot;'))

    meta_xml = None
    if metadata:
        items = ''.join(
            f'  <Item name="{_escape(k)}">{_escape(v)}</Item>\n'
            for k, v in metadata.items()
        )
        meta_xml = f'<GDALMetadata>\n{items}</GDALMetadata>\n'

    def build(n_entries):
        ifd_off = 8
        heap_base = [ifd_off + 2 + 12 * n_entries + 4]
        heap.clear()
        entries.clear()
        add = lambda *a: entries.append(_entry(*a, heap, heap_base))
        add(_T_WIDTH, 3, width)
        add(_T_LENGTH, 3, height)
        add(_T_BITS, 3, tuple([dt.itemsize * 8] * bands))
        add(_T_COMPRESSION, 3, 8 if compress else 1)
        add(_T_PHOTOMETRIC, 3, 1)
        # strip offsets filled after we know the heap size
        strip_entry_idx = len(entries)
        add(_T_STRIP_OFFSETS, 4, tuple([0] * len(strips)))
        add(_T_SAMPLES_PER_PIXEL, 3, bands)
        add(_T_ROWS_PER_STRIP, 3, rps)
        add(_T_STRIP_COUNTS, 4, tuple(len(s) for s in strips))
        add(_T_PLANAR, 3, 1)
        add(_T_SAMPLE_FORMAT, 3, tuple([fmt] * bands))
        if transform is not None:
            gt = transform.to_gdal() if hasattr(transform, 'to_gdal') else tuple(transform)
            add(_T_PIXEL_SCALE, 12, (float(gt[1]), float(-gt[5]), 0.0))
            add(_T_TIEPOINT, 12, (0.0, 0.0, 0.0, float(gt[0]), float(gt[3]), 0.0))
        if crs is not None:
            epsg = crs.to_epsg()
            geographic = isinstance(crs, Geographic) or (epsg is not None and 4000 <= epsg < 5000)
            keys = [1, 1, 0, 2, _GK_MODEL_TYPE, 0, 1, 2 if geographic else 1,
                    _GK_RASTER_TYPE, 0, 1, 1]
            doubles: list = []

            def kd(kid, val):
                # double-valued key: value lives in the GeoDoubleParams tag
                keys.extend([kid, _T_GEO_DOUBLES, 1, len(doubles)])
                doubles.append(float(val))

            if geographic:
                keys += [_GK_GEOGRAPHIC_TYPE, 0, 1, epsg or 4326]
            elif epsg is not None:
                keys += [_GK_PROJECTED_TYPE, 0, 1, epsg]
            else:
                # user-defined projection (HRRR LCC / HRRR-AK polar stereo
                # have no EPSG code): full GeoKey parameter set, GDAL layout
                keys += [_GK_GEOGRAPHIC_TYPE, 0, 1, 32767,
                         _GK_PROJECTED_TYPE, 0, 1, 32767,
                         _GK_PROJECTION, 0, 1, 32767]
                ell = crs.ellipsoid
                kd(_GK_SEMI_MAJOR, ell.a)
                kd(_GK_INV_FLATTENING, (1.0 / ell.f) if ell.f else 0.0)
                if isinstance(crs, LambertConformalConic):
                    keys += [_GK_PROJ_COORD_TRANS, 0, 1, 8]   # LCC 2SP
                    kd(_GK_STD_PARALLEL1, crs.lat_1)
                    kd(_GK_STD_PARALLEL2,
                       crs.lat_2 if crs.lat_2 is not None else crs.lat_1)
                    kd(_GK_FALSE_ORIGIN_LONG, crs.lon_0)
                    kd(_GK_FALSE_ORIGIN_LAT, crs.lat_0)
                    kd(_GK_FALSE_ORIGIN_EASTING, crs.x_0)
                    kd(_GK_FALSE_ORIGIN_NORTHING, crs.y_0)
                elif isinstance(crs, PolarStereographic):
                    keys += [_GK_PROJ_COORD_TRANS, 0, 1, 15]  # polar stereo
                    # GDAL stores lat_ts (variant B) or the +-90 origin
                    # (variant A) in NatOriginLat; the sign picks the pole
                    kd(_GK_NAT_ORIGIN_LAT,
                       crs.lat_ts if crs.lat_ts is not None else crs.lat_0)
                    kd(_GK_VERT_POLE_LONG, crs.lon_0)
                    kd(_GK_SCALE_AT_NAT_ORIGIN, crs.k0)
                    kd(_GK_FALSE_EASTING, crs.x_0)
                    kd(_GK_FALSE_NORTHING, crs.y_0)
                elif isinstance(crs, TransverseMercator):
                    keys += [_GK_PROJ_COORD_TRANS, 0, 1, 1]   # TM
                    kd(_GK_NAT_ORIGIN_LAT, crs.lat_0)
                    kd(_GK_NAT_ORIGIN_LONG, crs.lon_0)
                    kd(_GK_SCALE_AT_NAT_ORIGIN, crs.k0)
                    kd(_GK_FALSE_EASTING, crs.x_0)
                    kd(_GK_FALSE_NORTHING, crs.y_0)
            keys[3] = (len(keys) - 4) // 4
            add(_T_GEO_KEYS, 3, tuple(keys))
            if doubles:
                add(_T_GEO_DOUBLES, 12, tuple(doubles))
        if meta_xml is not None:
            add(_T_GDAL_METADATA, 2, meta_xml)
        if nodata is not None:
            add(_T_GDAL_NODATA, 2, repr(float(nodata)) if dt.kind == 'f' else str(int(nodata)))
        return strip_entry_idx, heap_base[0]

    # counting pass (heap offsets wrong), then the real build with the
    # exact entry count - guessing the count is brittle and was never right
    build(0)
    n_entries = len(entries)
    strip_idx, data_start = build(n_entries)

    # patch in real strip offsets
    offs, pos = [], data_start
    for s in strips:
        offs.append(pos)
        pos += len(s) + (len(s) % 2)
    raw = struct.pack('<' + 'I' * len(offs), *offs)
    if len(raw) <= 4:
        entries[strip_idx] = struct.pack('<HHI', _T_STRIP_OFFSETS, 4, len(offs)) \
            + raw.ljust(4, b'\x00')
    else:
        # offsets array lives in the heap; find its slot (it was added first
        # with zeros of the same length) and overwrite
        old = struct.pack('<' + 'I' * len(offs), *([0] * len(offs)))
        for k, blob in enumerate(heap):
            if blob[:len(old)] == old:
                heap[k] = raw if len(raw) % 2 == 0 else raw + b'\x00'
                break

    with open(path, 'wb') as f:
        f.write(b'II' + struct.pack('<HI', 42, 8))
        f.write(struct.pack('<H', n_entries))
        f.write(b''.join(entries))
        f.write(struct.pack('<I', 0))  # no next IFD
        f.write(b''.join(heap))
        for s in strips:
            f.write(s)
            if len(s) % 2:
                f.write(b'\x00')
