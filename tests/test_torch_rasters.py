"""Raster IO: the port's ENVI, VRT and GeoTIFF code vs the JAX package's.

Both packages write the same bytes for the same array (ENVI data and
header, GeoTIFF in every layout and compression the JAX writer makes:
striped, one or many strips, multiband chunky, deflate or none, EPSG and
user-defined GeoKeys, GDAL metadata and nodata), and each reads the other's
files back to equal arrays and profiles. Files from PIL cover the reader's
LZW and packbits decoders and a foreign striping; hand-written VRTs and a
PAM ``.aux.xml`` sidecar cover the remaining readers.
"""

import numpy as np
import pytest

import raider_tpu.geodesy as j_geodesy
import raider_tpu.io.geotiff as j_gtiff
import raider_tpu.io.rasters as j_rasters
import raider_tpu_torch.geodesy as t_geodesy
import raider_tpu_torch.io.geotiff as t_gtiff
import raider_tpu_torch.io.rasters as t_rasters

GT = (-118.0, 0.01, 0.0, 36.0, 0.0, -0.01)


def assert_profiles_equal(a: dict, b: dict):
    assert a.keys() == b.keys()
    for k in a:
        if k == 'crs':
            assert (a[k] is None) == (b[k] is None)
            if a[k] is not None:
                assert a[k].to_cf() == b[k].to_cf()
        else:
            assert a[k] == b[k], k


def assert_read_equal(path, reader):
    t_mod, j_mod = (t_gtiff, j_gtiff) if reader == 'read_gtiff' else (t_rasters, j_rasters)
    da, pa = getattr(t_mod, reader)(path)
    db, pb = getattr(j_mod, reader)(path)
    assert da.dtype == db.dtype
    np.testing.assert_array_equal(da, db)
    assert_profiles_equal(pa, pb)
    return da, pa


def _arrays():
    rng = np.random.default_rng(0)
    return {
        'f32': rng.normal(size=(21, 17)).astype(np.float32),
        'f64': rng.normal(size=(9, 11)),
        'i16': rng.integers(-500, 500, (13, 7)).astype(np.int16),
        'u8': rng.integers(0, 255, (5, 6)).astype(np.uint8),
        'f32_2band': rng.normal(size=(2, 8, 10)).astype(np.float32),
    }


@pytest.mark.parametrize('name', sorted(_arrays()))
@pytest.mark.parametrize('georef', [False, True])
def test_envi_round_trip_across_packages(tmp_path, name, georef):
    arr = _arrays()[name]
    kw = dict(transform=t_rasters.GDALAffine(GT) if georef else None, nodata=-9999.0)
    paths = {}
    for tag, mod in (('t', t_rasters), ('j', j_rasters)):
        paths[tag] = str(tmp_path / f'{tag}.rdr')
        mod.write_envi(arr, paths[tag], **kw)
    for suffix in ('', '.hdr'):
        with open(paths['t'] + suffix, 'rb') as a, open(paths['j'] + suffix, 'rb') as b:
            assert a.read() == b.read()
    data, prof = assert_read_equal(paths['j'], 'read_envi')
    assert_read_equal(paths['t'], 'read_envi')
    np.testing.assert_array_equal(data.squeeze(), arr)
    assert prof['nodata'] == -9999.0
    out_t, _ = t_rasters.rio_open(paths['j'])
    out_j, _ = j_rasters.rio_open(paths['t'])
    np.testing.assert_array_equal(out_t, out_j)


def _crs_pairs():
    from raider_tpu.wx import hrrr as j_hrrr
    from raider_tpu_torch.wx import hrrr as t_hrrr

    tm = dict(lon_0=9.0, lat_0=0.0, k0=0.9996, x_0=500000.0, y_0=0.0)
    return {
        'geographic': (t_geodesy.Geographic(), j_geodesy.Geographic()),
        'utm_32611': (t_geodesy.crs_from_epsg(32611), j_geodesy.crs_from_epsg(32611)),
        'hrrr_lcc': (t_hrrr.HRRR_CONUS_PROJ, j_hrrr.HRRR_CONUS_PROJ),
        'hrrr_ak_polar': (t_hrrr.HRRR_AK_PROJ, j_hrrr.HRRR_AK_PROJ),
        'custom_tm': (t_geodesy.TransverseMercator(**tm), j_geodesy.TransverseMercator(**tm)),
    }


GTIFF_CASES = {
    # name: (array, crs name or None, keywords)
    'multiband_f32_nodata': ((3, 21, 17), np.float32, 'geographic', dict(nodata=-9999.0)),
    'i16_deflate_nodata0': ((1, 64, 200), np.int16, None, dict(compress=True, nodata=0)),
    'f64_utm': ((1, 3, 4), np.float64, 'utm_32611', {}),
    'many_strips_deflate': ((2, 700, 300), np.float32, None, dict(compress=True)),
    'lcc_user_keys': ((3, 4), np.float32, 'hrrr_lcc', {}),
    'polar_user_keys': ((3, 4), np.float32, 'hrrr_ak_polar', {}),
    'tm_user_keys': ((3, 4), np.float32, 'custom_tm', {}),
    'metadata_u8': ((30, 40), np.uint8, 'geographic',
                    dict(metadata={'AREA_OR_POINT': 'Point', 'note': 'a<b & "c"'})),
}


@pytest.mark.parametrize('name', sorted(GTIFF_CASES))
def test_geotiff_round_trip_across_packages(tmp_path, name):
    shape, dtype, crs_name, kw = GTIFF_CASES[name]
    rng = np.random.default_rng(len(name))
    arr = (rng.normal(size=shape) * 100).astype(dtype)
    crs = _crs_pairs()[crs_name] if crs_name else (None, None)
    gt = (400000.0, 30.0, 0.0, 3700000.0, 0.0, -30.0) if crs_name == 'utm_32611' else GT
    paths = {}
    for tag, mod, c in (('t', t_gtiff, crs[0]), ('j', j_gtiff, crs[1])):
        paths[tag] = str(tmp_path / f'{tag}.tif')
        mod.write_gtiff(arr, paths[tag], transform=gt, crs=c, **kw)
    with open(paths['t'], 'rb') as a, open(paths['j'], 'rb') as b:
        assert a.read() == b.read()
    data, prof = assert_read_equal(paths['j'], 'read_gtiff')
    np.testing.assert_array_equal(data.reshape(arr.shape), arr)
    if crs_name:
        assert prof['crs'].to_cf() == crs[0].to_cf()
    np.testing.assert_allclose(prof['transform'].to_gdal(), gt, atol=1e-12)
    assert_profiles_equal(t_rasters.rio_profile(paths['j']), j_rasters.rio_profile(paths['t']))


@pytest.mark.parametrize('compression', ['raw', 'tiff_adobe_deflate', 'tiff_lzw', 'packbits'])
def test_both_readers_on_pil_files(tmp_path, compression):
    """Foreign files: PIL's striping, and the LZW (code-width growth, table
    resets) and packbits decoders."""
    PIL = pytest.importorskip('PIL.Image')
    rng = np.random.default_rng(7)
    big = np.repeat(rng.integers(0, 40, (300, 211), dtype=np.uint8), 3, axis=1)[:, :211]
    smooth = np.cumsum(np.ones((257, 129), np.float32) * 0.5, axis=0)
    noisy = rng.normal(size=(50, 33)).astype(np.float32)
    for i, img in enumerate((big, smooth, noisy)):
        if compression == 'packbits' and img.dtype != np.uint8:
            continue
        f = str(tmp_path / f'{i}.tif')
        PIL.fromarray(img).save(f, compression=compression)
        data, prof = assert_read_equal(f, 'read_gtiff')
        np.testing.assert_array_equal(data[0], img)
        assert prof['dtype'] == img.dtype.name


def _raw_vrt(tmp_path, arr):
    arr.astype('>f4').tofile(str(tmp_path / 'raw.bin'))
    h, w = arr.shape
    path = tmp_path / 'raw.vrt'
    path.write_text(
        f'<VRTDataset rasterXSize="{w}" rasterYSize="{h}">\n'
        '  <SRS>EPSG:4326</SRS>\n'
        '  <GeoTransform>-118.0, 0.01, 0.0, 36.0, 0.0, -0.01</GeoTransform>\n'
        '  <VRTRasterBand dataType="Float32" band="1" subClass="VRTRawRasterBand">\n'
        '    <NoDataValue>-9999</NoDataValue>\n'
        '    <SourceFilename relativeToVRT="1">raw.bin</SourceFilename>\n'
        '    <ImageOffset>0</ImageOffset><PixelOffset>4</PixelOffset>\n'
        f'    <LineOffset>{4 * w}</LineOffset>\n'
        '    <ByteOrder>MSB</ByteOrder>\n'
        '  </VRTRasterBand>\n</VRTDataset>\n')
    return str(path)


def _simple_vrt(tmp_path, arr2):
    t_rasters.write_envi(arr2, str(tmp_path / 'los.rdr'), nodata=0.0)
    _, h, w = arr2.shape
    bands = ''.join(
        f'  <VRTRasterBand dataType="Float64" band="{b}">\n'
        f'    <SimpleSource><SourceFilename relativeToVRT="1">los.rdr</SourceFilename>'
        f'<SourceBand>{b}</SourceBand></SimpleSource>\n  </VRTRasterBand>\n' for b in (1, 2))
    path = tmp_path / 'los.rdr.vrt'
    path.write_text(f'<VRTDataset rasterXSize="{w}" rasterYSize="{h}">\n{bands}</VRTDataset>\n')
    return str(path)


def test_vrt_readers_and_sidecar_preference(tmp_path):
    rng = np.random.default_rng(3)
    arr = rng.normal(size=(6, 9)).astype(np.float32)
    arr[2, 3] = -9999.0
    data, prof = assert_read_equal(_raw_vrt(tmp_path, arr), 'read_vrt')
    np.testing.assert_array_equal(data[0], arr)
    assert prof['nodata'] == -9999.0 and prof['crs'].to_cf() == t_geodesy.Geographic().to_cf()
    out, _ = t_rasters.rio_open(str(tmp_path / 'raw.vrt'))
    assert np.isnan(out[2, 3]) and np.isfinite(out).sum() == arr.size - 1

    arr2 = rng.normal(size=(2, 5, 4))
    vrt = _simple_vrt(tmp_path, arr2)
    data, _ = assert_read_equal(vrt, 'read_vrt')
    np.testing.assert_array_equal(data, arr2)
    # rio_profile and rio_stats prefer the .vrt sidecar
    rdr = str(tmp_path / 'los.rdr')
    for mod in (t_rasters, j_rasters):
        assert mod.rio_profile(rdr)['driver'] == 'VRT'
        assert mod.rio_profile(rdr)['count'] == 2
    st_t, crs_t, gt_t = t_rasters.rio_stats(rdr, band=2)
    st_j, crs_j, gt_j = j_rasters.rio_stats(rdr, band=2)
    assert (st_t.min, st_t.max, st_t.mean, st_t.std) == (st_j.min, st_j.max, st_j.mean, st_j.std)
    assert crs_t is crs_j is None and gt_t == gt_j


def test_pam_nodata_sidecar(tmp_path):
    """A GeoTIFF without GDAL_NODATA takes its nodata from a GDAL PAM
    ``.aux.xml`` sidecar."""
    arr = np.arange(12.0, dtype=np.float32).reshape(3, 4)
    f = str(tmp_path / 'pam.tif')
    t_gtiff.write_gtiff(arr, f, transform=GT)
    (tmp_path / 'pam.tif.aux.xml').write_text(
        '<PAMDataset>\n  <PAMRasterBand band="1">\n    <NoDataValue>5</NoDataValue>\n'
        '  </PAMRasterBand>\n</PAMDataset>\n')
    out_t, prof_t = t_rasters.rio_open(f)
    out_j, prof_j = j_rasters.rio_open(f)
    np.testing.assert_array_equal(out_t, out_j)
    assert prof_t['nodata'] == prof_j['nodata'] == 5.0 and np.isnan(out_t[1, 1])


def test_latlon_bounds_extents_and_writers(tmp_path):
    ny, nx = 6, 8
    lat = np.linspace(33.2, 33.9, ny)[:, None] * np.ones((1, nx))
    lon = np.ones((ny, 1)) * np.linspace(-118.2, -117.2, nx)[None, :]
    for name, a in (('lat', lat), ('lon', lon)):
        t_rasters.write_envi(a, str(tmp_path / f'{name}.rdr'), nodata=-9999.0)
    args = (str(tmp_path / 'lat.rdr'), str(tmp_path / 'lon.rdr') + ';1')
    snwe_t, proj_t, gt_t = t_rasters.bounds_from_latlon_rasters(*args)
    snwe_j, proj_j, gt_j = j_rasters.bounds_from_latlon_rasters(*args)
    assert snwe_t == snwe_j == (33.2, 33.9, -118.2, -117.2)
    assert proj_t.to_cf() == proj_j.to_cf() and gt_t == gt_j
    for s in ('a.tif', 'b.rdr; 2'):
        assert t_rasters.get_file_and_band(s) == j_rasters.get_file_and_band(s)
    with pytest.raises(ValueError):
        t_rasters.get_file_and_band('a;1;2')
    prof = {'transform': t_rasters.GDALAffine(GT), 'width': 17, 'height': 21}
    assert t_rasters.rio_extents(prof) == j_rasters.rio_extents(prof)
    # writeArrayToRaster: float32 ENVI and GTiff, the same bytes
    arr = np.random.default_rng(1).normal(size=(5, 7))
    for fmt, suffix in (('ENVI', '.rdr'), ('GTiff', '.tif')):
        paths = [str(tmp_path / f'{tag}{suffix}') for tag in ('t', 'j')]
        t_rasters.writeArrayToRaster(arr, paths[0], noDataValue=-1.0, fmt=fmt,
                                     proj=t_geodesy.Geographic(), gt=GT)
        j_rasters.writeArrayToRaster(arr, paths[1], noDataValue=-1.0, fmt=fmt,
                                     proj=j_geodesy.Geographic(), gt=GT)
        with open(paths[0], 'rb') as a, open(paths[1], 'rb') as b:
            assert a.read() == b.read()
    with pytest.raises(RuntimeError):
        t_rasters.writeArrayToRaster(np.zeros(3), str(tmp_path / 'x.rdr'))
