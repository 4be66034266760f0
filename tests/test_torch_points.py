"""Point-type AOIs and point requests: the port vs the JAX package (CPU).

Every input is a file that both packages read, written from a numpy seed by
``raider_tpu_torch.scripts.point_inputs`` and the port's raster writers: a
station CSV, ENVI lat/lon/hgt rasters in radar coordinates, a geocoded DEM
(GeoTIFF), a GUNW-style geocube (netCDF-3), a 2-band incidence/heading
raster and an ESA EOF orbit file. The weather model is the smooth LA
dataset of tests/test_torch_slice.py.

Tolerances, with the compute dtype pinned on both sides: float64 <= 1e-9 m
(the same f64 geometry and quadrature; only rounding order differs),
float32 <= 1e-5 m (float32 cubes and refractivities), and the NaN masks
equal. AOI attributes (read points, heights, bounds, geotransform, the
raytracing buffer) are equal. Station CSVs are read with the stdlib by the
port and with pandas by the JAX package: the values are equal.
"""

import numpy as np
import pandas as pd
import pytest

from raider_tpu.delay import engine as j_engine
from raider_tpu.geometry import aoi as j_aoi
from raider_tpu.geometry import los as j_los
from raider_tpu_torch.convert import dataset_from_reference, orbit_from_reference
from raider_tpu_torch.delay import engine as t_engine
from raider_tpu_torch.geodesy import Geographic
from raider_tpu_torch.geometry import aoi as t_aoi
from raider_tpu_torch.geometry import los as t_los
from raider_tpu_torch.io import GDALAffine, write_envi, write_gtiff
from raider_tpu_torch.scripts import point_inputs

from tests.test_orbit import synthetic_orbit
from tests.test_torch_slice import T0, TOL, wm_dataset  # noqa: F401 (fixture)

RAY_HEIGHTS = [0.0, 1500.0]
SPACING_M = 10000.0


@pytest.fixture(scope='module')
def t_dataset(wm_dataset):  # noqa: F811
    return dataset_from_reference(wm_dataset)


@pytest.fixture(scope='module')
def files(tmp_path_factory):
    """The inputs of every AOI and LOS, written once."""
    d = tmp_path_factory.mktemp('points')
    rng = np.random.default_rng(11)
    f = {'dir': d}
    lat = rng.uniform(33.3, 33.7, 20)
    lon = rng.uniform(-117.9, -117.5, 20)
    f['stations'] = point_inputs.write_station_csv(d / 'stations.csv', lat, lon,
                                                   rng.uniform(0.0, 1400.0, 20), n_duplicates=3)
    # radar rasters: 12 x 10 pixels, heights 0-1200 m, one nodata pixel
    rlat, rlon = point_inputs.radar_grid((33.5, -117.7), (12, 10), (0.35, 0.3))
    hgt = point_inputs.terrain((12, 10), 0.0, 1200.0, seed=3)
    hgt[4, 6] = -9999.0
    for name, arr in (('lat', rlat), ('lon', rlon), ('hgt', hgt)):
        f[name] = str(d / f'{name}.rdr')
        write_envi(arr, f[name], nodata=-9999.0)
    # a 2-band incidence/heading raster on the radar grid
    inc = rng.uniform(30.0, 45.0, (12, 10))
    f['los'] = str(d / 'los.rdr')
    write_envi(np.stack([inc, np.full((12, 10), -12.0)]), f['los'], nodata=-9999.0)
    # a geocoded DEM, 16 x 20 pixels north-up
    dem = point_inputs.terrain((16, 20), 0.0, 1200.0, seed=4).astype(np.float32)
    f['dem'] = str(d / 'dem.tif')
    write_gtiff(dem, f['dem'], transform=GDALAffine((-117.9, 0.02, 0.0, 33.7, 0.0, -0.025)),
                crs=Geographic(), compress=True)
    f['geocube'] = point_inputs.write_geocube(d / 'geocube.nc', np.linspace(33.3, 33.7, 5),
                                              np.linspace(-117.9, -117.5, 6), RAY_HEIGHTS)
    f['eof'] = point_inputs.write_eof(d, synthetic_orbit(T0))
    return f


def make_aoi(pkg, kind, files, **kw):
    kw.setdefault('cube_spacing_in_m', SPACING_M)
    if kind == 'station':
        return pkg.StationFile(files['stations'], **kw)
    if kind == 'rdr':
        return pkg.RasterRDR(files['lat'], files['lon'], files['hgt'], **kw)
    if kind == 'geocoded':
        return pkg.GeocodedFile(files['dem'], is_dem=True, **kw)
    return pkg.Geocube(files['geocube'], **kw)


def make_los(pkg, kind, files):
    if kind == 'zenith':
        return pkg.Zenith()
    if kind == 'raytracing':
        orbit = synthetic_orbit(T0)
        return pkg.Raytracing(orbit=orbit if pkg is j_los else orbit_from_reference(orbit), time=T0)
    if kind == 'raytracing_eof':
        return pkg.Raytracing(filename=files['eof'], time=T0)
    if kind == 'conventional_raster':
        return pkg.Conventional(files['los'], time=T0)
    return pkg.Conventional(files['eof'], time=T0)


def calc_delays_grid(aoi):
    """The output grid of the calc-delays workflow: the AOI buffered by the
    model's 0.25 deg grid, on EPSG:4326 at the AOI's cube spacing."""
    aoi.add_buffer(0.25)
    aoi.set_output_xygrid(4326)


def run_both(wm_dataset, t_dataset, files, aoi_kind, los_kind, dtype,  # noqa: F811
             prepare=None, **kw):
    outs = []
    for pkg_aoi, pkg_los, engine, ds, extra in (
            (j_aoi, j_los, j_engine, wm_dataset, {}),
            (t_aoi, t_los, t_engine, t_dataset, {'device': 'cpu'})):
        aoi = make_aoi(pkg_aoi, aoi_kind, files)
        (prepare or calc_delays_grid)(aoi)
        outs.append(engine.tropo_delay(T0, ds, aoi, make_los(pkg_los, los_kind, files),
                                       compute_dtype=dtype, **kw, **extra))
    return outs


def assert_points_close(ref, out, tol):
    for a, b in zip(out, ref):
        a, b = np.asarray(a), np.asarray(b)
        assert a.shape == b.shape
        np.testing.assert_array_equal(np.isnan(a), np.isnan(b))
        assert np.nanmax(np.abs(a - b)) <= tol


CASES = [(a, los) for a in ('station', 'rdr', 'geocoded', 'geocube')
         for los in ('zenith', 'raytracing', 'raytracing_eof', 'conventional_eof')]
CASES += [('rdr', 'conventional_raster'), ('geocube', 'conventional_raster')]


@pytest.mark.parametrize('aoi_kind,los_kind', CASES)
@pytest.mark.parametrize('dtype', [np.float64, np.float32])
def test_tropo_delay_at_points_matches_jax(wm_dataset, t_dataset, files,  # noqa: F811
                                           aoi_kind, los_kind, dtype):
    ray = los_kind.startswith('raytracing')
    heights = RAY_HEIGHTS if ray and aoi_kind != 'geocube' else None
    ref, out = run_both(wm_dataset, t_dataset, files, aoi_kind, los_kind, dtype,
                        height_levels=heights)
    if aoi_kind == 'geocube':
        # a cube-type AOI: (Dataset, None), heights from the geocube
        assert ref[1] is None and out[1] is None
        ds_r, ds_o = ref[0], out[0]
        np.testing.assert_array_equal(ds_o.coords['z'].data, RAY_HEIGHTS)
        for k in ('x', 'y', 'z'):
            np.testing.assert_array_equal(ds_o.coords[k].data, np.asarray(ds_r.coords[k].data))
        assert ds_o.attrs['description'] == ds_r.attrs['description']
        assert_points_close([ds_r['wet'].data, ds_r['hydro'].data],
                            [ds_o['wet'].data, ds_o['hydro'].data], TOL[dtype])
        return
    assert_points_close(ref, out, TOL[dtype])
    wet = np.asarray(out[0])
    finite = np.isfinite(wet)
    # NaN exactly where the height is: the radar raster's nodata pixel, and
    # the geocoded grid's points off the DEM (a GeocodedFile's grid spans its
    # bounds, which add_buffer widened: the JAX package's grid, kept as it is)
    z_aoi = make_aoi(t_aoi, aoi_kind, files)
    calc_delays_grid(z_aoi)
    np.testing.assert_array_equal(finite, np.isfinite(z_aoi.readZ()))
    assert finite.any() and np.all(wet[finite] > 0.01)


@pytest.mark.parametrize('dtype', [np.float64, np.float32])
def test_descending_height_levels_at_points(wm_dataset, t_dataset, files, dtype):  # noqa: F811
    """Descending height_levels do not NaN out the point step: the cube's z
    axis is made ascending like its y axis (the JAX regression
    tests/test_delay_ztd.py::test_descending_height_levels_point_aoi)."""
    down = run_both(wm_dataset, t_dataset, files, 'station', 'zenith', dtype,
                    height_levels=[3000.0, 2000.0, 1000.0, 0.0])
    up = run_both(wm_dataset, t_dataset, files, 'station', 'zenith', dtype,
                  height_levels=[0.0, 1000.0, 2000.0, 3000.0])
    for d, u in zip(down[1], up[1]):
        assert np.isfinite(d).all()
        np.testing.assert_allclose(d, u, rtol=1e-6)
    assert_points_close(down[0], down[1], TOL[dtype])


@pytest.mark.parametrize('los_kind', ['zenith', 'conventional_eof'])
@pytest.mark.parametrize('dtype', [np.float64, np.float32])
def test_utm_out_proj_at_points(wm_dataset, t_dataset, files, los_kind, dtype):  # noqa: F811
    """Points moved into UTM 11N (float64) and sampled from a UTM cube."""
    def prepare(aoi):
        aoi.add_buffer(0.25)
        aoi.set_output_xygrid('EPSG:32611')

    ref, out = run_both(wm_dataset, t_dataset, files, 'station', los_kind, dtype, prepare,
                        height_levels=RAY_HEIGHTS, out_proj=32611)
    assert_points_close(ref, out, TOL[dtype])
    assert np.isfinite(out[0]).all()


def test_only_geocentric_out_proj_is_refused(wm_dataset, t_dataset, files):  # noqa: F811
    for engine, pkg, ds, kw in ((j_engine, j_aoi, wm_dataset, {}),
                                (t_engine, t_aoi, t_dataset, {'device': 'cpu'})):
        with pytest.raises(NotImplementedError):
            engine.tropo_delay(T0, ds, make_aoi(pkg, 'station', files),
                               (j_los if pkg is j_aoi else t_los).Zenith(), out_proj=4978, **kw)


def _equal(a, b, ulp: int = 0):
    """Equal shapes and NaN masks, and the values within ``ulp`` units in
    the last place (0: equal)."""
    if a is None or b is None:
        assert a is None and b is None
        return
    a, b = np.asarray(a, dtype=np.float64), np.asarray(b, dtype=np.float64)
    assert a.shape == b.shape
    np.testing.assert_array_equal(np.isnan(a), np.isnan(b))
    m = ~np.isnan(b)
    assert np.all(np.abs(a[m] - b[m]) <= ulp * np.spacing(np.abs(b[m]))), (a, b)


# pandas' default float parser is not correctly rounded: on 17-digit values
# it is now and then 1 ulp off Python's float(), which the port uses (and
# which pandas' float_precision='round_trip' matches exactly)
CSV_ULP = 1


@pytest.mark.parametrize('kind', ['bbox', 'station', 'rdr', 'rdr_dem', 'geocoded', 'geocube'])
def test_aoi_attributes_match_jax(files, kind):
    class _Look:
        name = 'LEFT'

    if kind == 'bbox':
        j, t = (pkg.BoundingBox([33.3, 33.7, -117.9, -117.5]) for pkg in (j_aoi, t_aoi))
    elif kind == 'rdr_dem':
        # heights from a local DEM when there is no height raster
        j, t = (pkg.RasterRDR(files['lat'], files['lon'], dem_file=files['dem'])
                for pkg in (j_aoi, t_aoi))
    else:
        j, t = make_aoi(j_aoi, kind, files), make_aoi(t_aoi, kind, files)
    ulp = CSV_ULP if kind == 'station' else 0
    assert t.type() == j.type()
    _equal(t.bounds(), j.bounds(), ulp)
    assert t.projection().to_cf() == j.projection().to_cf()
    assert t.geotransform() == j.geotransform()
    for direction, look in (('asc', 'right'), ('desc', 'right'), ('asc', _Look()),
                            ('DESC', 'Left')):
        _equal(t.calc_buffer_ray(direction, lookDir=look),
               j.calc_buffer_ray(direction, lookDir=look), ulp)
    if kind == 'bbox':
        for bad in (('north', 'right'), ('asc', 'up')):
            with pytest.raises(ValueError):
                t.calc_buffer_ray(bad[0], lookDir=bad[1])
        return
    for a, b in zip(t.readLL(), j.readLL()):
        _equal(a, b, ulp)
    _equal(t.readZ(), j.readZ(), ulp)
    t.add_buffer(0.25)
    j.add_buffer(0.25)
    _equal(t.bounds(), j.bounds())


def _write(path, text):
    path.write_text(text)
    return str(path)


CSVS = {
    'duplicates_extra_reordered':
        'Hgt_m,Name,Lon,Extra,Lat\n'
        '10.5,A,-117.8,x,33.4\n'
        '20.25,B,-117.7,y,33.5\n'
        '99.0,A2,-117.8,z,33.4\n'
        '30.125,C,-117.6000000001,w,33.6123456789012\n'
        '40.0,D,-117.7,v,33.5\n'
        '50.0,E,-117.55,u,33.45\n',
    'blank_heights_nan_pairs_signed_zero':
        'ID,Lat,Lon,Hgt_m\n'
        'A,33.4,-117.8,\n'
        'B,,,5.0\n'
        'C,33.5,-117.7,7.5\n'
        'D,,,8.0\n'
        'E,0.0,-0.0,1.0\n'
        'F,-0.0,0.0,2.0\n'
        'G,33.6,-117.6\n',
    'integer_columns':
        'Lat,Lon,Hgt_m,ID\n33,-117,100,1\n34,-118,200,2\n33,-117,300,3\n',
}


@pytest.mark.parametrize('name', sorted(CSVS))
def test_station_csv_matches_pandas(tmp_path, name):
    """The port's stdlib reader against the JAX class's pandas one:
    the same stations, in the same order, to the same values."""
    f = _write(tmp_path / 'st.csv', CSVS[name])
    j, t = j_aoi.StationFile(f), t_aoi.StationFile(f)
    df = pd.read_csv(f, float_precision='round_trip').drop_duplicates(subset=['Lat', 'Lon'])
    for a, b, c in zip(t.readLL(), j.readLL(), (df['Lat'], df['Lon'])):
        _equal(a, b, CSV_ULP)
        _equal(a, c.to_numpy())
    _equal(t.readZ(), j.readZ(), CSV_ULP)
    _equal(t.bounds(), j_aoi.bounds_from_csv(f), CSV_ULP)
    _equal(t_aoi.bounds_from_csv(f), j.bounds(), CSV_ULP)


def test_station_heights_from_a_local_dem(tmp_path, files):
    """No Hgt_m column: heights come from the DEM (nearest pixel), and the
    CSV is rewritten with the new column, its duplicates dropped; pandas
    reads the port's rewrite to the values of the JAX package's."""
    text = ('ID,Lat,Lon,Extra\nA,33.41,-117.83,1\nB,33.52,-117.61,2\nA,33.41,-117.83,3\n'
            'C,33.66,-117.51,4\nD,33.2,-117.7,5\n')
    f_j, f_t = _write(tmp_path / 'j.csv', text), _write(tmp_path / 't.csv', text)
    z_j = j_aoi.StationFile(f_j, demFile=files['dem']).readZ()
    t = t_aoi.StationFile(f_t, demFile=files['dem'])
    z_t = t.readZ()
    _equal(z_t, z_j)
    assert z_t.shape == (4,) and np.isfinite(z_t[:3]).all() and np.isnan(z_t[3])  # D: off the DEM
    df_j, df_t = pd.read_csv(f_j), pd.read_csv(f_t)
    assert list(df_t.columns) == list(df_j.columns)
    for c in df_j.columns:
        if c == 'ID':
            assert list(df_t[c]) == list(df_j[c])
        else:
            _equal(df_t[c].to_numpy(), df_j[c].to_numpy(), CSV_ULP)
    _equal(t.readZ(), z_j, CSV_ULP)
    _equal(t.bounds(), j_aoi.bounds_from_csv(f_j), CSV_ULP)


def test_geocoded_file_keeps_the_jax_grid(files):
    """GeocodedFile.readLL steps (E - W) / w over rio_extents' bounds, which
    span w - 1 pixels: the JAX package's grid, kept so the results agree."""
    t = make_aoi(t_aoi, 'geocoded', files)
    S, N, W, E = t.bounds()
    lat, lon = t.readLL()
    assert lon.shape == (16, 20)
    np.testing.assert_allclose(lon[0, 1] - lon[0, 0], (E - W) / 20, rtol=1e-12)
    np.testing.assert_allclose(E - W, 0.02 * 19, rtol=1e-12)


def test_dem_download_needs_dem_stitcher(tmp_path, files):
    from raider_tpu_torch.workflows.dem import download_dem, interpolate_dem

    z, prof = download_dem(dem_path=files['dem'])
    assert z.shape == (16, 20) and prof['driver'] == 'GTiff'
    with pytest.raises(ValueError):
        download_dem(dem_path=tmp_path / 'absent.tif')
    try:
        import dem_stitcher  # noqa: F401
    except ImportError:
        with pytest.raises(ImportError, match='dem_stitcher'):
            download_dem([33.0, 34.0, -118.0, -117.0], dem_path=tmp_path / 'absent.tif')
    from raider_tpu.workflows.dem import interpolate_dem as j_interp

    lat = np.array([[33.41, 33.52], [33.69, 33.2]])
    lon = np.array([[-117.83, -117.61], [-117.51, -117.7]])
    _equal(interpolate_dem(files['dem'], (lat, lon)), j_interp(files['dem'], (lat, lon)))


def test_geocube_reads_netcdf3_and_tropo_delay_files(tmp_path, files, t_dataset):
    """A Geocube on the netCDF-3 file of point_inputs, and on a delay cube
    (y/x coordinates, z heights) written by tropo_delay."""
    from raider_tpu_torch.io import write_nc

    g = make_aoi(t_aoi, 'geocube', files)
    np.testing.assert_array_equal(g.bounds(), [33.3, 33.7, -117.9, -117.5])
    ds, _ = t_engine.tropo_delay(T0, t_dataset, t_aoi.BoundingBox([33.3, 33.7, -117.9, -117.5],
                                                                  cube_spacing_in_m=SPACING_M),
                                 t_los.Zenith(), height_levels=RAY_HEIGHTS, device='cpu')
    path = str(tmp_path / 'g.nc')
    write_nc(ds, path)
    for pkg in (j_aoi, t_aoi):
        c = pkg.Geocube(path)
        np.testing.assert_array_equal(c.readZ(), RAY_HEIGHTS)
        assert c.readLL()[0].shape == (ds.coords['y'].data.size, ds.coords['x'].data.size)


def test_conventional_projection_at_points(wm_dataset, t_dataset, files):  # noqa: F811
    """A projected request at points is the zenith request divided by the
    factor (the raster's cos(incidence), or the orbit's), and its cube is
    the zenith cube labelled 'slant - projected'."""
    from raider_tpu_torch.geometry.orbit import get_orbit, state_to_los_factor
    from raider_tpu_torch.io import rio_open

    zen = run_both(wm_dataset, t_dataset, files, 'rdr', 'zenith', np.float64)[1]
    lat, lon = make_aoi(t_aoi, 'rdr', files).readLL()
    hgt, _ = rio_open(files['hgt'])
    inc, _ = rio_open(files['los'], band=1)
    raster = run_both(wm_dataset, t_dataset, files, 'rdr', 'conventional_raster', np.float64)[1]
    eof = run_both(wm_dataset, t_dataset, files, 'rdr', 'conventional_eof', np.float64)[1]
    factor = state_to_los_factor(get_orbit(files['eof'], T0), lat, lon, hgt).numpy()
    for z, r, o in zip(zen, raster, eof):
        np.testing.assert_allclose(r, z / np.cos(np.deg2rad(inc)), rtol=1e-12)
        np.testing.assert_allclose(o, z / factor, rtol=1e-12)
        fin = np.isfinite(z)
        assert np.all(o[fin] > z[fin]) and np.all(r[fin] > z[fin])
    box = [33.3, 33.7, -117.9, -117.5]
    cubes = [t_engine.tropo_delay(T0, t_dataset,
                                  t_aoi.BoundingBox(box, cube_spacing_in_m=SPACING_M), los,
                                  height_levels=RAY_HEIGHTS, device='cpu')[0]
             for los in (t_los.Zenith(), make_los(t_los, 'conventional_eof', files))]
    assert cubes[1].attrs['description'] == 'RAiDER geo cube - slant - projected'
    np.testing.assert_array_equal(cubes[1]['wet'].data, cubes[0]['wet'].data)


def test_weather_model_accessors_match_jax():
    """getLLRes and dtime, which the calc-delays steps call, for every
    model; getPoints returns copies of the grids."""
    import torch

    from raider_tpu.wx.registry import get_wm_by_name as j_get
    from raider_tpu_torch.wx.registry import ALLOWED_MODELS, get_wm_by_name as t_get

    for name in ALLOWED_MODELS:
        j, t = j_get(name)[1](), t_get(name)[1]()
        assert t.getLLRes() == j.getLLRes() and t.dtime() == j.dtime(), name
    t._xs, t._ys = np.arange(3.0), torch.arange(4.0)
    t._zs = np.linspace(0.0, 10.0, 5)
    xs, ys, zs = t.getPoints()
    xs[0], ys[0], zs[0] = -1.0, -1.0, -1.0
    assert t._xs[0] == 0.0 and float(t._ys[0]) == 0.0 and t._zs[0] == 0.0
    assert isinstance(ys, torch.Tensor) and zs.shape == (5,)


def test_crop_hrrr_writes_what_the_fetcher_keeps(tmp_path):
    """``raw_weather.crop_hrrr`` keeps the rows and columns
    ``get_bounds_indices`` finds (the fetcher's cut) of every variable, and
    the model loads from the cut file."""
    from scipy.io import netcdf_file

    from raider_tpu_torch.scripts import raw_weather
    from raider_tpu_torch.wx.hrrr import get_bounds_indices, load_weather_hrrr

    src, dst = str(tmp_path / 'whole.nc'), str(tmp_path / 'cut.nc')
    raw_weather.write_hrrr(src, nz=6, grid=('lcc', 60, 50, 3000.0, 37.0, 260.0), device='cpu')
    bounds = [37.3, 37.9, -99.6, -99.1]
    ny, nx = raw_weather.crop_hrrr(src, dst, bounds)
    with netcdf_file(src, 'r', mmap=False) as f, netcdf_file(dst, 'r', mmap=False) as g:
        x0, x1, y0, y1 = get_bounds_indices(np.array(bounds[:2] + [260.4, 260.9]),
                                            f.variables['latitude'][:],
                                            f.variables['longitude'][:])
        assert (ny, nx) == (y1 - y0, x1 - x0) and 0 < ny < 60 and 0 < nx < 50
        np.testing.assert_array_equal(g.variables['t'][:], f.variables['t'][:, y0:y1, x0:x1])
        np.testing.assert_array_equal(g.variables['x'][:], f.variables['x'][x0:x1])
        assert g.variables['proj']._attributes == f.variables['proj']._attributes
    xs, ys, lons, lats, qs = load_weather_hrrr(dst, device='cpu')[:5]
    assert tuple(qs.shape) == (ny, nx, 6) and lats.shape == (ny, nx) and xs.size == nx
    # q_scale scales the humidity of the cut, and nothing else
    scaled = str(tmp_path / 'scaled.nc')
    assert raw_weather.crop_hrrr(src, scaled, bounds, q_scale=1.25) == (ny, nx)
    with netcdf_file(dst, 'r', mmap=False) as g, netcdf_file(scaled, 'r', mmap=False) as h:
        np.testing.assert_array_equal(h.variables['q'][:], g.variables['q'][:] * np.float32(1.25))
        for name in ('t', 'pres', 'z', 'latitude'):
            np.testing.assert_array_equal(h.variables[name][:], g.variables[name][:])
    # p_scale and t_scale scale the pressure and the temperature, and nothing else
    assert raw_weather.crop_hrrr(src, scaled, bounds, p_scale=1.01, t_scale=0.99) == (ny, nx)
    with netcdf_file(dst, 'r', mmap=False) as g, netcdf_file(scaled, 'r', mmap=False) as h:
        for name, scale in (('pres', 1.01), ('t', 0.99)):
            np.testing.assert_array_equal(h.variables[name][:],
                                          g.variables[name][:] * np.float32(scale))
        for name in ('q', 'z', 'latitude'):
            np.testing.assert_array_equal(h.variables[name][:], g.variables[name][:])
