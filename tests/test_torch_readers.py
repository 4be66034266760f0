"""Weather-model readers: raider_tpu_torch.wx vs raider_tpu.wx (CPU).

Each family's raw file is written as the JAX package's tests write it
(tests/test_model_goldens.py, tests/test_ecmwf_raw.py and the HRRR
roundtrip of tests/test_fetchers.py); both packages' ``load()`` process it
and the results are compared at the tolerances of tests/test_torch_wx.py:

  * refractivities: rtol 1e-6 (float32 of float64 interpolation);
  * ZTD totals: rtol 1e-5, atol 1e-9 m (the port's float32 top-down scan,
    kernel B1's twin, against the JAX package's float64 one on the CPU);
  * the z ladder, grid axes, lat/lon grids: rtol 1e-12; the CRS: equal CF.

Two more cases read the classic netCDF-3 files of
``raider_tpu_torch.scripts.raw_weather`` (what chip_smoke.py phase 8
writes), which the JAX package reads through scipy too. That wrfout file
holds float32, and both readers compute its temperature (Poisson's
equation) and rh in float32, as the JAX reader does: numpy's and torch's
float32 ``pow`` differ by an ulp in T, which the saturation vapour pressure
turns into up to 5e-6 relative in rh and e, so its refractivities and
totals are held to rtol 2e-5.

The port also reaches the per-model digests pinned in
tests/test_model_goldens.py (abs 1e-5 m), copied here because the machine
with the card has no jax.
"""

import datetime as dt
import shutil
import sys

import numpy as np
import pytest
import torch

import tests.test_model_goldens as goldens
from raider_tpu.io.ncdf import Dataset, Variable, write_nc
from raider_tpu.wx.registry import get_wm_by_name as j_get
from raider_tpu_torch.scripts import raw_weather
from raider_tpu_torch.wx.base import make_raw_weather_data_filename
from raider_tpu_torch.wx.registry import ALLOWED_MODELS, get_wm_by_name as t_get

from tests.test_fetchers import _FakeXrDataset, _FakeXrVar, _module

# tests/test_model_goldens.py:50-57: hydro, wet ZTD [m] at the first ladder
# node at or above 0 m, column (0, 0)
DIGEST = {
    'ERA5T': (2.273892, 0.254148),
    'ERAI': (2.215347, 0.248294),
    'HRES': (2.273796, 0.254137),
    'MERRA2': (2.308765, 0.257483),
    'NCMR': (2.309069, 0.258282),
    'WRF': (2.177287, 0.253182),
}
BBOX = goldens.BBOX
HRRR_BBOX = np.array([33.3, 34.2, -117.8, -116.8])
AK_BBOX = np.array([60.5, 61.5, -151.0, -149.0])
T0, P0 = 270.0, 101325.0


def _write_pl_raw(path):
    """ERA5 pressure levels (tests/test_ecmwf_raw.py): descending lats,
    0-360 lons, levels in ascending hPa."""
    from raider_tpu.constants import R_D, _g0

    lats = np.arange(35.0, 31.99, -0.25)
    lons = np.arange(240.0, 245.01, 0.25)
    levels = np.array([10.0, 50.0, 100.0, 300.0, 500.0, 700.0, 850.0, 1000.0])
    nz, ny, nx = levels.size, lats.size, lons.size
    z_m = -R_D * T0 / _g0 * np.log(levels * 100.0 / P0)
    rng = np.random.default_rng(7)
    ds = Dataset(
        coords={'latitude': Variable(('latitude',), lats),
                'longitude': Variable(('longitude',), lons),
                'level': Variable(('level',), levels)},
        variables={
            'z': Variable(('level', 'latitude', 'longitude'),
                          np.broadcast_to((z_m * _g0)[:, None, None], (nz, ny, nx)).copy()),
            't': Variable(('level', 'latitude', 'longitude'),
                          T0 + rng.normal(0.0, 1.0, (nz, ny, nx))),
            'q': Variable(('level', 'latitude', 'longitude'),
                          0.004 * np.exp(-z_m / 2000.0)[:, None, None]
                          * rng.uniform(0.8, 1.2, (nz, ny, nx))),
        })
    write_nc(ds, str(path))


def _write_hrrr_raw(path, ak=False, n=41, nz=12, bbox=None):
    """A raw HRRR file through the JAX package's ``download_hrrr_file`` with a
    fake Herbie (tests/test_fetchers.py): an n x n patch of the native 3 km
    grid around the box, standard-atmosphere fields with seeded noise."""
    from raider_tpu.geodesy import Geographic, transform_points
    from raider_tpu.wx import hrrr as j_hrrr

    if bbox is None:
        bbox = AK_BBOX if ak else HRRR_BBOX
    proj = j_hrrr.HRRR_AK_PROJ if ak else j_hrrr.HRRR_CONUS_PROJ
    x0, y0 = (float(np.asarray(v)) for v in transform_points(
        Geographic(), proj, np.array(bbox[2:].mean()), np.array(bbox[:2].mean()))[:2])
    xs = x0 + 3000.0 * np.arange(-(n // 2), n // 2 + 1)
    ys = y0 + 3000.0 * np.arange(-(n // 2), n // 2 + 1)
    xg, yg = np.meshgrid(xs, ys)
    lon2, lat2 = (np.asarray(v) for v in proj.inverse(xg, yg))
    rng = np.random.default_rng(3 if ak else 2)
    shp = (nz, ys.size, xs.size)
    terrain = rng.uniform(0.0, 800.0, shp[1:])
    sigma = np.linspace(0.0, 1.0, nz)[:, None, None] ** 1.5
    gh = terrain + (26000.0 - terrain) * sigma
    t = 288.15 - 0.0065 * np.minimum(gh, 11000.0) + rng.normal(0.0, 0.5, shp)
    p = P0 * np.exp(-gh / 8000.0)
    q = 0.012 * np.exp(-gh / 2000.0) * rng.uniform(0.7, 1.1, shp)
    variables = {k: _FakeXrVar(v, ('hybrid', 'y', 'x'))
                 for k, v in (('gh', gh), ('t', t), ('q', q), ('pres', p))}
    coords = {'hybrid': _FakeXrVar(np.arange(nz), ('hybrid',)),
              'latitude': _FakeXrVar(lat2, ('y', 'x')),
              'longitude': _FakeXrVar(lon2 % 360.0, ('y', 'x'))}
    fake = _FakeXrDataset(variables, coords)

    class Herbie:
        def __init__(self, *args, **kwargs):
            pass

        def xarray(self, regex, verbose=False):
            return [fake]

    saved = sys.modules.get('herbie')
    sys.modules['herbie'] = _module('herbie', Herbie=Herbie)
    try:
        j_hrrr.download_hrrr_file(bbox, dt.datetime(2020, 1, 30, 14), str(path),
                                  model='hrrrak' if ak else 'hrrr')
    finally:
        if saved is None:
            del sys.modules['herbie']
        else:
            sys.modules['herbie'] = saved


CASES = {
    # name: (registry name, raw writer, time, bounds, level type)
    'ERA5': ('ERA5', lambda p: goldens._write_ecmwf_raw(p, 137), dt.datetime(2020, 1, 30, 14),
             BBOX, None),
    'ERA5_pl': ('ERA5', _write_pl_raw, dt.datetime(2020, 1, 30, 14), BBOX, 'pl'),
    'ERA5T': ('ERA5T', lambda p: goldens._write_ecmwf_raw(p, 137),
              goldens.CASES['ERA5T']['time'], BBOX, None),
    'ERAI': ('ERAI', lambda p: goldens._write_ecmwf_raw(p, 60), goldens.CASES['ERAI']['time'],
             BBOX, None),
    'HRES': ('HRES', lambda p: goldens._write_ecmwf_raw(p, 137), goldens.CASES['HRES']['time'],
             BBOX, None),
    'HRES_91': ('HRES', lambda p: goldens._write_ecmwf_raw(p, 91), dt.datetime(2012, 1, 30, 12),
                BBOX, None),
    'GMAO': ('GMAO', lambda p: goldens._write_hqpt_raw(p, True), dt.datetime(2020, 1, 30, 12),
             BBOX, None),
    'MERRA2': ('MERRA2', lambda p: goldens._write_hqpt_raw(p, True),
               goldens.CASES['MERRA2']['time'], BBOX, None),
    'NCMR': ('NCMR', lambda p: goldens._write_hqpt_raw(p, False), goldens.CASES['NCMR']['time'],
             BBOX, None),
    'WRF': ('WRF', goldens._write_wrfout_raw, goldens.CASES['WRF']['time'], BBOX, None),
    'HRRR': ('HRRR', _write_hrrr_raw, dt.datetime(2020, 1, 30, 14), HRRR_BBOX, None),
    'HRRRAK': ('HRRRAK', lambda p: _write_hrrr_raw(p, ak=True), dt.datetime(2020, 1, 30, 15),
               AK_BBOX, None),
    # the classic netCDF-3 files chip_smoke.py phase 8 writes (scripts/raw_weather.py)
    'ERA5_netcdf3': ('ERA5', lambda p: raw_weather.write_ecmwf(p, 'ERA5', box=(32, 35, -119, -116),
                                                             device='cpu'),
                     dt.datetime(2020, 1, 30, 14), BBOX, None),
    'WRF_netcdf3': ('WRF', lambda p: raw_weather.write_wrfout(
        p, nz=12, grid=('wrf', 40, 40, 5550.0, 33.5, -117.5), device='cpu'),
        dt.datetime(2020, 1, 30, 12), BBOX, None),
}


def _load(get, case, tmp, device=None):
    name, writer, time, bbox, level = case
    _, Model = get(name)
    m = Model()
    if level:
        m.setLevelType(level)
    m.setTime(time)
    m.set_latlon_bounds(bbox)
    m.set_wmLoc(str(tmp))
    raw = make_raw_weather_data_filename(str(tmp), m.Model(), m.getTime())
    if not (tmp / 'raw.nc').exists():
        writer(tmp / 'raw.nc')
    shutil.copy(tmp / 'raw.nc', raw)
    if device is None:
        assert m.load() is None
    else:
        assert m.load(device=device) is None
    return m


@pytest.fixture(scope='module', params=sorted(CASES))
def loaded(request, tmp_path_factory):
    tmp = tmp_path_factory.mktemp(request.param)
    case = CASES[request.param]
    return request.param, _load(j_get, case, tmp), _load(t_get, case, tmp, 'cpu')


def test_fields_match_jax(loaded):
    name, j, t = loaded
    rtol = 2e-5 if name == 'WRF_netcdf3' else 1e-6
    for attr in ('_wet_refractivity', '_hydrostatic_refractivity'):
        ref = np.asarray(getattr(j, attr), dtype=np.float64)
        out = getattr(t, attr)
        assert isinstance(out, torch.Tensor) and out.device.type == 'cpu'
        assert out.shape == ref.shape, (name, attr)
        np.testing.assert_allclose(out.double().numpy(), ref, rtol=rtol, err_msg=f'{name} {attr}')
    for attr in ('_wet_ztd', '_hydrostatic_ztd'):
        ref = np.asarray(getattr(j, attr), dtype=np.float64)
        np.testing.assert_allclose(getattr(t, attr).double().numpy(), ref, rtol=max(rtol, 1e-5),
                                   atol=1e-9, err_msg=f'{name} {attr}')


def test_axes_and_crs_match_jax(loaded):
    name, j, t = loaded
    for attr in ('_zs', '_xs', '_ys', '_lats', '_lons'):
        # the float32 wrfout's ladder is a float32 nanmean: an ulp apart
        rtol = 2.4e-7 if (name, attr) == ('WRF_netcdf3', '_zs') else 1e-12
        np.testing.assert_allclose(np.asarray(getattr(t, attr)), np.asarray(getattr(j, attr)),
                                   rtol=rtol, atol=1e-9, err_msg=f'{name} {attr}')
    assert t.getProjection().to_cf() == j.getProjection().to_cf()
    assert t.Model() == j.Model()
    ds = t.to_dataset()
    assert ds['proj'].attrs['grid_mapping_name'] == j.getProjection().to_cf()['grid_mapping_name']
    for k in ('wet', 'hydro', 'wet_total', 'hydro_total'):
        assert tuple(ds[k].dims) == ('z', 'y', 'x')
        assert torch.isfinite(ds[k].data).all()


@pytest.mark.parametrize('name', sorted(DIGEST))
def test_port_reaches_the_pinned_digests(name, tmp_path):
    """tests/test_model_goldens.py tier (c), through the port alone."""
    case = goldens.CASES[name]
    writer = {'ecmwf': lambda p: goldens._write_ecmwf_raw(p, case.get('nz')),
              'wrfout': goldens._write_wrfout_raw,
              'hqpt': lambda p: goldens._write_hqpt_raw(p, case.get('z_top_first'))}[case['kind']]
    m = _load(t_get, (name, writer, case['time'], BBOX, None), tmp_path, 'cpu')
    zl = np.asarray(m._zs, dtype=np.float64)
    i0 = int(np.searchsorted(zl, 0.0))
    hydro = float(m._hydrostatic_ztd[0, 0, i0])
    wet = float(m._wet_ztd[0, 0, i0])
    assert abs(hydro - DIGEST[name][0]) < 1e-5, (name, hydro)
    assert abs(wet - DIGEST[name][1]) < 1e-5, (name, wet)


def test_registry_names_and_metadata():
    """Every class of the JAX readers has a counterpart under the same names
    (tests/test_models.py), with the same metadata."""
    for alias in ('ERA-5', 'era5', 'Era-5'):
        assert t_get(alias)[1]().Model() == 'ERA-5'
    with pytest.raises(ModuleNotFoundError):
        t_get('NOTAMODEL')
    for name in ALLOWED_MODELS:
        jm, tm = j_get(name)[1](), t_get(name)[1]()
        assert type(tm).__name__ == type(jm).__name__
        assert t_get(name)[0] == j_get(name)[0].replace('raider_tpu.', 'raider_tpu_torch.')
        for attr in ('_k1', '_k2', '_k3', '_humidityType', '_lat_res', '_lon_res', '_time_res',
                     '_Name', '_dataset', '_model_level_type', '_lag_time'):
            assert getattr(tm, attr, None) == getattr(jm, attr, None), (name, attr)
        assert tm._valid_range[0] == jm._valid_range[0]
        assert tm.getProjection().to_cf() == jm.getProjection().to_cf()
        np.testing.assert_array_equal(np.asarray(tm._zlevels if tm._zlevels is not None else []),
                                      np.asarray(jm._zlevels if jm._zlevels is not None else []))
    from raider_tpu.wx import template as j_template
    from raider_tpu_torch.wx import template as t_template

    assert t_template.customModelReader()._Name == j_template.customModelReader()._Name


def test_time_checks_use_fixed_dates():
    from raider_tpu_torch.wx.exceptions import DatetimeOutsideRange

    m = t_get('ERA5')[1]()
    m.checkTime(dt.datetime(2020, 1, 1))
    with pytest.raises(DatetimeOutsideRange):
        m.checkTime(dt.datetime(1940, 1, 1))
    erai = t_get('ERAI')[1]()
    with pytest.raises(DatetimeOutsideRange):
        erai.checkTime(dt.datetime(2019, 9, 2))
    with pytest.raises(RuntimeError):
        erai.setLevelType('pl')


@pytest.mark.parametrize('bounds,cast', [((36.0, 37.0, -92.0, -91.0), 'HRRR'),
                                         ((64.0, 66.0, -150.0, -148.0), 'HRRR-AK'),
                                         ((0.0, 2.0, -150.0, -148.0), None)])
def test_hrrr_coverage_and_cast(bounds, cast):
    """HRRR.checkValidBounds casts the model to HRRR-AK in place for an
    Alaska box, as the JAX package does."""
    from raider_tpu_torch.wx.hrrr import HRRR_AK_PROJ, HRRRAK

    results = []
    for get in (j_get, t_get):
        m = get('HRRR')[1]()
        try:
            m.checkValidBounds(np.array(bounds))
        except ValueError:
            results.append(None)
            continue
        results.append(m.Model())
    assert results == [cast, cast]
    if cast == 'HRRR-AK':
        m = t_get('HRRR')[1]()
        m.checkValidBounds(np.array(bounds))
        assert isinstance(m, HRRRAK) and m.getProjection() == HRRR_AK_PROJ


def test_era5_cds_request(tmp_path, monkeypatch):
    """The ERA5 fetcher's CDS request (tests/test_fetchers.py), mocked."""
    calls = []

    class Client:
        url = 'https://cds.climate.copernicus.eu/api'

        def __init__(self, verify=0):
            pass

        def retrieve(self, name, req, target):
            calls.append((name, req, target))

    monkeypatch.setitem(sys.modules, 'cdsapi', _module('cdsapi', Client=Client))
    m = t_get('ERA5')[1]()
    m.set_latlon_bounds(np.array([33.0, 34.5, -118.0, -116.5]))
    out = tmp_path / 'era5_raw.nc'
    m.fetch(str(out), dt.datetime(2020, 1, 30, 14, 11, 0))
    name, req, target = calls[0]
    assert name == 'reanalysis-era5-complete'
    assert req['param'] == '129/130/133/152'
    assert req['levtype'] == 'ml' and req['levelist'] == 'all'
    lat_min, lat_max, lon_min, lon_max = m._ll_bounds
    assert req['area'] == [lat_max, lon_min, lat_min, lon_max]
    assert req['date'] == '2020-01-30' and req['time'] == '14:00'
    assert target == str(out)


def test_hrrr_herbie_roundtrip(tmp_path, monkeypatch):
    """The port's download_hrrr_file with a fake Herbie writes a raw file
    its load_weather_hrrr reads back; the JAX package reads it the same."""
    from raider_tpu.wx import hrrr as j_hrrr
    from raider_tpu_torch.wx import hrrr as t_hrrr

    j_path = tmp_path / 'j.nc'
    _write_hrrr_raw(j_path, n=21, nz=5)
    jd = j_hrrr.load_weather_hrrr(str(j_path))
    seen = {}
    lon2 = np.asarray(jd[2])

    class Herbie:
        def __init__(self, date, model=None, product=None, fxx=0, overwrite=False,
                     verbose=False, save_dir=None):
            seen.update(date=date, model=model, product=product)

        def xarray(self, regex, verbose=False):
            seen['regex'] = regex
            shp = jd[5].shape[::-1]
            tr = (2, 0, 1)
            return [_FakeXrDataset(
                {'gh': _FakeXrVar(np.asarray(jd[7]).transpose(tr), ('hybrid', 'y', 'x')),
                 't': _FakeXrVar(np.asarray(jd[5]).transpose(tr), ('hybrid', 'y', 'x')),
                 'q': _FakeXrVar(np.asarray(jd[4]).transpose(tr), ('hybrid', 'y', 'x')),
                 'pres': _FakeXrVar(np.asarray(jd[6]).transpose(tr), ('hybrid', 'y', 'x'))},
                {'hybrid': _FakeXrVar(np.arange(shp[0]), ('hybrid',)),
                 'latitude': _FakeXrVar(np.asarray(jd[3]), ('y', 'x')),
                 'longitude': _FakeXrVar(lon2 % 360.0, ('y', 'x'))})]

    monkeypatch.setitem(sys.modules, 'herbie', _module('herbie', Herbie=Herbie))
    out = tmp_path / 'hrrr_raw.nc'
    t_hrrr.download_hrrr_file(HRRR_BBOX, dt.datetime(2020, 1, 30, 14), str(out))
    assert seen['model'] == 'hrrr' and seen['product'] == 'nat'
    assert seen['regex'] == ':(SPFH|PRES|TMP|HGT):'
    xs, ys, lons, lats, qs, temps, pres, geo_hgt, proj = t_hrrr.load_weather_hrrr(str(out), 'cpu')
    ref = j_hrrr.load_weather_hrrr(str(out))
    assert proj == t_hrrr.HRRR_CONUS_PROJ
    assert proj.to_cf() == ref[8].to_cf()
    np.testing.assert_array_equal(xs, np.unique(ref[0]))
    np.testing.assert_array_equal(ys, np.unique(ref[1]))
    for a, b in zip((lons, lats, qs, temps, pres, geo_hgt), ref[2:8]):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))
    assert (lons <= 180.0).all() and bool((torch.diff(geo_hgt, dim=2) > 0).all())
