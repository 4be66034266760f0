"""prepareWeatherModel: raider_tpu_torch.wx.process vs raider_tpu.wx.process (CPU).

The synthetic file-backed model of tests/test_process_wm.py, built on each
package's WeatherModel, with a counting ``_fetch``: fetch -> load -> write,
the cache hit, ExistingWeatherModelTooSmall and force_download. The files
the two packages write hold the same schema; their fields agree at the
tolerances of tests/test_torch_wx.py (rtol 1e-6 for t, p, e and the
refractivities, rtol 1e-5 with atol 1e-9 m for the ZTD totals).
"""

import datetime as dt
import os

import numpy as np
import pytest

from raider_tpu.io import read_nc
from raider_tpu.wx import base as j_base
from raider_tpu.wx import process as j_process
from raider_tpu_torch.wx import base as t_base
from raider_tpu_torch.wx import process as t_process
from raider_tpu_torch.wx.exceptions import ExistingWeatherModelTooSmall

T = dt.datetime(2020, 1, 30, 12, 0, 0)
BOUNDS = [33.0, 34.0, -118.0, -117.0]


def _init(self):
    type(self).__mro__[1].__init__(self)
    self._k1, self._k2, self._k3 = 0.776, 0.233, 3.75e3
    self._Name = 'MOCK'
    self._dataset = 'mock'
    self._lat_res = self._lon_res = 0.25
    self._valid_range = (dt.datetime(1970, 1, 1, tzinfo=dt.timezone.utc),
                         dt.datetime(2030, 1, 1, tzinfo=dt.timezone.utc))
    self._lag_time = dt.timedelta(days=1)
    self.fetch_count = 0


def _fetch(self, out):
    self.fetch_count += 1
    with open(out, 'wb') as f:
        f.write(b'raw marker')


def _load_weather(self, f=None, *args, **kwargs):
    """T = 280 - 0.0065 z, p barometric, q constant, on the bounds."""
    s, n, w, e = self._ll_bounds
    lats = np.arange(s, n + 1e-9, self._lat_res)
    lons = np.arange(w, e + 1e-9, self._lon_res)
    zcols = np.linspace(0.0, 25000.0, 30)
    ny, nx, nz = lats.size, lons.size, zcols.size
    self._lons, self._lats = np.meshgrid(lons, lats)
    self._zs = np.broadcast_to(zcols, (ny, nx, nz)).copy()
    self._t = np.broadcast_to(280.0 - 0.0065 * zcols, (ny, nx, nz)).copy()
    self._p = np.broadcast_to(101325.0 * np.exp(-zcols / 8000.0), (ny, nx, nz)).copy()
    self._q = np.full((ny, nx, nz), 0.005)
    self._xs = self._lons.copy()
    self._ys = self._lats.copy()
    self._zlevels = zcols


def _model_class(base):
    return type('FileBackedSyntheticModel', (base.WeatherModel,),
                {'__init__': _init, '_fetch': _fetch, 'load_weather': _load_weather})


JaxModel, TorchModel = _model_class(j_base), _model_class(t_base)


def _model(cls, tmp_path):
    m = cls()
    m.set_wmLoc(str(tmp_path))
    return m


def _prepare_torch(m, bounds=BOUNDS, **kwargs):
    return t_process.prepareWeatherModel(m, T, bounds, device='cpu', **kwargs)


def test_prepare_fetch_load_write_matches_jax(tmp_path):
    j = _model(JaxModel, tmp_path / 'jax')
    t = _model(TorchModel, tmp_path / 'torch')
    ref = j_process.prepareWeatherModel(j, T, BOUNDS)
    out = _prepare_torch(t)
    assert t.fetch_count == j.fetch_count == 1
    assert os.path.basename(out) == os.path.basename(ref)
    a, b = read_nc(out), read_nc(ref)
    assert set(a.variables) == set(b.variables) and set(a.coords) == set(b.coords)
    assert {k: v for k, v in a.attrs.items() if k != 'date_created'} == \
        {k: v for k, v in b.attrs.items() if k != 'date_created'}
    for name in ('x', 'y', 'z', 'latitude', 'longitude'):
        np.testing.assert_allclose(a[name].data, b[name].data, rtol=1e-12)
    for name in ('t', 'p', 'e', 'wet', 'hydro'):
        assert tuple(a[name].dims) == tuple(b[name].dims) == ('z', 'y', 'x')
        np.testing.assert_allclose(a[name].data, b[name].data, rtol=1e-6)
    for name in ('wet_total', 'hydro_total'):
        np.testing.assert_allclose(a[name].data, b[name].data, rtol=1e-5, atol=1e-9)
    assert a['proj'].attrs == b['proj'].attrs

    # the cache hit: a second model fetches nothing and returns the same file
    t2 = _model(TorchModel, tmp_path / 'torch')
    assert _prepare_torch(t2) == out and t2.fetch_count == 0
    assert t2.checkContainment(BOUNDS)
    assert t2.bbox == pytest.approx(j.bbox, abs=1e-12)


def test_containment_failure(tmp_path):
    """Bounds larger than the model raise after processing, as in JAX."""
    for cls, prep in ((JaxModel, j_process.prepareWeatherModel),
                      (TorchModel, lambda *a: t_process.prepareWeatherModel(*a, device='cpu'))):
        m = _model(cls, tmp_path / cls.__module__)
        m.set_latlon_bounds(np.array(BOUNDS))
        with pytest.raises(Exception) as exc:
            prep(m, T, [20.0, 50.0, -130.0, -100.0])
        assert type(exc.value).__name__ == 'ExistingWeatherModelTooSmall'
    with pytest.raises(ExistingWeatherModelTooSmall):
        m = _model(TorchModel, tmp_path / 'again')
        m.set_latlon_bounds(np.array(BOUNDS))
        _prepare_torch(m, [20.0, 50.0, -130.0, -100.0])


def test_force_download_reprocesses(tmp_path):
    out = _prepare_torch(_model(TorchModel, tmp_path))
    os.utime(out, (0, 0))
    t2 = _model(TorchModel, tmp_path)
    assert _prepare_torch(t2, force_download=True) == out
    assert t2.fetch_count == 1 and os.path.getmtime(out) > 0
    assert 'wet_total' in read_nc(out)


def test_download_only_and_plots(tmp_path, monkeypatch):
    """download_only fetches and stops; makePlots writes the JAX package's
    two plots of the fresh model (wx/plots.py, ported)."""
    t = _model(TorchModel, tmp_path)
    assert _prepare_torch(t, download_only=True) is None and t.fetch_count == 1
    monkeypatch.chdir(tmp_path)
    _prepare_torch(_model(TorchModel, tmp_path), makePlots=True)
    assert sorted(p.name for p in tmp_path.glob('*.pdf')) == [
        'MOCK_weather_hgt500.0_and_15000.0m.pdf', 'MOCK_weather_model_refractivity.pdf']


def test_engine_on_the_written_file(tmp_path):
    """The port's tropo_delay reads the file the port wrote: zenith delays
    equal a trapezoid of the file's own refractivity profile."""
    from raider_tpu_torch.delay import tropo_delay
    from raider_tpu_torch.geometry import BoundingBox, Zenith

    wm_file = _prepare_torch(_model(TorchModel, tmp_path))
    aoi = BoundingBox([33.2, 33.8, -117.9, -117.2], cube_spacing_in_m=5000.0)
    ds, _ = tropo_delay(T, wm_file, aoi, Zenith(), height_levels=[0.0], device='cpu')
    total = np.asarray(ds['wet'].data[0]) + np.asarray(ds['hydro'].data[0])
    wm = read_nc(wm_file)
    zs = np.asarray(wm.coords['z'].data)
    i0 = int(np.searchsorted(zs, 0.0))
    expected = 1e-6 * sum(np.trapezoid(np.asarray(wm[k].data)[i0:, 0, 0], zs[i0:])
                          for k in ('wet', 'hydro'))
    np.testing.assert_allclose(np.nanmean(total), expected, rtol=1e-6)


def test_raw_containment_matches_jax(tmp_path):
    """checkContainment_raw on a classic netCDF-3 raw file (and a corrupt
    one), in both packages."""
    from scipy.io import netcdf_file

    path = tmp_path / 'raw.nc'
    with netcdf_file(str(path), 'w') as f:
        f.createDimension('latitude', 5)
        f.createDimension('longitude', 6)
        f.createVariable('latitude', 'f8', ('latitude',))[:] = np.linspace(32.0, 35.0, 5)
        f.createVariable('longitude', 'f8', ('longitude',))[:] = np.linspace(240.0, 245.0, 6)
    (tmp_path / 'bad.nc').write_bytes(b'not a file')
    for bounds in ([33.0, 34.0, -119.0, -116.0], [31.0, 34.0, -119.0, -116.0],
                   [33.0, 34.0, 241.0, 244.0]):
        for p in (path, tmp_path / 'bad.nc'):
            assert t_process.checkContainment_raw(str(p), bounds) == \
                j_process.checkContainment_raw(str(p), bounds)
    assert t_process.checkContainment_raw(str(path), [33.0, 34.0, -119.0, -116.0])
