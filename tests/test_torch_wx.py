"""WeatherModel pipeline: raider_tpu_torch.wx vs raider_tpu.wx (CPU).

Both classes load the same seeded synthetic model (terrain-following native
levels, NaN-free fields) and run their whole pipeline. Tolerances:

  * find_svp: float32 result, 1 ulp (rtol 2e-7);
  * fillna3d vs the pandas version: rtol 1e-6 in float32 (np.interp runs
    in float64 in both; the stored value rounds once);
  * t, p, e after _uniform_in_z and the fills, and both refractivities:
    rtol 1e-6 (float32 interpolation of float64 inputs);
  * ZTD totals: rtol 1e-5, atol 1e-9 m. The port (like the TPU path) runs
    the float32 top-down scan; the JAX package on the CPU integrates in
    float64.
"""

import datetime as dt

import numpy as np
import pytest
import torch

from raider_tpu.wx import base as j_base
from raider_tpu_torch.wx import base as t_base

T0 = dt.datetime(2020, 1, 30, 13, 52, 45)


def _load_synthetic(self, *args, **kwargs):
    rng = np.random.default_rng(11)
    ny, nx, nlev = 6, 7, 14
    self._ys = np.linspace(33.0, 34.25, ny)
    self._xs = np.linspace(-118.5, -117.0, nx)
    self._lons, self._lats = np.meshgrid(self._xs, self._ys)
    terrain = rng.uniform(0.0, 1500.0, (ny, nx))
    sigma = np.linspace(0.0, 1.0, nlev) ** 1.5
    h = terrain[..., None] + (26000.0 - terrain[..., None]) * sigma
    self._zs = h
    self._t = 288.15 - 0.0065 * np.minimum(h, 11000.0) + rng.normal(0.0, 0.5, h.shape)
    self._p = 101325.0 * np.exp(-h / 8000.0)
    self._q = 0.015 * np.exp(-h / 2000.0) * rng.uniform(0.7, 1.1, h.shape)


def _setup(m, tmp_path):
    m._k1, m._k2, m._k3 = 0.776, 0.233, 3.75e3
    m._Name = 'SYNTH'
    m.setTime(T0)
    m.set_wmLoc(str(tmp_path))
    m._ll_bounds = np.array([33.2, 34.0, -118.2, -117.3])   # trims the grid


class JaxModel(j_base.WeatherModel):
    load_weather = _load_synthetic


class TorchModel(t_base.WeatherModel):
    load_weather = _load_synthetic


@pytest.fixture(scope='module')
def models(tmp_path_factory):
    tmp = tmp_path_factory.mktemp('wx')
    j, t = JaxModel(), TorchModel()
    _setup(j, tmp)
    _setup(t, tmp)
    j.load()
    t.load(device='cpu')
    return j, t


def test_find_svp_matches_jax():
    temps = np.linspace(200.0, 320.0, 241)
    ref = np.asarray(j_base.find_svp(temps))
    out = t_base.find_svp(torch.as_tensor(temps)).numpy()
    assert out.dtype == np.float32
    np.testing.assert_allclose(out, ref, rtol=2e-7)


def _nan_pattern(kind, rng, dtype):
    a = rng.uniform(1.0, 100.0, (3, 4, 9)).astype(dtype)
    if kind in ('leading', 'mixed'):
        a[0, :, :3] = np.nan
    if kind in ('interior', 'mixed'):
        a[1, 1, 2:5] = np.nan
        a[2, 3, [3, 6]] = np.nan
    if kind in ('trailing', 'mixed'):
        a[2, :, -2:] = np.nan
    if kind == 'all_nan':
        a[1, 2, :] = np.nan
    if kind == 'single_valid':
        a[0, 0, :] = np.nan
        a[0, 0, 4] = 7.0
    return a


@pytest.mark.parametrize('kind', ['leading', 'interior', 'trailing', 'mixed', 'all_nan',
                                  'single_valid'])
@pytest.mark.parametrize('dtype', [np.float32, np.float64])
def test_fillna3d_matches_pandas(kind, dtype):
    a = _nan_pattern(kind, np.random.default_rng(2), dtype)
    for axis, fill in ((-1, 0.0), (1, 1e16)):
        ref = j_base.fillna3d(a.copy(), axis=axis, fill_value=fill)
        out = t_base.fillna3d(torch.as_tensor(a), axis=axis, fill_value=fill).numpy()
        assert out.dtype == a.dtype and not np.isnan(out).any()
        np.testing.assert_allclose(out, ref, rtol=1e-6 if dtype == np.float32 else 1e-12)


@pytest.mark.parametrize('name', ['_t', '_p', '_e', '_wet_refractivity',
                                  '_hydrostatic_refractivity'])
def test_pipeline_fields_match_jax(models, name):
    j, t = models
    ref = np.asarray(getattr(j, name), dtype=np.float64)
    out = getattr(t, name).double().numpy()
    assert out.shape == ref.shape
    np.testing.assert_allclose(out, ref, rtol=1e-6)


def test_pipeline_grid_matches_jax(models):
    j, t = models
    for name in ('_zs', '_xs', '_ys', '_lats', '_lons'):
        np.testing.assert_allclose(np.asarray(getattr(t, name)), np.asarray(getattr(j, name)),
                                   rtol=1e-12)
    assert np.asarray(t._zs)[0] == t._zmin      # the padded zmin layer


@pytest.mark.parametrize('name', ['_wet_ztd', '_hydrostatic_ztd'])
def test_ztd_totals_match_jax(models, name):
    j, t = models
    ref = np.asarray(getattr(j, name), dtype=np.float64)
    out = getattr(t, name).double().numpy()
    np.testing.assert_allclose(out, ref, rtol=1e-5, atol=1e-9)
    assert np.all(out[..., -1] == 0)


def test_get_ztd_reads_the_fields_in_place(models, monkeypatch):
    """After load (the grid trimmed), t, p and e are contiguous (y, x, z)
    float32 cubes, and _get_ztd hands their (z, y, x) views to ztd_totals:
    no transposing copy."""
    _, t = models
    fields = (t._t, t._p, t._e)
    assert all(a.is_contiguous() and a.dtype == torch.float32 for a in fields)
    seen, ztd_totals = [], t_base.ztd_totals

    def spy(*args, **kwargs):
        seen.extend(args[:3])
        return ztd_totals(*args, **kwargs)

    monkeypatch.setattr(t_base, 'ztd_totals', spy)
    wet, hyd = t._wet_ztd, t._hydrostatic_ztd
    t._get_ztd()
    assert [a.data_ptr() for a in seen] == [a.data_ptr() for a in fields]
    assert all(a.shape == torch.movedim(f, -1, 0).shape for a, f in zip(seen, fields))
    assert torch.equal(t._wet_ztd, wet) and torch.equal(t._hydrostatic_ztd, hyd)


@pytest.mark.parametrize('name', ['_t', '_p', '_e', '_wet_refractivity',
                                  '_hydrostatic_refractivity'])
def test_trim_copies_only_what_b1_reads(models, name):
    """The fixture's bounds crop x (7 -> 6 columns): _trimExtent copies t, p
    and e into contiguous (y, x, z) cubes, which B1 reads in place, and
    leaves both refractivities as views of the whole grid; the values are
    the JAX package's."""
    j, t = models
    a = getattr(t, name)
    assert a.shape[1] == 6 and a.shape == np.shape(getattr(j, name))
    assert a.is_contiguous() == (name in ('_t', '_p', '_e'))
    np.testing.assert_allclose(a.numpy(), np.asarray(getattr(j, name)), rtol=1e-6)


def test_to_dataset_schema_matches_write(models, tmp_path):
    """to_dataset holds what the JAX write() stores, under the same names."""
    from raider_tpu.io import read_nc

    j, t = models
    j._out_name = str(tmp_path / 'ref.nc')
    j.write()
    ref = read_nc(j._out_name)
    ds = t.to_dataset()
    assert set(ds.variables) == set(ref.variables)
    assert set(ds.coords) == set(ref.coords)
    for name in ('wet', 'hydro', 'wet_total', 'hydro_total'):
        assert tuple(ds[name].dims) == tuple(ref[name].dims)
        np.testing.assert_allclose(ds[name].data.double().numpy(), ref[name].data,
                                   rtol=1e-5, atol=1e-9)
