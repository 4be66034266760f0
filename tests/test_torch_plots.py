"""Weather-model plots: raider_tpu_torch.wx.plots vs raider_tpu.wx.plots (CPU).

The synthetic file-backed model of tests/test_torch_process.py, loaded by
each package (the port on the CPU): both write the same file names, and
what each axis shows agrees (every image's ``get_array()``, every line's
data) at the field tolerance of tests/test_torch_wx.py (rtol 1e-6). The
port's ``prepareWeatherModel(makePlots=True)`` plots a fresh model only.
"""

import matplotlib

matplotlib.use('Agg')

import matplotlib.pyplot as plt  # noqa: E402
import numpy as np  # noqa: E402
import pytest  # noqa: E402

from raider_tpu.wx import plots as j_plots  # noqa: E402
from raider_tpu_torch.wx import plots as t_plots  # noqa: E402

from tests.test_torch_process import BOUNDS, T, JaxModel, TorchModel, _model  # noqa: E402


@pytest.fixture(scope='module')
def models(tmp_path_factory):
    d = tmp_path_factory.mktemp('plots')
    j, t = _model(JaxModel, d / 'j'), _model(TorchModel, d / 't')
    for m in (j, t):
        m.set_latlon_bounds(np.array(BOUNDS))
        m.setTime(T)
    j.load()
    t.load(device='cpu')
    return j, t


def _shown(monkeypatch, fn, model):
    """Call a plot function; return its file name and, per axis, the
    arrays of its images and the data of its lines."""
    figs = []
    monkeypatch.setattr(plt, 'close', lambda fig=None: figs.append(fig))
    name = fn(model, savefig=True)
    assert len(figs) == 1
    axes = []
    for ax in figs[0].axes:
        axes.append(([np.ma.getdata(im.get_array()) for im in ax.get_images()],
                     [(np.asarray(ln.get_xdata(), float), np.asarray(ln.get_ydata(), float))
                      for ln in ax.get_lines()], ax.get_title()))
    matplotlib.pyplot.close('all')
    return name, axes


@pytest.mark.parametrize('which', ['plot_pqt', 'plot_wh'])
def test_plots_match_jax(models, tmp_path, monkeypatch, which):
    monkeypatch.chdir(tmp_path)
    j, t = models
    name_j, axes_j = _shown(monkeypatch, getattr(j_plots, which), j)
    name_t, axes_t = _shown(monkeypatch, getattr(t_plots, which), t)
    assert name_t == name_j and (tmp_path / name_t).stat().st_size > 0
    assert len(axes_t) == len(axes_j)
    for (ims_t, lines_t, title_t), (ims_j, lines_j, title_j) in zip(axes_t, axes_j):
        assert title_t == title_j and len(ims_t) == len(ims_j) and len(lines_t) == len(lines_j)
        for a, b in zip(ims_t, ims_j):
            np.testing.assert_allclose(a, b, rtol=1e-6, atol=1e-9)
        for (xa, ya), (xb, yb) in zip(lines_t, lines_j):
            np.testing.assert_allclose(xa, xb, rtol=1e-6, atol=1e-9)
            np.testing.assert_allclose(ya, yb, rtol=1e-6, atol=1e-9)


def test_slice_at_height_matches_jax():
    rng = np.random.default_rng(0)
    cube = rng.uniform(0.0, 1.0, (5, 6, 9))
    zs = np.sort(rng.uniform(-500.0, 20000.0, 9))
    for z in (-1000.0, zs[0], 500.0, 7777.0, zs[-1], 30000.0):
        np.testing.assert_array_equal(t_plots._slice_at_height(cube, zs, z),
                                      j_plots._slice_at_height(cube, zs, z))


def test_prepare_plots_a_fresh_model_only(tmp_path, monkeypatch):
    """makePlots: the two plots of a freshly processed model, none on the
    cache hit (as in the JAX package)."""
    from raider_tpu_torch.wx import process as t_process

    monkeypatch.chdir(tmp_path)
    t_process.prepareWeatherModel(_model(TorchModel, tmp_path / 'wm'), T, BOUNDS,
                                  makePlots=True, device='cpu')
    pdfs = sorted(p.name for p in tmp_path.glob('*.pdf'))
    assert pdfs == ['MOCK_weather_hgt500.0_and_15000.0m.pdf',
                    'MOCK_weather_model_refractivity.pdf']
    for p in tmp_path.glob('*.pdf'):
        p.unlink()
    t_process.prepareWeatherModel(_model(TorchModel, tmp_path / 'wm'), T, BOUNDS,
                                  makePlots=True, device='cpu')
    assert not list(tmp_path.glob('*.pdf'))
