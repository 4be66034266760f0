"""raiderStats in the port (``raider_tpu_torch.workflows.stats``) against the
JAX package, on the CPU.

Both packages read the same seeded CSVs (``scripts/stats_inputs.py``: short
numbers, which pandas and the port parse alike); the port runs with pandas
blocked. Tolerances (those the card is held to against the CPU path):
grids within rtol 1e-12 with the same NaN cells, counts and medians equal,
seasonal coefficients within rtol 1e-9, variogram gamma within rtol 1e-12,
sill and range within rtol 1e-6. Sums are numpy's ``bincount`` sums made in
the same order, so most come out bit for bit; pandas' group means and
standard deviations (Kahan sums, Welford) differ from the port's in the
last bits, and so do variogram distances (the port's sqrt(dx^2 + dy^2)
rounds alike on every device, numpy's ``hypot`` is another function).
"""

import contextlib
import datetime as dt
import logging
import os
import sys

import numpy as np
import pandas as pd
import pytest
import torch

from raider_tpu.workflows import stats as J
from raider_tpu_torch.scripts.stats_inputs import write_combined_csv
from raider_tpu_torch.utils import table
from raider_tpu_torch.workflows import stats as T

RTOL_GRID = 1e-12
RTOL_FIT = 1e-9
RTOL_SILL = 1e-6


@contextlib.contextmanager
def blocked(*modules):
    """Imports of ``modules`` raise inside the block."""
    saved = {m: sys.modules.get(m) for m in modules}
    for m in modules:
        sys.modules[m] = None
    try:
        yield
    finally:
        for m, mod in saved.items():
            if mod is None:
                sys.modules.pop(m, None)
            else:
                sys.modules[m] = mod


def port_stats(csv, **kw):
    with blocked('pandas'):
        return T.RaiderStats(str(csv), device='cpu', **kw)


def same_grid(a, b, rtol=RTOL_GRID):
    a = a.cpu().numpy() if isinstance(a, torch.Tensor) else np.asarray(a)
    b = np.asarray(b)
    assert a.shape == b.shape
    np.testing.assert_array_equal(np.isnan(a), np.isnan(b))
    np.testing.assert_allclose(a, b, rtol=rtol, atol=0, equal_nan=True)


@pytest.fixture(scope='module')
def combined(tmp_path_factory):
    """12 stations with 800 daily epochs (2 of them short) over [33, 37] N x
    [-120, -115] E."""
    path = tmp_path_factory.mktemp('stats') / 'combined.csv'
    truth = write_combined_csv(path, n_stations=12, n_days=800, n_short=2,
                               box=(33.0, 37.0, -120.0, -115.0), seed=7)
    return path, truth


@pytest.fixture(scope='module')
def edge_csv(tmp_path_factory):
    """NaN rows, a one-observation station, even counts, points on the grid's
    top and east edges, an observation without a time."""
    path = tmp_path_factory.mktemp('edge') / 'edge.csv'
    rows = ['ID,Lat,Lon,Hgt_m,Datetime,ZTD,sigZTD']
    t0 = dt.datetime(2020, 1, 1, 12)
    rng = np.random.default_rng(11)

    def add(sid, lat, lon, k, ztd, sig=0.004):
        when = (t0 + dt.timedelta(days=k)).strftime('%Y-%m-%d %H:%M:%S') if k is not None else ''
        rows.append(f'{sid},{lat},{lon},100.0,{when},{ztd},{sig}')
    for k in range(4):                      # AAAA: 4 rows, one ZTD missing: median of 3
        add('AAAA', 33.2, -118.8, k, '' if k == 1 else round(2.3 + 0.01 * k, 6))
    for k in range(6):                      # BBBB: an even count, first Lat missing
        add('BBBB', '' if k == 0 else 33.7, -118.2, k, round(2.31 + 0.003 * k * k, 6))
    add('CCCC', 34.5, -117.5, 2, 2.35)      # one observation
    for k in range(5):                      # DDDD: on the top edge (35 N) and east edge
        add('DDDD', 35.0, -117.0, k, round(2.29 + rng.normal(0, 0.01), 6))
    add('DDDD', 35.0, -117.0, None, 2.4)    # no time
    for k in range(30):                     # EEEE: many rows, a few NaN positions
        add('EEEE', '' if k % 11 == 3 else 34.2, -118.4, k, round(2.32 + rng.normal(0, 0.01), 6))
    path.write_text('\n'.join(rows) + '\n')
    return path


def test_grid_statistic_mean():
    lat_e, lon_e = T.make_grid([0, 2, 0, 2], 1.0)
    lats = torch.tensor([0.5, 0.6, 1.5], dtype=torch.float64)
    lons = torch.tensor([0.5, 0.4, 1.5], dtype=torch.float64)
    vals = torch.tensor([1.0, 3.0, 10.0], dtype=torch.float64)
    g = T.grid_statistic(lats, lons, vals, lat_e, lon_e, 'mean')
    assert g.shape == (2, 2) and float(g[0, 0]) == 2.0 and float(g[1, 1]) == 10.0
    assert torch.isnan(g[0, 1])
    c = T.grid_statistic(lats, lons, vals, lat_e, lon_e, 'count')
    assert c[0, 0] == 2 and c[1, 1] == 1
    with pytest.raises(ValueError):
        T.grid_statistic(lats, lons, vals, lat_e, lon_e, 'mode')


@pytest.mark.parametrize('statistic', ['count', 'mean', 'stdev', 'median'])
def test_grid_statistic_matches_jax(statistic):
    """NaN rows, even counts (median of the two middle values), points on
    and past the top edges (the last cell), empty cells."""
    rng = np.random.default_rng(3)
    n = 4000
    lats = rng.uniform(30.0, 34.0, n)
    lons = rng.uniform(-120.0, -116.0, n)
    lats[:40] = 34.0                       # the top edge
    lons[40:60] = -116.0                   # the east edge
    lons[60:70] = -115.5                   # past it
    vals = rng.normal(2.3, 0.05, n)
    vals[::97] = np.nan
    lats[5::301] = np.nan
    lat_e, lon_e = T.make_grid([30.0, 34.0, -120.0, -116.0], 0.5)
    got = T.grid_statistic(torch.as_tensor(lats), torch.as_tensor(lons), torch.as_tensor(vals),
                           lat_e, lon_e, statistic)
    want = J.grid_statistic(lats, lons, vals, lat_e, lon_e, statistic)
    same_grid(got, want)
    if statistic in ('count', 'median', 'mean'):
        np.testing.assert_array_equal(got.numpy(), want)


def test_seasonal_fit_recovers_amplitude():
    t = np.arange(0, 3 * 365, 3) * 86400.0
    truth_amp, truth_phase = 0.04, 0.7
    v = 2.3 + truth_amp * np.sin(2 * np.pi * t / (365.25 * 86400.0) + truth_phase)
    fit = T.seasonal_fit(torch.as_tensor(t), torch.as_tensor(v), torch.zeros(t.size, dtype=int), 1)
    np.testing.assert_allclose(float(fit['amplitude'][0, 0]), truth_amp, rtol=1e-3)
    np.testing.assert_allclose(float(fit['mean'][0]), 2.3, atol=1e-3)
    np.testing.assert_allclose(float(fit['phase'][0, 0]), truth_phase, atol=1e-3)


def test_seasonal_fit_matches_jax():
    rng = np.random.default_rng(4)
    n_st = 9
    st = rng.integers(0, n_st, 3000)
    st[st == 8] = 7                                  # station 8 has no rows
    st[:3] = 6
    st[st == 6] = 5
    st[0] = 6                                        # station 6: one row (NaN fit)
    t = 1.6e9 + rng.uniform(0, 3 * 3.15e7, st.size)
    v = 2.3 + 0.03 * np.sin(2 * np.pi * t / 3.15e7 + st) + rng.normal(0, 0.01, st.size)
    got = T.seasonal_fit(torch.as_tensor(t), torch.as_tensor(v), torch.as_tensor(st), n_st)
    want = J.seasonal_fit(t, v, st, n_st)
    assert got['t_ref'] == want['t_ref']
    np.testing.assert_array_equal(got['count'].numpy(), want['count'])
    for k in ('mean', 'trend', 'amplitude', 'phase'):
        same_grid(got[k], want[k], RTOL_FIT)


def test_variogram_recovers_sill_and_draws_jax_pairs():
    rng = np.random.default_rng(1)
    n = 800
    x, y, v = rng.uniform(0, 10, n), rng.uniform(0, 10, n), rng.normal(0, 1.0, n)
    centers, gamma, counts, meta = T.empirical_variogram(*(torch.as_tensor(a) for a in (x, y, v)),
                                                         n_bins=12)
    assert np.nanmean(gamma.numpy()[2:]) == pytest.approx(1.0, rel=0.15)
    sill, _ = T.fit_variogram(centers, gamma, 'exponential')
    assert sill == pytest.approx(1.0, rel=0.3)
    assert meta['estimator'] == 'subsampled' and meta['n_pairs_total'] == n * (n - 1) // 2
    jc, jg, jn, jmeta = J.empirical_variogram(x, y, v, n_bins=12)
    assert meta == jmeta
    np.testing.assert_array_equal(counts.numpy(), jn)
    same_grid(centers, jc)
    same_grid(gamma, jg)
    assert T.empirical_variogram(x[:9], y[:9], v[:9], device='cpu') == (None,) * 4


def test_variogram_all_pairs_matches_jax():
    rng = np.random.default_rng(7)
    n = 60
    x, y = rng.uniform(0, 5, n), rng.uniform(0, 5, n)
    v = rng.normal(0, 0.3, n) + 0.1 * x
    v[[3, 17]] = np.nan                    # the finite filter
    got = T.empirical_variogram(x, y, v, n_bins=8, device='cpu')
    want = J.empirical_variogram(x, y, v, n_bins=8)
    assert got[3] == want[3] and got[3]['estimator'] == 'all_pairs'
    np.testing.assert_array_equal(got[2].numpy(), want[2])
    same_grid(got[0], want[0])
    same_grid(got[1], want[1])
    fixed = T.empirical_variogram(x, y, v, n_bins=8, max_dist=2.0, device='cpu')
    same_grid(fixed[1], J.empirical_variogram(x, y, v, n_bins=8, max_dist=2.0)[1])


def test_station_means_and_grids_match_jax(edge_csv):
    """'first' skips NaN, mean/median skip NaN, std ddof 1 (NaN for one
    observation), count excludes NaN, sorted IDs; every grid."""
    st = port_stats(edge_csv, workdir=str(edge_csv.parent), bbox=[33.0, 35.0, -119.0, -117.0])
    js = J.RaiderStats(str(edge_csv), workdir=str(edge_csv.parent),
                       bbox=[33.0, 35.0, -119.0, -117.0])
    sm, jm = st.station_means(), js.station_means()
    assert list(sm['ID']) == list(jm['ID'])
    for k in ('Lat', 'Lon', 'median', 'count'):
        np.testing.assert_array_equal(sm[k].numpy(), jm[k].to_numpy())
    for k in ('mean', 'std'):
        same_grid(sm[k], jm[k].to_numpy())
    assert np.isnan(sm['std'][list(sm['ID']).index('CCCC')].item())
    for absolute in (False, True):
        for stat in ('count', 'mean', 'median', 'stdev'):
            same_grid(st.grid_map(stat, absolute), js.grid_map(stat, absolute))
            same_grid(st.grid_map_masked(stat, absolute), js.grid_map_masked(stat, absolute))
    np.testing.assert_array_equal(st._seasonal_station_mask().numpy(),
                                  js._seasonal_station_mask().to_numpy())


def test_end_to_end(combined, tmp_path):
    csv, truth = combined
    st = port_stats(csv, workdir=str(tmp_path), spacing=1.0)
    js = J.RaiderStats(str(csv), workdir=str(tmp_path), spacing=1.0)
    sm = st.station_means()
    assert len(sm['ID']) == 12
    np.testing.assert_allclose(float(sm['mean'].mean()), 2.3, atol=0.01)
    same_grid(st.grid_map('mean'), js.grid_map('mean'))
    fits = T.host_table(st.seasonal_amplitude_phase())
    jf = js.seasonal_amplitude_phase()
    assert list(fits) == list(jf.columns)
    for k in fits:
        if k == 'ID':
            assert list(fits[k]) == list(jf[k])
        else:
            same_grid(fits[k], jf[k].to_numpy(), RTOL_FIT)
    np.testing.assert_allclose(fits['annual_amplitude'], truth['annual_amplitude'], atol=3e-3)
    out = st.plot_station_distribution()
    assert out == str(tmp_path / 'station_distribution.png') and os.path.exists(out)
    assert os.path.exists(st.plot_grid('mean'))


def test_min_span_filter(combined, tmp_path):
    """Stations short of the span are left out of the seasonal fits, as in
    JAX; a stricter coverage drops every station."""
    csv, truth = combined
    for min_span, n in (((2, 0.6), 10), ((2, 0.99), 0)):
        st = port_stats(csv, workdir=str(tmp_path), min_span=min_span)
        js = J.RaiderStats(str(csv), workdir=str(tmp_path), min_span=min_span)
        got = st.seasonal_amplitude_phase(apply_span_filter=True)
        want = js.seasonal_amplitude_phase(apply_span_filter=True)
        assert len(got['ID']) == len(want) == n
        assert list(got['ID']) == list(want['ID'])
        assert set(got['ID']) == set(truth['ID'][~truth['short']]) or n == 0
        if n:
            same_grid(got['annual_phase'], want['annual_phase'].to_numpy(), RTOL_FIT)
        else:
            assert list(got) == list(want.columns)


def test_gridded_and_aoi_variograms_match_jax(combined, tmp_path):
    csv, _ = combined
    st = port_stats(csv, workdir=str(tmp_path), spacing=2.5)
    js = J.RaiderStats(str(csv), workdir=str(tmp_path), spacing=2.5)
    gs, gr = st.gridded_variogram()
    js_s, js_r = js.gridded_variogram()
    same_grid(gs, js_s, RTOL_SILL)
    same_grid(gr, js_r, RTOL_SILL)
    assert np.isfinite(gs).any()
    vg = st.variogram(errlimit=0.01)
    out, sill, rng_ = js.plot_variogram('exponential', errlimit=0.01)
    np.testing.assert_allclose(vg['sill'], sill, rtol=RTOL_SILL)
    np.testing.assert_allclose(vg['range'], rng_, rtol=RTOL_SILL)
    assert os.path.exists(st.draw_variogram(vg))


def run_both(csv, tmp_path, flags, caplog=None):
    """stats_analyses of both packages on ``csv`` with ``flags``; the port
    with pandas blocked. Returns (port record, JAX workdir, port workdir)."""
    jdir, tdir = tmp_path / 'jax', tmp_path / 'port'
    J.stats_analyses(['-f', str(csv), '-w', str(jdir), *flags])
    with blocked('pandas'):
        rec = T.stats_analyses(['-f', str(csv), '-w', str(tdir), *flags], device='cpu')
    return rec, jdir, tdir


def same_tif(a, b):
    from raider_tpu.io.geotiff import read_gtiff as j_read
    from raider_tpu_torch.io.geotiff import read_gtiff

    ga, pa = read_gtiff(str(a))
    gb, pb = j_read(str(b))
    assert pa['transform'].to_gdal() == pb['transform'].to_gdal()
    assert pa['transform'].to_gdal()[5] < 0                    # north-up
    same_grid(ga, gb, 1e-6)


def same_seasonal_csv(a, b):
    got, want = table.read_csv(a), pd.read_csv(b)
    assert list(got) == list(want.columns)
    with open(a) as fa, open(b) as fb:
        assert fa.readline() == fb.readline()
    for k in got:
        if got[k].dtype.kind in 'fi' and k != 'count':
            same_grid(got[k], want[k].to_numpy(), RTOL_FIT)
        else:
            assert list(got[k]) == list(want[k])


def test_cli_breadth_matches_jax(combined, tmp_path):
    """The station, grid, raster and seasonal flag families: the same
    products as the JAX package's (rasters north-up, the seasonal table
    equal once parsed, figures drawn last)."""
    csv, _ = combined
    flags = ['-station_delay_mean', '-station_delay_median', '-station_delay_stdev',
             '-grid_heatmap', '-grid_delay_mean', '-grid_delay_absolute_mean',
             '-grid_delay_absolute_median', '-grid_delay_absolute_stdev',
             '-grid_seasonal_amplitude', '-grid_seasonal_phase', '-grid_seasonal_absolute_phase',
             '-station_seasonal_phase', '-grid_to_raster', '-phaseamp_per_station',
             '-cm', 'plasma', '-figdpi', '40', '-sg', '-dg', '-dt', '1', '-tl']
    rec, jdir, tdir = run_both(csv, tmp_path, flags)
    tags = ('grid_heatmap', 'grid_mean', 'grid_absolute_mean', 'grid_absolute_median',
            'grid_absolute_stdev', 'grid_seasonal_amplitude', 'grid_seasonal_phase',
            'grid_seasonal_absolute_phase')
    assert sorted(rec['grids']) == sorted(tags)
    for tag in tags:
        same_tif(tdir / f'{tag}.tif', jdir / f'{tag}.tif')
        assert (tdir / f'{tag}.png').exists()
    same_seasonal_csv(tdir / 'seasonal_fits.csv', jdir / 'seasonal_fits.csv')
    for name in ('station_delay_mean', 'station_delay_median', 'station_delay_stdev',
                 'station_seasonal_phase', 'phaseamp_per_station'):
        assert (tdir / f'{name}.png').exists() and (jdir / f'{name}.png').exists()
    # every figure after every other product
    assert set(rec['figures']).isdisjoint(rec['files'])


def test_cli_variogram_flags_and_filters(combined, tmp_path, caplog):
    """The variogram family (AOI, gridded, per-timeslice) with the row
    filters (-b, -ti, a wrapping -si, -oe, -variogram_errlimit, -u)."""
    csv, _ = combined
    flags = ['-variogramplot', '-variogram_per_timeslice', '-b', '33 37 -120 -115.2',
             '-ti', '2019-02-01 2020-12-31', '-si', '11 2', '-oe', '15', '-u', 'mm',
             '-variogram_errlimit', '0.01', '-sp', '1.5']
    with caplog.at_level(logging.INFO):
        rec, jdir, tdir = run_both(csv, tmp_path, flags)
    for name in ('variogram_sill.npy', 'variogram_range.npy'):
        same_grid(np.load(tdir / name), np.load(jdir / name), RTOL_SILL)
    assert (tdir / 'variogram.png').exists()
    js = J.RaiderStats(str(csv), unit='mm', bbox=[33.0, 37.0, -120.0, -115.2],
                       timeinterval=['2019-02-01', '2020-12-31'], seasonalinterval=[11, 2],
                       obs_errlimit=15.0, spacing=1.5, workdir=str(jdir))
    st = rec['stats']
    assert len(st) == len(js.df)
    when = js.df['Datetime'].to_numpy().astype('datetime64[ns]')
    np.testing.assert_array_equal(st.t_ns.numpy(), when.astype(np.int64))
    want = [(day, J.empirical_variogram(sub['Lon'], sub['Lat'], sub['ZTD']))
            for day, sub in js.df.groupby(js.df['Datetime'].dt.date)]
    want = [(day, c, g) for day, (c, g, _, _) in want if c is not None]
    assert len(want) > 50 and [r[0] for r in rec['timeslices']] == [w[0] for w in want]
    for (day, _, gamma, _, sill, rng_), (_, c, g) in zip(rec['timeslices'], want):
        same_grid(gamma, g)
        np.testing.assert_allclose([sill, rng_], J.fit_variogram(c, g), rtol=RTOL_SILL)
    assert any('variogram' in r.getMessage() for r in caplog.records)


def test_port_products_without_matplotlib(combined, tmp_path):
    """Without matplotlib every other product is written, then the first
    figure raises an ImportError that names matplotlib."""
    csv, _ = combined
    with blocked('pandas', 'matplotlib', 'matplotlib.pyplot'):
        with pytest.raises(ImportError, match='matplotlib'):
            T.stats_analyses(['-f', str(csv), '-w', str(tmp_path), '-plotall', '-grid_to_raster',
                              '-variogram_per_timeslice'], device='cpu')
    for name in ('seasonal_fits.csv', 'variogram_sill.npy', 'grid_absolute_stdev.tif',
                 'grid_seasonal_phase.tif'):
        assert (tmp_path / name).exists(), name
    assert not list(tmp_path.glob('*.png'))


def test_figures_replaceable(combined, tmp_path, monkeypatch):
    """Every figure goes through ``draw_figure``."""
    csv, _ = combined
    drawn = []
    monkeypatch.setattr(T, 'draw_figure', lambda stats, kind, fname, **data:
                        drawn.append((kind, fname)) or fname)
    rec = T.stats_analyses(['-f', str(csv), '-w', str(tmp_path), '-plotall',
                            '-phaseamp_per_station'], device='cpu')
    assert len(drawn) == len(rec['figures']) == 16
    assert ('variogram', 'variogram.png') in drawn


def test_absolute_phase_grid_is_observation_weighted(tmp_path):
    """grid_seasonal_absolute_phase weights every observation, the
    non-absolute grid each station once: with unequal observation counts
    they differ, in both packages alike."""
    rng = np.random.default_rng(3)
    rows = ['ID,Lat,Lon,Hgt_m,Datetime,ZTD,sigZTD']
    t0 = dt.datetime(2020, 1, 1)
    for name, lat, lon, phase, step in (('AAAA', 33.2, -117.8, 0.3, 1),
                                        ('BBBB', 33.4, -117.6, 1.2, 10)):
        for d in range(0, 920, step):
            v = 2.3 + 0.03 * np.sin(2 * np.pi * d / 365.25 + phase) + rng.normal(0, 1e-5)
            rows.append(f'{name},{lat},{lon},10.0,{t0 + dt.timedelta(days=d)},{v:.9f},0.004')
    csv = tmp_path / 'two_station.csv'
    csv.write_text('\n'.join(rows) + '\n')
    flags = ['--spacing', '5.0', '-min_span', '2', '0.05', '-grid_seasonal_phase',
             '-grid_seasonal_absolute_phase', '-grid_to_raster']
    rec, jdir, tdir = run_both(csv, tmp_path, flags)
    for tag in ('grid_seasonal_phase', 'grid_seasonal_absolute_phase'):
        same_tif(tdir / f'{tag}.tif', jdir / f'{tag}.tif')
    cell_st = np.nanmean(rec['grids']['grid_seasonal_phase'].numpy())
    cell_abs = np.nanmean(rec['grids']['grid_seasonal_absolute_phase'].numpy())
    assert abs((cell_st - cell_abs) - (0.75 - (920 * 0.3 + 92 * 1.2) / 1012)) < 0.1


def test_gridfile_round_trip_across_packages(tmp_path):
    grid = np.array([[1.0, 2.0], [np.nan, 4.0]], dtype=np.float32)
    fname = str(tmp_path / 'grid_mean.tif')
    meta = T.save_gridfile(torch.as_tensor(grid), 'grid_delay_mean', fname,
                           plotbbox=(-118.0, 32.0, -116.0, 34.0), spacing=1.0, unit='m')
    jname = str(tmp_path / 'j.tif')
    assert meta == J.save_gridfile(grid, 'grid_delay_mean', jname,
                                   plotbbox=(-118.0, 32.0, -116.0, 34.0), spacing=1.0, unit='m')
    assert open(fname, 'rb').read() == open(jname, 'rb').read()
    out, gtype, bbox, spacing, cbfmt, sog, tl = T.load_gridfile(fname, 'cm', device='cpu')
    jout = J.load_gridfile(fname, 'cm')
    assert (gtype, bbox, spacing, cbfmt, sog, tl) == jout[1:]
    np.testing.assert_array_equal(out.numpy(), jout[0])
    assert gtype == 'grid_delay_mean' and bbox == [-118.0, 32.0, -116.0, 34.0]
    np.testing.assert_allclose(out[0].numpy(), [100.0, 200.0])
    assert torch.isnan(out[1, 0])
    T.save_gridfile(np.full((2, 2), np.inf), 'grid_heatmap', fname, (0, 0, 1, 1), 1.0, 'day',
                    stationsongrids=[1.0, 2.0], time_lines=[-100])
    out, *rest = T.load_gridfile(fname, 'day', device='cpu')
    assert rest[3:] == ['%1i', [1.0, 2.0], [-100.0]] and torch.isnan(out).all()


def test_load_gridfile_rejects(tmp_path):
    from raider_tpu_torch.io.geotiff import write_gtiff

    p = str(tmp_path / 'plain.tif')
    write_gtiff(np.ones((2, 2), np.float32), p)
    with pytest.raises(ValueError):
        T.load_gridfile(p, 'm', device='cpu')
    (tmp_path / 'x.tif').write_text('not a tiff')
    with pytest.raises(ValueError):
        T.load_gridfile(str(tmp_path / 'x.tif'), 'm', device='cpu')


def test_convert_si():
    with pytest.raises(ValueError):
        T.convert_SI(1.0, 'm', 'furlong')
    assert T.convert_SI(2.0, 'm', 'cm') == J.convert_SI(2.0, 'm', 'cm') == 200.0
    when = np.array(['2020-03-04T05:06:07', '2021-12-31T23:59:00'], dtype='datetime64[ns]')
    for unit in ('minute', 'hour', 'day', 'year'):
        np.testing.assert_array_equal(T.convert_SI(when, 'm', unit),
                                      J.convert_SI(pd.Series(when), 'm', unit).to_numpy())
    g = torch.ones(2)
    assert T.convert_SI(g, 'm', 'hour') is g


def test_time_lines_match_jax():
    assert T.midpoint((0, -118.0), (0, -118.0)) == -118.0
    assert T.midpoint((0, -120.0), (0, -116.0)) == J.midpoint((0, -120.0), (0, -116.0))
    when = np.array(['2020-01-01T01:00', '2020-01-01T01:05', '2020-01-01T02:00',
                     '2020-01-01T02:05', '2020-01-01T03:30', 'NaT'], dtype='datetime64[ns]')
    lon = np.array([-120.0, -119.0, -112.0, -111.0, -105.0, -100.0])
    df = pd.DataFrame({'Lon': lon, 'Lat': np.full(6, 34.0), 'Datetime': when})
    got = T.compute_time_lines({'Lon': torch.as_tensor(lon), 'Datetime': when})
    assert got == J.compute_time_lines(df) and len(got) == 3
    assert T.compute_time_lines({'Lon': lon}) == []


def test_time_lines_option(combined, tmp_path):
    csv, _ = combined
    st = port_stats(csv, workdir=str(tmp_path), plot_fmt={'time_lines': True})
    js = J.RaiderStats(str(csv), workdir=str(tmp_path), plot_fmt={'time_lines': True})
    assert st.time_lines == js.time_lines


def test_coastlines_match_jax():
    import matplotlib
    matplotlib.use('Agg')
    import matplotlib.pyplot as plt

    from raider_tpu.workflows.coastlines import COASTLINES as J_COAST
    from raider_tpu_torch.workflows.coastlines import COASTLINES, draw_coastlines

    assert len(COASTLINES) == len(J_COAST) >= 15
    for a, b in zip(COASTLINES, J_COAST):
        np.testing.assert_array_equal(a, b)
    fig, ax = plt.subplots()
    ax.set_xlim(-125, -114)
    ax.set_ylim(30, 42)
    assert draw_coastlines(ax) >= 1 and ax.get_xlim() == (-125, -114)
    ax.set_xlim(-150, -140)
    ax.set_ylim(-10, 0)
    assert draw_coastlines(ax) == 0
    plt.close(fig)


def test_flag_surface_matches_jax():
    ours = {s for a in T.create_parser()._actions for s in a.option_strings}
    theirs = {s for a in J.create_parser()._actions for s in a.option_strings}
    assert ours == theirs
    args = T.create_parser().parse_args(['-f', 'x.csv', '--cpus', '8'])
    assert args.cpus == '8'


def test_entry_points_default_to_the_card():
    import inspect

    for fn in (T.RaiderStats.__init__, T.stats_analyses, T.load_gridfile):
        assert inspect.signature(fn).parameters['device'].default == 'cuda', fn
