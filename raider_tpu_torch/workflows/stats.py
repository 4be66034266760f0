"""GNSS/model delay statistics (raiderStats): gridding, seasonal fits, variograms.

Counterpart of ``raider_tpu/workflows/stats.py``, without pandas (the
machine with the card has none): the observation table is read by
``utils.table.read_csv``; its numeric columns (Lat, Lon, the delay column,
sigZTD, the times as int64 epoch nanoseconds, int64 station codes) live on
the device as tensors, its text columns (ID, Datetime) stay host numpy.

  * group-bys (per station, per grid cell, per day) sort the rows stably
    by their key and reduce each segment in row order
    (``torch.segment_reduce``): the sums are numpy ``bincount``'s, made in
    the same order, the same bits on every run and on every device;
    medians take the two middle values of the sorted segment, as pandas
    does; ``'first'`` is the first non-NaN value in row order;
  * the seasonal fit: per-station normal equations (one segmented sum of
    every design product) on the device, the design's sin/cos columns and
    one batched float64 solve of the small systems by numpy on the host;
  * variograms: the pairs of every group (all pairs in ``triu_indices``
    order, or the ``default_rng(seed)`` subsample drawn on the host, as the
    JAX package draws it) gathered and binned on the device, many groups a
    pass; the 95th-percentile range by numpy's interpolation; the model
    fits (scipy ``curve_fit``) on the host.

Every number and every file that is not a figure is produced without
matplotlib. The figures go through :func:`draw_figure` (the drawing
functions import matplotlib and raise ``ImportError`` naming it where it is
missing); ``stats_analyses`` makes every other product before its figures.
"""

import argparse
import math
import os
import time
from contextlib import contextmanager
from typing import List, Optional, Tuple

import numpy as np
import torch

from raider_tpu_torch.logger import logger
from raider_tpu_torch.utils import require_device, table

SECONDS_PER_YEAR = 365.25 * 86400.0
_NS_PER_S = 10**9
_NS_PER_DAY = 86400 * 10**9
_PAIR_CHUNK = 1 << 23          # variogram pairs (groups x the most a group has) a pass
_TIME_UNITS = ('minute', 'hour', 'day', 'year')


# ------------------------------------------------------------------ helpers

def _div(a: torch.Tensor, b) -> torch.Tensor:
    """a / b as a true division on every device (a CUDA tensor divided by a
    Python number is a multiply by its reciprocal)."""
    return a / torch.as_tensor(b, dtype=a.dtype, device=a.device)


def _f64(x, device=None) -> torch.Tensor:
    """A float64 tensor: a tensor stays on its device, anything else goes to
    ``device`` (the card by default)."""
    if isinstance(x, torch.Tensor):
        return x.to(torch.float64)
    return torch.as_tensor(np.asarray(x, dtype=np.float64),
                           device=require_device('cuda' if device is None else device))


def _host(x) -> np.ndarray:
    return x.detach().cpu().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


class _Groups:
    """Rows grouped by an int64 key in [0, n): the stable order of the rows
    by key, and each group's length. Reductions run over each group's rows
    in row order."""

    def __init__(self, keys: torch.Tensor, n: int) -> None:
        self.keys = keys
        self.n = n
        self.order = torch.argsort(keys, stable=True)
        self.lengths = torch.bincount(keys, minlength=n)

    def sum(self, values: torch.Tensor) -> torch.Tensor:
        """Per-group sums of (N,) or (N, K) float values, in row order."""
        v = values[self.order].reshape(values.shape[0], -1)
        out = self.segment_sum(v.T.contiguous(), self.lengths).T
        return out.reshape((self.n,) + tuple(values.shape[1:]))

    @staticmethod
    def segment_sum(v: torch.Tensor, lengths: torch.Tensor) -> torch.Tensor:
        """(K, n) sums of the n consecutive segments of each row of a
        (K, N) ``v``, each added in order: ``segment_reduce`` over 2-D data
        runs one sequential loop a row and segment, on the CPU and on CUDA
        alike (over 1-D data CUDA takes a tree reduction)."""
        lengths = lengths.expand(v.shape[0], -1).contiguous()
        return torch.segment_reduce(v, 'sum', lengths=lengths, axis=1, unsafe=True, initial=0.0)

    def median(self, values: torch.Tensor) -> torch.Tensor:
        """Per-group medians of NaN-free values (the mean of the two middle
        values for an even count, as pandas); NaN for an empty group."""
        if values.numel() == 0:
            return torch.full((self.n,), float('nan'), dtype=values.dtype, device=values.device)
        by_value = torch.argsort(values, stable=True)
        v = values[by_value][torch.argsort(self.keys[by_value], stable=True)]
        start = torch.cumsum(self.lengths, 0) - self.lengths
        lo = (start + (self.lengths - 1).clamp_min(0) // 2).clamp(max=v.numel() - 1)
        hi = (start + self.lengths // 2).clamp(max=v.numel() - 1)
        med = (v[lo] + v[hi]) / 2
        return torch.where(self.lengths > 0, med, torch.full_like(med, float('nan')))

    def first_valid(self, values: torch.Tensor) -> torch.Tensor:
        """Per group, the first non-NaN value in row order (NaN if none)."""
        n_rows = values.shape[0]
        pos = torch.arange(n_rows, device=values.device)
        ok = ~torch.isnan(values)
        first = torch.full((self.n,), n_rows, dtype=torch.int64, device=values.device)
        first = first.scatter_reduce(0, self.keys[ok], pos[ok], reduce='amin')
        got = values[first.clamp(max=max(n_rows - 1, 0))] if n_rows else first.double()
        return torch.where(first < n_rows, got, torch.full_like(got, float('nan')))

    def extreme(self, values: torch.Tensor, reduce: str, fill: int) -> torch.Tensor:
        """Per-group 'amin' or 'amax' of int64 values (``fill`` if empty)."""
        out = torch.full((self.n,), fill, dtype=values.dtype, device=values.device)
        return out.scatter_reduce(0, self.keys, values, reduce=reduce)


def _digitize(x: torch.Tensor, edges: torch.Tensor) -> torch.Tensor:
    """``np.digitize(x, edges)`` for ascending edges (NaN past the end)."""
    i = torch.bucketize(x, edges, right=True)
    return torch.where(torch.isnan(x), torch.full_like(i, edges.numel()), i)


def _cells(lats, lons, lat_edges: torch.Tensor, lon_edges: torch.Tensor) -> torch.Tensor:
    """Grid cell (row-major) of each point: ``np.digitize - 1`` clipped into
    the grid, so points on or past the top edge land in the last cell."""
    ny, nx = lat_edges.numel() - 1, lon_edges.numel() - 1
    iy = (_digitize(lats, lat_edges) - 1).clamp(0, ny - 1)
    ix = (_digitize(lons, lon_edges) - 1).clamp(0, nx - 1)
    return iy * nx + ix


def _np_lerp(a, b, t):
    """numpy's quantile interpolation (``_lerp``), element by element."""
    d = b - a
    return np.where(t >= 0.5, b - d * (1 - t), a + d * t)


def _linspace_rows(stop: np.ndarray, num: int) -> np.ndarray:
    """Row r is ``np.linspace(0, stop[r], num)``, bit for bit (numpy's
    steps, its zero-step branch taken row by row)."""
    div = num - 1
    k = np.arange(num, dtype=np.float64)
    step = stop / div
    y = np.where((step == 0)[:, None], (k / div)[None, :] * stop[:, None],
                 k[None, :] * step[:, None]) + 0.0
    y[:, -1] = stop
    return y


def _sqrt_thresholds(e: np.ndarray) -> np.ndarray:
    """For each e >= 0, the least double t with ``np.sqrt(t) >= e``
    (correctly rounded): sqrt(s) >= e exactly when s >= t."""
    t = e * e
    while True:
        prev = np.nextafter(t, -np.inf)
        down = (prev >= 0) & (np.sqrt(np.maximum(prev, 0)) >= e)
        if not down.any():
            break
        t = np.where(down, prev, t)
    while True:
        up = np.sqrt(t) < e
        if not up.any():
            return t
        t = np.where(up, np.nextafter(t, np.inf), t)


def _segment_percentile(sorted_vals: torch.Tensor, start: np.ndarray, counts: np.ndarray,
                        q: float, of=None) -> np.ndarray:
    """``np.percentile(segment, q)`` (linear) of each segment of ascending
    values that starts at ``start`` and holds ``counts`` (> 0) values; with
    ``of`` (a monotonic host function) the percentile of ``of(values)``."""
    v = (counts - 1) * np.true_divide(q, 100)
    prev = np.floor(v)
    nxt = prev + 1
    top = v >= counts - 1
    prev[top] = counts[top] - 1
    nxt[top] = counts[top] - 1
    gamma = v - np.floor(v)
    idx = torch.as_tensor(np.concatenate([start + prev, start + nxt]).astype(np.int64),
                          device=sorted_vals.device)
    got = _host(sorted_vals[idx])
    if of is not None:
        got = of(got)
    a, b = got[:start.size], got[start.size:]
    return _np_lerp(a, b, gamma)


# ------------------------------------------------------------------ gridding

def make_grid(snwe, spacing: float):
    """Regular lat/lon grid edges covering an SNWE box (host numpy)."""
    s, n, w, e = snwe
    lat_edges = np.arange(s, n + spacing, spacing)
    lon_edges = np.arange(w, e + spacing, spacing)
    return lat_edges, lon_edges


def grid_statistic(lats, lons, values, lat_edges, lon_edges, statistic: str = 'mean',
                   device=None) -> torch.Tensor:
    """Gridded count, mean, stdev or median of scattered observations, on
    the device of ``lats`` (a tensor) or on ``device``: a (ny, nx) float64
    tensor, NaN in empty cells (but for the count)."""
    lats = _f64(lats, device)
    dev = lats.device
    lons, values = _f64(lons, dev).to(dev), _f64(values, dev).to(dev)
    ok = torch.isfinite(lats) & torch.isfinite(lons) & torch.isfinite(values)
    lats, lons, values = lats[ok], lons[ok], values[ok]
    lat_e = torch.as_tensor(np.asarray(lat_edges, dtype=np.float64), device=dev)
    lon_e = torch.as_tensor(np.asarray(lon_edges, dtype=np.float64), device=dev)
    ny, nx = lat_e.numel() - 1, lon_e.numel() - 1
    g = _Groups(_cells(lats, lons, lat_e, lon_e), ny * nx)
    counts = g.lengths.to(torch.float64)
    if statistic == 'count':
        return counts.reshape(ny, nx)
    if statistic == 'mean':
        out = g.sum(values) / counts
    elif statistic == 'stdev':
        s = g.sum(torch.stack([values, values ** 2], 1))
        mean = s[:, 0] / counts
        sq = s[:, 1] / counts
        out = torch.sqrt(torch.clamp_min(sq - mean ** 2, 0.0))
    elif statistic == 'median':
        out = g.median(values)
    else:
        raise ValueError(f'Unknown statistic {statistic}')
    return torch.where(counts > 0, out, torch.full_like(out, float('nan'))).reshape(ny, nx)


# ----------------------------------------------------------- time and units

def midpoint(p1, p2):
    """Central longitude of the great-circle midpoint between two (lat, lon)
    points; used for --time_lines."""
    if p1[1] == p2[1]:
        return p1[1]
    lat1, lon1, lat2, lon2 = map(math.radians, (p1[0], p1[1], p2[0], p2[1]))
    dlon = lon2 - lon1
    dx = math.cos(lat2) * math.cos(dlon)
    dy = math.cos(lat2) * math.sin(dlon)
    lon3 = lon1 + math.atan2(dy, math.cos(lat1) + dx)
    return int(math.degrees(lon3))


def compute_time_lines(df) -> List[int]:
    """Central longitudes separating the acquisition-hour bands of the
    stations: the rows are bucketed by observation hour and each band gives
    the midpoint of its longitude span. ``df`` holds 'Datetime'
    (datetime64) and 'Lon' columns."""
    if 'Datetime' not in df:
        return []
    when = np.asarray(df['Datetime']).astype('datetime64[ns]')
    lon = _host(df['Lon']).astype(np.float64)
    nat = np.isnat(when)
    hrs = np.where(nat, -1, (when.astype(np.int64) // (3600 * _NS_PER_S)) % 24)
    all_hrs = sorted(set(hrs[~nat].tolist()))

    def lon_max_min(sel):
        v = lon[sel & ~nat & ~np.isnan(lon)]
        return (v.max(), v.min()) if v.size else (np.nan, np.nan)
    central_points = []
    if len(all_hrs) == 1:
        hi, lo = lon_max_min(np.ones(lon.shape, bool))
        central_points.append(([0, hi], [0, lo]))
    else:
        for k, _ in enumerate(all_hrs):
            if k == len(all_hrs) - 1:
                sel = hrs > all_hrs[k - 1]
            elif k == 0:
                sel = hrs < all_hrs[k + 1]
            else:
                sel = (hrs > all_hrs[k - 1]) & (hrs < all_hrs[k + 1])
            hi, lo = lon_max_min(sel)
            central_points.append(([0, hi], [0, lo]))
    return [midpoint(p1, p2) for p1, p2 in central_points]


def convert_SI(val, unit_in: str, unit_out: str):
    """Unit conversion for gridded values: spatial units are scaled through
    SI; a time unit (minute/hour/day/year) extracts that component of a
    datetime64 array (anything else is returned as it is)."""
    SI = {'mm': 0.001, 'cm': 0.01, 'm': 1.0, 'km': 1000.0,
          'mm^2': 1e-6, 'cm^2': 1e-4, 'm^2': 1.0, 'km^2': 1e6}
    if unit_out in _TIME_UNITS:
        if isinstance(val, np.ndarray) and val.dtype.kind == 'M':
            v = val.astype('datetime64[ns]')
            parts = {'minute': (v - v.astype('datetime64[h]')).astype('timedelta64[m]')
                     .astype(np.int64),
                     'hour': (v - v.astype('datetime64[D]')).astype('timedelta64[h]')
                     .astype(np.int64),
                     'day': (v - v.astype('datetime64[M]')).astype('timedelta64[D]')
                     .astype(np.int64) + 1,
                     'year': v.astype('datetime64[Y]').astype(np.int64) + 1970}
            return parts[unit_out].astype(np.int32)
        return val
    if unit_out not in SI:
        raise ValueError(f'User-specified output unit {unit_out} not recognized.')
    return val * SI[unit_in] / SI[unit_out]


# ---------------------------------------------------------------- grid files

def save_gridfile(grid, gridfile_type: str, fname: str, plotbbox, spacing: float, unit: str,
                  colorbarfmt: str = '%.2f', stationsongrids=False, time_lines=False,
                  dtype: str = 'float32', noData: float = np.nan) -> dict:
    """Write a gridded array (a tensor or an array) as a GeoTIFF with the
    plot metadata tags, so a later run can reload it."""
    from raider_tpu_torch.geodesy import Geographic
    from raider_tpu_torch.io.geotiff import write_gtiff
    from raider_tpu_torch.io.rasters import GDALAffine

    if unit in _TIME_UNITS:
        colorbarfmt = '%1i'
    metadata = {
        'gridfile_type': gridfile_type,
        'plotbbox': ' '.join(str(i) for i in plotbbox),
        'spacing': str(spacing),
        'unit': unit,
        'colorbarfmt': colorbarfmt,
        'stationsongrids': (' '.join(str(i) for i in stationsongrids)
                            if stationsongrids else 'False'),
        'time_lines': (' '.join(str(i) for i in time_lines) if time_lines else 'False'),
    }
    gt = GDALAffine((plotbbox[0], spacing, 0.0, plotbbox[-1], 0.0, -spacing))
    write_gtiff(np.asarray(_host(grid), dtype=dtype), fname, transform=gt, crs=Geographic(),
                nodata=noData, metadata=metadata)
    return metadata


def load_gridfile(fname: str, unit: str, device='cuda'):
    """Reload a grid written by :func:`save_gridfile`, in ``unit``; the grid
    comes back as a float64 tensor on ``device`` (0, NaN and inf masked to
    NaN; only NaN and inf for a time unit)."""
    from raider_tpu_torch.io.geotiff import read_gtiff

    try:
        arr, profile = read_gtiff(fname)
    except (OSError, TypeError):
        raise ValueError('fname is not a valid file')
    grid = torch.as_tensor(arr[0].astype(np.float64), device=require_device(device))
    meta = profile.get('tags', {})
    nan = torch.full_like(grid, float('nan'))
    grid = torch.where(torch.isnan(grid) | (grid == float('inf')), nan, grid)
    if unit not in _TIME_UNITS:
        grid = torch.where(grid == 0, nan, grid)
    if not all(k in meta for k in ('plotbbox', 'spacing', 'unit')):
        raise ValueError(
            f'{fname} has no save_gridfile metadata tags (plotbbox/spacing/'
            'unit); it was not written by save_gridfile')
    gridfile_type = meta.get('gridfile_type', '')
    plotbbox = [float(i) for i in meta['plotbbox'].split()]
    spacing = float(meta['spacing'])
    colorbarfmt = meta.get('colorbarfmt', '%.2f')
    inputunit = meta['unit']
    if '^2' in inputunit:
        unit = unit.split('^2')[0] + '^2'
    grid = convert_SI(grid, inputunit, unit)
    stationsongrids = meta.get('stationsongrids', 'False')
    stationsongrids = (False if stationsongrids == 'False'
                       else [float(i) for i in stationsongrids.split()])
    time_lines = meta.get('time_lines', 'False')
    time_lines = False if time_lines == 'False' else [float(i) for i in time_lines.split()]
    return grid, gridfile_type, plotbbox, spacing, colorbarfmt, stationsongrids, time_lines


# -------------------------------------------------------------- seasonal fit

def seasonal_fit(times_s, values, station_idx, n_stations: int, periods_per_year=(1.0, 2.0)):
    """Batched harmonic regression per station, on the device of ``values``.

    Model: v = c0 + c1 t + sum_k [a_k sin(2 pi f_k t) + b_k cos(2 pi f_k t)],
    t in years from ``t_ref``, the whole year at or before the first
    sample. Returns a dict of tensors 'amplitude' and 'phase' (n_stations,
    n_freq; phase = atan2(b, a)), 'trend', 'mean', 'count' (rows a station)
    and the float 't_ref' (seconds). A station with fewer rows than
    coefficients is NaN. One segmented sum of the design products on the
    device gives the normal equations; the design's columns and the one
    batched float64 solve of the small systems (a 1e-12 ridge) are numpy's,
    so that every device fits the same numbers.
    """
    v = _f64(values)
    dev = v.device
    idx = torch.as_tensor(station_idx, device=dev).to(torch.int64)
    # the design on the host (numpy's sin and cos): a device's own differ in
    # the last bits, which an ill-conditioned fit (a few months of record)
    # would carry into the coefficients
    t = np.asarray(_host(times_s), dtype=np.float64)
    t_ref = float(np.floor(t.min() / SECONDS_PER_YEAR) * SECONDS_PER_YEAR)
    t_yr = (t - t_ref) / SECONDS_PER_YEAR
    cols = [np.ones_like(t_yr), t_yr]
    for f in periods_per_year:
        cols.append(np.sin(2 * np.pi * f * t_yr))
        cols.append(np.cos(2 * np.pi * f * t_yr))
    design = torch.as_tensor(np.stack(cols, axis=-1), device=dev)      # (N, P)
    p = design.shape[1]
    iu, ju = np.triu_indices(p)
    products = torch.cat([design[:, iu] * design[:, ju], design * v[:, None]], 1)
    g = _Groups(idx, n_stations)
    sums = g.sum(products)
    ata = torch.zeros((n_stations, p, p), dtype=torch.float64, device=dev)
    ata[:, iu, ju] = sums[:, :iu.size]
    ata[:, ju, iu] = sums[:, :iu.size]
    atb = sums[:, iu.size:]
    counts = g.lengths
    coeffs = np.full((n_stations, p), np.nan)
    solvable = _host(counts >= p)
    if solvable.any():
        # the (stations, P, P) systems are solved by LAPACK on the host, the
        # same bits from every device (and numpy's, as the JAX package solves)
        coeffs[solvable] = np.linalg.solve(_host(ata)[solvable] + np.eye(p) * 1e-12,
                                           _host(atb)[solvable][..., None])[..., 0]
    coeffs = torch.as_tensor(coeffs, device=dev)
    a = coeffs[:, 2::2]
    b = coeffs[:, 3::2]
    return {'mean': coeffs[:, 0], 'trend': coeffs[:, 1], 'amplitude': torch.hypot(a, b),
            'phase': torch.atan2(b, a), 'count': counts, 't_ref': t_ref}


# ---------------------------------------------------------------- variograms

def _pairs(n: int, max_pairs: int, seed: int):
    """The index pairs of an n-point variogram, host int64 (i, j), and the
    meta dict: every unordered pair in ``np.triu_indices`` order when they
    fit the budget, else ``max_pairs`` draws of ``default_rng(seed)``
    without the i == j ones, as the JAX package draws them."""
    n_total = n * (n - 1) // 2
    if n_total <= max_pairs:
        i, j = np.triu_indices(n, k=1)
        meta = {'estimator': 'all_pairs', 'n_pairs_used': int(n_total),
                'n_pairs_total': int(n_total)}
    else:
        rng = np.random.default_rng(seed)
        i = rng.integers(0, n, max_pairs)
        j = rng.integers(0, n, max_pairs)
        keep = i != j
        i, j = i[keep], j[keep]
        meta = {'estimator': 'subsampled', 'n_pairs_used': int(i.size),
                'n_pairs_total': int(n_total)}
    return i, j, meta


def _variograms(x: torch.Tensor, y: torch.Tensor, v: torch.Tensor, keys: torch.Tensor,
                n_groups: int, min_rows: int = 0, n_bins: int = 20,
                max_dist: Optional[float] = None, max_pairs: int = 200000, seed: int = 0):
    """Empirical semivariograms of many groups of rows at once.

    A group counts when it has at least ``min_rows`` rows and at least 10
    rows with finite x, y and v. Its pairs (:func:`_pairs`, indices into
    its finite rows in row order, drawn once for each point count) are
    gathered and binned on the device,
    ~``_PAIR_CHUNK`` pairs a pass: distance sqrt(dx^2 + dy^2) (binned by
    its square against exact thresholds, so that every device bins
    alike), semivariance
    0.5 (v_i - v_j)^2, bins ``linspace(0, max_dist, n_bins + 1)`` with
    ``max_dist`` the 95th percentile of the group's distances by default,
    the pairs past it dropped. Returns (centers, gamma, counts) (n_groups,
    n_bins) float64 tensors, NaN rows for the groups that do not count,
    and a list of each group's meta dict (None where it does not count).
    """
    dev = v.device
    rows = _host(torch.bincount(keys, minlength=n_groups))
    finite = torch.isfinite(x) & torch.isfinite(y) & torch.isfinite(v)
    fin_idx = torch.nonzero(finite)[:, 0]
    fin_keys = keys[finite]
    by_group = fin_idx[torch.argsort(fin_keys, stable=True)]
    n_fin = _host(torch.bincount(fin_keys, minlength=n_groups))
    fin_start = np.cumsum(n_fin) - n_fin
    nan = float('nan')
    centers = torch.full((n_groups, n_bins), nan, dtype=torch.float64, device=dev)
    gamma = torch.full_like(centers, nan)
    counts = torch.full_like(centers, nan)
    metas: List[Optional[dict]] = [None] * n_groups
    todo = [g for g in range(n_groups) if rows[g] >= min_rows and n_fin[g] >= 10]
    drawn = {}                       # the pairs by point count: the draw is the same
    for g in todo:
        n = int(n_fin[g])
        if n not in drawn:
            drawn[n] = _pairs(n, max_pairs, seed)
        metas[g] = drawn[n][2]
    while todo:
        # a pass: groups in order while the (groups x most pairs) sort fits
        chunk, widest = [], 0
        while todo:
            size = drawn[int(n_fin[todo[0]])][0].size
            if chunk and (len(chunk) + 1) * max(widest, size) > _PAIR_CHUNK:
                break
            chunk.append(todo.pop(0))
            widest = max(widest, size)
        got = [drawn[int(n_fin[g])] for g in chunk]
        sizes = np.array([i.size for i, _, _ in got])
        start = np.cumsum(sizes) - sizes
        off = np.repeat(fin_start[chunk], sizes)
        pi = torch.as_tensor(np.concatenate([i for i, _, _ in got]) + off, device=dev)
        pj = torch.as_tensor(np.concatenate([j for _, j, _ in got]) + off, device=dev)
        member = torch.as_tensor(np.repeat(np.arange(len(chunk)), sizes), device=dev)
        gi, gj = by_group[pi], by_group[pj]
        # the squared distance, exact IEEE products and sums on every device;
        # the distance d = sqrt(d2) is only ever rounded on the host
        dx, dy = x[gi] - x[gj], y[gi] - y[gj]
        d2 = dx * dx + dy * dy
        sq = 0.5 * (v[gi] - v[gj]) ** 2
        # each group's squared distances in a row of its own, padded with inf
        rank = torch.arange(d2.numel(), device=dev) - torch.as_tensor(start, device=dev)[member]
        table_d2 = torch.full((len(chunk), widest), float('inf'), dtype=d2.dtype, device=dev)
        table_d2[member, rank] = d2
        if max_dist is None:
            md = _segment_percentile(torch.sort(table_d2, dim=1).values.reshape(-1),
                                     np.arange(len(chunk)) * widest, sizes, 95, np.sqrt)
        else:
            md = np.full(len(chunk), float(max_dist))
        edges = _linspace_rows(md, n_bins + 1)                       # (groups, n_bins + 1)
        # np.digitize(d, edges): the number of edges e with d >= e, that is
        # with d2 at or above e's threshold
        at = torch.searchsorted(torch.as_tensor(_sqrt_thresholds(edges), device=dev), table_d2,
                                right=True)
        which = (at[member, rank] - 1).clamp(0, n_bins - 1)
        # d <= md: d below the next double's threshold
        inside = d2 < torch.as_tensor(_sqrt_thresholds(np.nextafter(md, np.inf)),
                                      device=dev)[member]
        cnt = torch.bincount((member * n_bins + which)[inside],
                             minlength=len(chunk) * n_bins).reshape(-1, n_bins).to(torch.float64)
        # each pair's semivariance in its bin's row, 0.0 in the others
        # (adding +0.0 leaves a sum of squares unchanged), summed along each
        # group's pairs in order: numpy's bincount sums
        bins = torch.arange(n_bins, device=dev)[:, None]
        by_bin = torch.where((which[None, :] == bins) & inside[None, :], sq[None, :],
                             torch.zeros((), dtype=sq.dtype, device=dev))
        sums = _Groups.segment_sum(by_bin, torch.as_tensor(sizes, device=dev)).T
        del by_bin
        rows_c = torch.as_tensor(chunk, device=dev)
        counts[rows_c] = cnt
        gamma[rows_c] = sums / cnt
        centers[rows_c] = torch.as_tensor(0.5 * (edges[:, :-1] + edges[:, 1:]), device=dev)
    return centers, gamma, counts, metas


def empirical_variogram(x, y, values, n_bins: int = 20, max_dist: Optional[float] = None,
                        max_pairs: int = 200000, seed: int = 0, device=None):
    """Binned empirical semivariance 0.5 E[(v_i - v_j)^2] against distance.

    Exact over all pairs when they fit ``max_pairs``, else over a random
    subsample of pairs (the returned meta says which). Returns (centers,
    gamma, counts, meta) with (n_bins,) float64 tensors on the device of
    ``values`` (or ``device``); meta = {'estimator': 'all_pairs' |
    'subsampled', 'n_pairs_used', 'n_pairs_total'}; (None, None, None,
    None) under 10 usable points.
    """
    v = _f64(values, device)
    x, y = _f64(x, v.device).to(v.device), _f64(y, v.device).to(v.device)
    keys = torch.zeros(v.shape, dtype=torch.int64, device=v.device)
    c, g, n, metas = _variograms(x, y, v, keys, 1, n_bins=n_bins, max_dist=max_dist,
                                 max_pairs=max_pairs, seed=seed)
    if metas[0] is None:
        return None, None, None, None
    return c[0], g[0], n[0], metas[0]


def _exponential_model(h, sill, rng_):
    return sill * (1.0 - np.exp(-h / np.maximum(rng_, 1e-12)))


def _gaussian_model(h, sill, rng_):
    return sill * (1.0 - np.exp(-(h**2) / np.maximum(rng_, 1e-12) ** 2))


def fit_variogram(centers, gamma, model: str = 'exponential'):
    """Least-squares (sill, range) fit of a variogram model (scipy, on the
    host)."""
    from scipy.optimize import curve_fit

    centers, gamma = _host(centers), _host(gamma)
    ok = np.isfinite(gamma)
    if ok.sum() < 3:
        return np.nan, np.nan
    fn = _exponential_model if model == 'exponential' else _gaussian_model
    try:
        p0 = [np.nanmax(gamma[ok]), centers[ok][-1] / 3]
        popt, _ = curve_fit(fn, centers[ok], gamma[ok], p0=p0, maxfev=5000)
        return float(popt[0]), float(popt[1])  # sill, range
    except Exception:
        return np.nan, np.nan


# -------------------------------------------------------------------- figures

def _pyplot():
    try:
        import matplotlib.pyplot as plt
    except ImportError as exc:
        raise ImportError('raiderStats figures need matplotlib, which cannot be imported '
                          f'({exc}); every other product is written without it') from exc
    return plt


def _color_limits(stats, values) -> tuple:
    """vmin/vmax from explicit cbounds or the colorpercentile option."""
    cb = stats.fmt.get('cbounds')
    if cb:
        return float(cb[0]), float(cb[1])
    lo, hi = stats.fmt.get('colorpercentile', (25, 95))
    v = np.asarray(values, dtype=np.float64)
    v = v[np.isfinite(v)]
    if v.size == 0:
        return None, None
    return float(np.percentile(v, lo)), float(np.percentile(v, hi))


def _out_path(stats, fname: str) -> str:
    ext = stats.fmt.get('plot_format', 'png')
    return os.path.join(stats.workdir, f'{os.path.splitext(fname)[0]}.{ext}')


def _finish(stats, fig, ax, title: str, fname: str) -> str:
    ax.set_xlabel('Longitude')
    ax.set_ylabel('Latitude')
    ax.set_title(stats.fmt.get('user_title') or title)
    if stats.fmt.get('coastlines', True):
        from raider_tpu_torch.workflows.coastlines import draw_coastlines

        draw_coastlines(ax)
    if stats.fmt.get('drawgridlines'):
        ax.set_xticks(stats.lon_edges, minor=True)
        ax.set_yticks(stats.lat_edges, minor=True)
        ax.grid(which='minor', linewidth=0.3, color='k', alpha=0.4)
    for lon in getattr(stats, 'time_lines', []) or []:
        ax.axvline(lon, color='k', linestyle='--', linewidth=0.8)
    out = _out_path(stats, fname)
    fig.savefig(out, dpi=stats.fmt.get('figdpi', 100))
    _pyplot().close(fig)
    return out


def _draw_scatter(stats, fname, lon, lat, values=None, label=''):
    plt = _pyplot()
    fig, ax = plt.subplots(figsize=(8, 6))
    if values is None:
        ax.scatter(lon, lat, s=12, color='tab:blue')
    else:
        vmin, vmax = _color_limits(stats, values)
        sc = ax.scatter(lon, lat, c=values, s=12, cmap=stats.fmt.get('colormap', 'viridis'),
                        vmin=vmin, vmax=vmax)
        fig.colorbar(sc, ax=ax, label=label)
    return _finish(stats, fig, ax, label or 'Station distribution', fname)


def _draw_grid(stats, fname, grid, label, title, station_lon=None, station_lat=None):
    plt = _pyplot()
    fig, ax = plt.subplots(figsize=(8, 6))
    vmin, vmax = _color_limits(stats, grid)
    im = ax.imshow(grid, origin='lower', cmap=stats.fmt.get('colormap', 'viridis'),
                   vmin=vmin, vmax=vmax,
                   extent=[stats.lon_edges[0], stats.lon_edges[-1], stats.lat_edges[0],
                           stats.lat_edges[-1]], aspect='auto')
    fig.colorbar(im, ax=ax, label=label)
    if station_lon is not None:
        ax.scatter(station_lon, station_lat, s=4, color='k', alpha=0.5)
    return _finish(stats, fig, ax, title, fname)


def _draw_variogram(stats, fname, centers, gamma, meta, sill, rng_, model):
    plt = _pyplot()
    fig, ax = plt.subplots(figsize=(8, 6))
    emp_label = 'binned empirical'
    if meta['estimator'] == 'subsampled':
        emp_label += f" ({meta['n_pairs_used']:,} of {meta['n_pairs_total']:,} pairs sampled)"
    ax.plot(centers, gamma, 'o', ms=4, label=emp_label)
    if np.isfinite(sill):
        h = np.linspace(0, centers[-1], 200)
        fn = _exponential_model if model == 'exponential' else _gaussian_model
        ax.plot(h, fn(h, sill, rng_), '-', label=f'{model}: sill={sill:.2e}, range={rng_:.2f}')
    ax.set_xlabel('Distance [deg]')
    ax.set_ylabel('Semivariance')
    ax.legend()
    ax.set_title(stats.fmt.get('user_title') or 'Empirical variogram')
    out = _out_path(stats, fname)
    fig.savefig(out, dpi=stats.fmt.get('figdpi', 100))
    plt.close(fig)
    return out


def _draw_phaseamp(stats, fname, panels):
    plt = _pyplot()
    n = len(panels)
    ncol = min(4, max(1, n))
    nrow = (n + ncol - 1) // ncol
    fig, axes = plt.subplots(nrow, ncol, figsize=(4 * ncol, 2.5 * nrow), squeeze=False)
    for k, (sid, t, obs, tt, curve) in enumerate(panels):
        ax = axes[k // ncol][k % ncol]
        ax.plot(t, obs, '.', ms=2, alpha=0.5)
        ax.plot(tt, curve, '-', lw=1)
        ax.set_title(str(sid), fontsize=8)
        if stats.fmt.get('time_lines'):
            for yr in range(int(np.floor(t.min())), int(np.ceil(t.max())) + 1):
                ax.axvline(yr, color='k', lw=0.3, alpha=0.4)
    for k in range(n, nrow * ncol):
        axes[k // ncol][k % ncol].axis('off')
    fig.tight_layout()
    out = _out_path(stats, fname)
    fig.savefig(out, dpi=stats.fmt.get('figdpi', 100))
    plt.close(fig)
    return out


_DRAW = {'scatter': _draw_scatter, 'grid': _draw_grid, 'variogram': _draw_variogram,
         'phaseamp': _draw_phaseamp}


def draw_figure(stats, kind: str, fname: str, **data) -> str:
    """Draw one figure (host numpy ``data``) with matplotlib; returns the
    file written. Every figure of the module goes through here."""
    return _DRAW[kind](stats, fname, **data)


# -------------------------------------------------------------- main driver

class RaiderStats:
    """Statistics over a combined GNSS/model delay CSV, the numbers on
    ``device`` (the card by default)."""

    def __init__(self, filearg, col_name: str = 'ZTD', unit: str = 'm',
                 workdir: str = './', bbox=None, spacing: float = 1.0,
                 timeinterval=None, seasonalinterval=None,
                 obs_errlimit: float = float('inf'), min_span=(2, 0.6),
                 period_limit: float = 0.0, plot_fmt: Optional[dict] = None,
                 device='cuda') -> None:
        t0 = time.perf_counter()
        self.device = dev = require_device(device)
        self.fname = filearg
        self.col_name = col_name
        self.unit = unit
        self.workdir = workdir
        self.spacing = spacing
        self.min_span = min_span
        self.period_limit = period_limit
        self.fmt = {
            'figdpi': 100, 'user_title': None, 'plot_format': 'png',
            'cbounds': None, 'colorpercentile': (25, 95), 'colormap': 'viridis',
            'densitythreshold': 10, 'stationsongrids': False,
            'drawgridlines': False, 'time_lines': False,
        }
        self.fmt.update(plot_fmt or {})
        os.makedirs(workdir, exist_ok=True)

        raw = table.read_csv(filearg, parse_dates=['Datetime'])
        if col_name not in raw:
            raise KeyError(f'Column {col_name} not found in {filearg}')
        self.seconds = {'read_csv': time.perf_counter() - t0}
        numeric = [c for c in ('Lat', 'Lon', col_name, 'sigZTD') if c in raw]
        cols = {c: torch.as_tensor(raw[c].astype(np.float64), device=dev) for c in numeric}
        when = raw['Datetime'].astype('datetime64[ns]')
        nat = np.isnat(when)
        t_ns = torch.as_tensor(when.astype(np.int64), device=dev)
        # unit conversion to metres
        scale = {'m': 1.0, 'cm': 0.01, 'mm': 0.001}.get(unit, 1.0)
        cols[col_name] = cols[col_name] * scale
        keep = torch.ones(t_ns.shape, dtype=torch.bool, device=dev)
        if np.isfinite(obs_errlimit) and 'sigZTD' in cols:
            keep &= cols['sigZTD'] * scale <= obs_errlimit
        if timeinterval:
            t0_ns, t1_ns = (int(table.parse_datetimes([x])[0].astype(np.int64))
                            for x in timeinterval)
            nat_d = torch.as_tensor(nat, device=dev)
            keep &= ~nat_d & (t_ns >= t0_ns) & (t_ns <= t1_ns)
        if seasonalinterval:
            # months of year, e.g. (6, 8) for Jun-Aug (inclusive); wraps past December
            m0, m1 = seasonalinterval
            months = torch.as_tensor(when.astype('datetime64[M]').astype(np.int64) % 12 + 1,
                                     device=dev)
            ok = (months >= m0) & (months <= m1) if m0 <= m1 else (months >= m0) | (months <= m1)
            keep &= ok & ~torch.as_tensor(nat, device=dev)
        if bbox:
            s, n, w, e = bbox
            lat, lon = cols['Lat'], cols['Lon']
            keep &= (lat >= s) & (lat <= n) & (lon >= w) & (lon <= e)
        keep_h = _host(keep)
        self.df = {k: v[keep_h] for k, v in raw.items() if k not in numeric}
        self.df.update({k: v[keep] for k, v in cols.items()})
        self.t_ns = t_ns[keep]
        ids = self.df['ID']
        null = table.isnull(ids)
        self.ids, inv = np.unique(ids[~null], return_inverse=True)
        code = np.full(ids.shape, -1, dtype=np.int64)
        code[~null] = inv
        self.code = torch.as_tensor(code, device=dev)
        self._sm = None
        self.time_lines = compute_time_lines(self.df) if self.fmt.get('time_lines') else []
        if bbox:
            self.snwe = list(bbox)
        else:
            lat, lon = self.df['Lat'], self.df['Lon']
            lat, lon = lat[~torch.isnan(lat)], lon[~torch.isnan(lon)]
            self.snwe = [float(lat.min()), float(lat.max()), float(lon.min()), float(lon.max())]
        self.lat_edges, self.lon_edges = make_grid(self.snwe, spacing)
        if dev.type == 'cuda':
            torch.cuda.synchronize(dev)
        self.seconds['read'] = time.perf_counter() - t0

    def __len__(self) -> int:
        return int(self.t_ns.numel())

    # --------------------------------------------------------------- metrics
    def _station_groups(self, rows: Optional[torch.Tensor] = None):
        """(groups over the station codes of the rows with an ID, those
        rows' mask)."""
        sel = self.code >= 0
        if rows is not None:
            sel &= rows
        return _Groups(self.code[sel], self.ids.size), sel

    def station_means(self) -> dict:
        """Per station, in sorted ID order: the first non-NaN Lat and Lon,
        and the delay column's NaN-skipping mean, median, std (ddof 1) and
        count. ID is host numpy; the rest are tensors."""
        if self._sm is None:
            g, sel = self._station_groups()
            col = self.df[self.col_name][sel]
            ok = ~torch.isnan(col)
            gv = _Groups(g.keys[ok], g.n)
            vals = col[ok]
            cnt = gv.lengths
            mean = gv.sum(vals) / cnt
            dev2 = gv.sum((vals - mean[gv.keys]) ** 2)
            self._sm = {
                'ID': self.ids,
                'Lat': g.first_valid(self.df['Lat'][sel]),
                'Lon': g.first_valid(self.df['Lon'][sel]),
                'mean': mean,
                'median': gv.median(vals),
                'std': torch.where(cnt > 1, torch.sqrt(dev2 / (cnt - 1)),
                                   torch.full_like(dev2, float('nan'))),
                'count': cnt,
            }
        return self._sm

    def grid_map(self, statistic: str = 'mean', absolute: bool = False) -> torch.Tensor:
        """Gridded statistic: every observation (``absolute``) or the
        per-station values (the station count for 'count')."""
        if absolute:
            return grid_statistic(self.df['Lat'], self.df['Lon'], self.df[self.col_name],
                                  self.lat_edges, self.lon_edges, statistic)
        sm = self.station_means()
        if statistic == 'count':
            return grid_statistic(sm['Lat'], sm['Lon'], sm['count'], self.lat_edges,
                                  self.lon_edges, 'count')
        col = {'mean': 'mean', 'median': 'median', 'stdev': 'std'}[statistic]
        return grid_statistic(sm['Lat'], sm['Lon'], sm[col], self.lat_edges, self.lon_edges,
                              'mean')

    def grid_map_masked(self, statistic: str = 'mean', absolute: bool = False) -> torch.Tensor:
        """grid_map with the densitythreshold mask: under-sampled cells of
        absolute (all-observation) grids become NaN; station-mean and count
        grids stay unmasked."""
        grid = self.grid_map(statistic, absolute=absolute)
        thresh = self.fmt.get('densitythreshold', 0)
        if thresh and absolute and statistic != 'count':
            counts = self.grid_map('count', absolute=True)
            grid = torch.where(counts >= thresh, grid, torch.full_like(grid, float('nan')))
        return grid

    def _seasonal_station_mask(self) -> torch.Tensor:
        """Stations (in ``self.ids`` order) eligible for seasonal fits: a
        time span of at least max(min_span[0], period_limit) years, and
        distinct days at least min_span[1] of the span in days (at least 1)."""
        dev = self.device
        nat = self.t_ns == torch.iinfo(torch.int64).min
        g, sel = self._station_groups(~nat)
        t = self.t_ns[sel]
        big = torch.iinfo(torch.int64).max
        t_max = g.extreme(t, 'amax', -big)
        t_min = g.extreme(t, 'amin', big)
        span_ns = (t_max - t_min).to(torch.float64)
        span_days = _div(_div(span_ns, 1e9), 86400.0)
        span_days = torch.where(g.lengths > 0, span_days,
                                torch.full_like(span_days, float('nan')))
        day = torch.div(t, _NS_PER_DAY, rounding_mode='floor')
        n_days = torch.zeros(g.n, dtype=torch.int64, device=dev)
        if day.numel():
            d0 = int(day.min())
            width = int(day.max()) - d0 + 1
            pairs = torch.unique(g.keys * width + (day - d0))
            n_days = torch.bincount(torch.div(pairs, width, rounding_mode='floor'),
                                    minlength=g.n)
        min_years, min_frac = self.min_span
        return ((span_days >= max(min_years, self.period_limit) * 365.25)
                & (n_days >= min_frac * span_days.clamp(min=1.0)))

    def seasonal_amplitude_phase(self, apply_span_filter: bool = False) -> dict:
        """Annual and semiannual amplitude and phase per station, from the
        batched harmonic fit (only span-eligible stations with
        ``apply_span_filter``). A dict of columns: ID host numpy, the rest
        tensors; the empty table has the columns ID, annual_amplitude and
        annual_phase."""
        rows = None
        if apply_span_filter:
            ok = self._seasonal_station_mask()
            rows = (self.code >= 0) & ok[self.code.clamp(min=0)]
            if not bool(rows.any()):
                empty = np.array([], dtype=np.float64)
                return {'ID': np.array([], dtype=object), 'annual_amplitude': empty,
                        'annual_phase': empty}
        return self._seasonal_fit_frame(rows)

    def _seasonal_fit_frame(self, rows: Optional[torch.Tensor]) -> dict:
        g, sel = self._station_groups(rows)
        present = g.lengths > 0
        remap = torch.cumsum(present.to(torch.int64), 0) - 1
        ids = self.ids[_host(present)]
        station_idx = remap[g.keys]
        epoch = torch.div(self.t_ns[sel], _NS_PER_S, rounding_mode='floor').to(torch.float64)
        fit = seasonal_fit(epoch, self.df[self.col_name][sel], station_idx, len(ids))
        sub = _Groups(station_idx, len(ids))
        return {
            'ID': ids,
            'annual_amplitude': fit['amplitude'][:, 0],
            'annual_phase': fit['phase'][:, 0],
            'semiannual_amplitude': fit['amplitude'][:, 1],
            'semiannual_phase': fit['phase'][:, 1],
            'trend_per_year': fit['trend'],
            'mean': fit['mean'],
            'count': fit['count'],
            # the epoch (in years) the mean/trend/phase coefficients are
            # relative to: a fitted curve must be evaluated from THIS epoch
            'fit_epoch_yr': torch.full((len(ids),), fit['t_ref'] / SECONDS_PER_YEAR,
                                       dtype=torch.float64, device=self.device),
            'Lat': sub.first_valid(self.df['Lat'][sel]),
            'Lon': sub.first_valid(self.df['Lon'][sel]),
        }

    def absolute_phase_rows(self, seasonal: dict, col: str = 'annual_phase'):
        """Every observation row of a station in ``seasonal`` (row order),
        with that station's ``col`` value: (lat, lon, value) tensors."""
        code = np.full(self.ids.size, -1, dtype=np.int64)
        code[np.searchsorted(self.ids, seasonal['ID'])] = np.arange(len(seasonal['ID']))
        at = torch.as_tensor(code, device=self.device)[self.code.clamp(min=0)]
        rows = (self.code >= 0) & (at >= 0)
        return (self.df['Lat'][rows], self.df['Lon'][rows],
                torch.as_tensor(seasonal[col], device=self.device)[at[rows]])

    def gridded_variogram(self, model: str = 'exponential') -> Tuple[np.ndarray, np.ndarray]:
        """Per-grid-cell variogram (sill, range) maps (host numpy): a cell
        with at least 10 rows, and at least 10 finite ones, gets the model
        fitted to its empirical variogram (longitude as x, latitude as y)."""
        ny, nx = len(self.lat_edges) - 1, len(self.lon_edges) - 1
        lat_e, lon_e = (torch.as_tensor(e, device=self.device)
                        for e in (self.lat_edges, self.lon_edges))
        keys = _cells(self.df['Lat'], self.df['Lon'], lat_e, lon_e)
        centers, gamma, _, metas = _variograms(self.df['Lon'], self.df['Lat'],
                                               self.df[self.col_name], keys, ny * nx,
                                               min_rows=10)
        return self._fits(centers, gamma, metas, model, (ny, nx))

    @staticmethod
    def _fits(centers, gamma, metas, model, shape):
        sill = np.full(len(metas), np.nan)
        rng_ = np.full(len(metas), np.nan)
        c_h, g_h = _host(centers), _host(gamma)
        for k, meta in enumerate(metas):
            if meta is not None:
                sill[k], rng_[k] = fit_variogram(c_h[k], g_h[k], model)
        return sill.reshape(shape), rng_.reshape(shape)

    def variogram(self, model: str = 'exponential', errlimit: float = float('inf')) -> dict:
        """The AOI-wide empirical variogram (rows with sigZTD <= errlimit)
        and its (sill, range) fit."""
        sel = torch.ones(self.t_ns.shape, dtype=torch.bool, device=self.device)
        if np.isfinite(errlimit) and 'sigZTD' in self.df:
            sel = self.df['sigZTD'] <= errlimit
        centers, gamma, counts, meta = empirical_variogram(
            self.df['Lon'][sel], self.df['Lat'][sel], self.df[self.col_name][sel])
        if centers is None:
            raise ValueError('Not enough observations for a variogram')
        sill, rng_ = fit_variogram(centers, gamma, model)
        return dict(centers=centers, gamma=gamma, counts=counts, meta=meta, sill=sill,
                    range=rng_, model=model)

    def timeslice_variograms(self, model: str = 'exponential') -> list:
        """The empirical variogram of each day (sorted, rows without a time
        left out) and its fit: (date, centers, gamma, counts, sill, range)
        for each day with at least 10 usable rows."""
        nat = self.t_ns == torch.iinfo(torch.int64).min
        day = torch.div(self.t_ns[~nat], _NS_PER_DAY, rounding_mode='floor')
        days, keys = torch.unique(day, return_inverse=True)
        sel = ~nat
        centers, gamma, counts, metas = _variograms(
            self.df['Lon'][sel], self.df['Lat'][sel], self.df[self.col_name][sel], keys,
            days.numel())
        sill, rng_ = self._fits(centers, gamma, metas, model, (len(metas),))
        c_h, g_h, n_h = _host(centers), _host(gamma), _host(counts)
        dates = _host(days).astype('datetime64[D]').astype(object)
        return [(dates[k], c_h[k], g_h[k], n_h[k], sill[k], rng_[k])
                for k, meta in enumerate(metas) if meta is not None]

    def grid_to_raster(self, grid, fname: str) -> str:
        """Write a gridded map as a north-up float32 GeoTIFF (NaN nodata)."""
        from raider_tpu_torch.geodesy import Geographic
        from raider_tpu_torch.io.geotiff import write_gtiff
        from raider_tpu_torch.io.rasters import GDALAffine

        dy = self.lat_edges[1] - self.lat_edges[0]
        dx = self.lon_edges[1] - self.lon_edges[0]
        gt = GDALAffine((self.lon_edges[0], dx, 0.0, self.lat_edges[-1], 0.0, -dy))
        out = os.path.join(self.workdir, fname)
        # grids are south-up (row 0 at the south edge); rasters are north-up
        write_gtiff(np.flipud(_host(grid)).astype(np.float32), out, transform=gt,
                    crs=Geographic(), nodata=float('nan'))
        return out

    # ----------------------------------------------------------------- plots
    def plot_station_scatter(self, values, label: str, fname: str) -> str:
        """Scatter map of one per-station value."""
        sm = self.station_means()
        return draw_figure(self, 'scatter', fname, lon=_host(sm['Lon']), lat=_host(sm['Lat']),
                           values=_host(values), label=label)

    def plot_station_distribution(self, fname: str = 'station_distribution.png') -> str:
        sm = self.station_means()
        return draw_figure(self, 'scatter', fname, lon=_host(sm['Lon']), lat=_host(sm['Lat']))

    def plot_grid(self, statistic: str = 'mean', fname: Optional[str] = None,
                  absolute: bool = False, grid=None, label: Optional[str] = None) -> str:
        if grid is None:
            grid = self.grid_map_masked(statistic, absolute=absolute)
        extra = {}
        if self.fmt.get('stationsongrids'):
            sm = self.station_means()
            extra = dict(station_lon=_host(sm['Lon']), station_lat=_host(sm['Lat']))
        name = fname or ('grid_%s%s' % ('absolute_' if absolute else '', statistic))
        return draw_figure(self, 'grid', name, grid=_host(grid),
                           label=label or f'{statistic} {self.col_name}',
                           title=label or f'Gridded {statistic}', **extra)

    def draw_variogram(self, vg: dict, fname: str = 'variogram.png') -> str:
        return draw_figure(self, 'variogram', fname, centers=_host(vg['centers']),
                           gamma=_host(vg['gamma']), meta=vg['meta'], sill=vg['sill'],
                           rng_=vg['range'], model=vg['model'])

    def plot_variogram(self, model: str = 'exponential', errlimit: float = float('inf'),
                       fname: str = 'variogram.png') -> Tuple[str, float, float]:
        """The AOI-wide empirical variogram and its fitted model curve."""
        vg = self.variogram(model, errlimit)
        return self.draw_variogram(vg, fname), vg['sill'], vg['range']

    def plot_phaseamp_per_station(self, max_stations: int = 16,
                                  fname: str = 'phaseamp_per_station.png') -> str:
        """Observed series and the fitted harmonic per station, one panel
        each."""
        fits = {k: _host(v) for k, v in self.seasonal_amplitude_phase().items()}
        panels = []
        col = _host(self.df[self.col_name])
        t_all = _host(torch.div(self.t_ns, _NS_PER_S, rounding_mode='floor')) / SECONDS_PER_YEAR
        code = _host(self.code)
        for k, sid in enumerate(fits['ID'][:max_stations]):
            rows = code == int(np.searchsorted(self.ids, sid))
            t = t_all[rows]
            tt = np.linspace(t.min(), t.max(), 400)
            t_ref_yr = fits['fit_epoch_yr'][k]
            curve = (fits['mean'][k] + fits['trend_per_year'][k] * (tt - t_ref_yr)
                     + fits['annual_amplitude'][k]
                     * np.sin(2 * np.pi * (tt - t_ref_yr) + fits['annual_phase'][k])
                     + fits['semiannual_amplitude'][k]
                     * np.sin(4 * np.pi * (tt - t_ref_yr) + fits['semiannual_phase'][k]))
            panels.append((sid, t, col[rows], tt, curve))
        return draw_figure(self, 'phaseamp', fname, panels=panels)


def host_table(frame: dict) -> dict:
    """A table of tensors and arrays as host numpy columns (``utils.table``)."""
    return {k: _host(v) for k, v in frame.items()}


def create_parser() -> argparse.ArgumentParser:
    """The raiderStats argument parser (the JAX package's flags, letter for
    letter)."""
    p = argparse.ArgumentParser(
        description='Statistical analyses of GNSS/model zenith delay files',
    )
    p.add_argument('-f', '--file', dest='fname', required=True,
                   help='Combined delay CSV (e.g. UNRcombinedGPS_ztd.csv)')
    p.add_argument('-c', '--column_name', dest='col_name', default='ZTD')
    p.add_argument('-u', '--unit', default='m', choices=['m', 'cm', 'mm'])
    p.add_argument('-w', '--workdir', default='./')
    p.add_argument('-b', '--bounding_box', dest='bounding_box', default=None,
                   help='"S N W E"')
    p.add_argument('-sp', '--spacing', type=float, default=1.0)
    p.add_argument('-ti', '--timeinterval', default=None,
                   help='"YYYY-MM-DD YYYY-MM-DD"')
    p.add_argument('-si', '--seasonalinterval', default=None, help='"MM MM"')
    p.add_argument('-oe', '--obs_errlimit', type=float, default=float('inf'))
    p.add_argument('-min_span', '--min_span', nargs=2, type=float, default=[2, 0.6],
                   help='min [years, fraction of daily coverage] for seasonal fits')
    p.add_argument('-period_limit', '--period_limit', type=float, default=0.0)
    # plot formatting
    p.add_argument('-figdpi', '--figdpi', type=int, default=100)
    p.add_argument('-title', '--user_title', default=None)
    p.add_argument('-fmt', '--plot_format', default='png')
    p.add_argument('-cb', '--color_bounds', default=None, help='"lower upper"')
    p.add_argument('-cp', '--colorpercentile', nargs=2, type=float, default=[25, 95])
    p.add_argument('-cm', '--colormap', default='viridis')
    p.add_argument('-dt', '--densitythreshold', type=int, default=10)
    p.add_argument('-sg', '--stationsongrids', action='store_true')
    p.add_argument('-dg', '--drawgridlines', action='store_true')
    p.add_argument('-tl', '--time_lines', action='store_true')
    p.add_argument('-plotall', '--plotall', action='store_true',
                   help='generate all supported plots')
    # station scatter plots
    p.add_argument('-station_distribution', '--station_distribution', action='store_true')
    p.add_argument('-station_delay_mean', '--station_delay_mean', action='store_true')
    p.add_argument('-station_delay_median', '--station_delay_median', action='store_true')
    p.add_argument('-station_delay_stdev', '--station_delay_stdev', action='store_true')
    p.add_argument('-station_seasonal_phase', '--station_seasonal_phase', action='store_true')
    p.add_argument('-phaseamp_per_station', '--phaseamp_per_station', action='store_true')
    # gridded plots
    p.add_argument('-grid_heatmap', '--grid_heatmap', action='store_true')
    p.add_argument('-grid_delay_mean', '--grid_delay_mean', action='store_true')
    p.add_argument('-grid_delay_median', '--grid_delay_median', action='store_true')
    p.add_argument('-grid_delay_stdev', '--grid_delay_stdev', action='store_true')
    p.add_argument('-grid_delay_absolute_mean', '--grid_delay_absolute_mean', action='store_true')
    p.add_argument('-grid_delay_absolute_median', '--grid_delay_absolute_median',
                   action='store_true')
    p.add_argument('-grid_delay_absolute_stdev', '--grid_delay_absolute_stdev',
                   action='store_true')
    p.add_argument('-grid_seasonal_amplitude', '--grid_seasonal_amplitude', action='store_true')
    p.add_argument('-grid_seasonal_phase', '--grid_seasonal_phase', action='store_true')
    p.add_argument('-grid_seasonal_absolute_phase', '--grid_seasonal_absolute_phase',
                   action='store_true')
    p.add_argument('-grid_to_raster', '--grid_to_raster', action='store_true')
    # variograms
    p.add_argument('-variogramplot', '--variogramplot', action='store_true')
    p.add_argument('-binnedvariogram', '--binnedvariogram', action='store_true')
    p.add_argument('-variogram_per_timeslice', '--variogram_per_timeslice', action='store_true')
    p.add_argument('-variogram_errlimit', '--variogram_errlimit', type=float,
                   default=float('inf'))
    p.add_argument('--variogram_model', default='exponential',
                   choices=['exponential', 'gaussian'])
    p.add_argument('-verbose', '--verbose', action='store_true',
                   help='Run in verbose (debug) mode. Default False')
    # accepted for CLI compatibility; the analyses are batched on the
    # device, so the value is ignored ('all' as in the reference)
    p.add_argument('--cpus', default='all',
                   help='Ignored (kept for reference-CLI compatibility): '
                        'the analyses are vectorized, not multiprocessed.')
    return p


_PLOTALL = ('station_distribution', 'station_delay_mean', 'station_delay_median',
            'station_delay_stdev', 'station_seasonal_phase', 'grid_heatmap',
            'grid_delay_mean', 'grid_delay_median', 'grid_delay_stdev',
            'grid_delay_absolute_mean', 'grid_delay_absolute_median',
            'grid_delay_absolute_stdev', 'grid_seasonal_amplitude',
            'grid_seasonal_phase', 'variogramplot')


def stats_analyses(iargs: Optional[List[str]] = None, device='cuda') -> dict:
    """raiderStats: the analyses the flags ask for, on ``device``.

    Writes every product that is not a figure first (seasonal_fits.csv,
    the rasters, variogram_sill.npy and variogram_range.npy), then the
    figures. Returns what it computed: {'stats', 'grids' (tag -> tensor),
    'seasonal', 'variogram', 'gridded_variogram' ((sill, range)),
    'timeslices', 'files', 'figures', 'seconds' (per step)}."""
    p = create_parser()
    args = p.parse_args(iargs)
    if args.verbose:
        import logging

        logger.setLevel(logging.DEBUG)

    bbox = [float(v) for v in args.bounding_box.split()] if args.bounding_box else None
    ti = args.timeinterval.split() if args.timeinterval else None
    si = [int(v) for v in args.seasonalinterval.split()] if args.seasonalinterval else None
    cb = [float(v) for v in args.color_bounds.split()] if args.color_bounds else None
    if args.plotall:
        for name in _PLOTALL:
            setattr(args, name, True)

    stats = RaiderStats(
        args.fname, col_name=args.col_name, unit=args.unit, workdir=args.workdir,
        bbox=bbox, spacing=args.spacing, timeinterval=ti, seasonalinterval=si,
        obs_errlimit=args.obs_errlimit, min_span=tuple(args.min_span),
        period_limit=args.period_limit, device=device,
        plot_fmt={
            'figdpi': args.figdpi, 'user_title': args.user_title,
            'plot_format': args.plot_format, 'cbounds': cb,
            'colorpercentile': tuple(args.colorpercentile),
            'colormap': args.colormap, 'densitythreshold': args.densitythreshold,
            'stationsongrids': args.stationsongrids,
            'drawgridlines': args.drawgridlines, 'time_lines': args.time_lines,
        },
    )
    rec = dict(stats=stats, grids={}, seasonal=None, variogram=None, gridded_variogram=None,
               timeslices=None, files=[], figures=[], seconds=dict(stats.seconds))
    figures = []
    col = args.col_name

    @contextmanager
    def step(name):
        t0 = time.perf_counter()
        yield
        if stats.device.type == 'cuda':
            torch.cuda.synchronize(stats.device)
        rec['seconds'][name] = rec['seconds'].get(name, 0.0) + time.perf_counter() - t0

    def wrote(path):
        rec['files'].append(path)
        logger.info('Wrote %s', path)

    with step('station_means'):
        sm = stats.station_means()
    if args.station_distribution:
        figures.append(lambda: stats.plot_station_distribution())
    for flag, key, what in ((args.station_delay_mean, 'mean', 'mean'),
                            (args.station_delay_median, 'median', 'median'),
                            (args.station_delay_stdev, 'std', 'stdev')):
        if flag:
            figures.append(lambda key=key, what=what: stats.plot_station_scatter(
                sm[key], f'{what} {col} [m]', f'station_delay_{what}.png'))

    seasonal = None
    if (args.station_seasonal_phase or args.grid_seasonal_amplitude
            or args.grid_seasonal_phase or args.grid_seasonal_absolute_phase):
        with step('seasonal_fit'):
            seasonal = stats.seasonal_amplitude_phase(apply_span_filter=True)
            rec['seasonal'] = seasonal
            out_csv = os.path.join(args.workdir, 'seasonal_fits.csv')
            table.to_csv(host_table(seasonal), out_csv)
        wrote(out_csv)
    if args.station_seasonal_phase and seasonal is not None and len(seasonal['ID']):
        phase = np.full(stats.ids.size, np.nan)
        phase[np.searchsorted(stats.ids, seasonal['ID'])] = _host(seasonal['annual_phase'])
        figures.append(lambda: stats.plot_station_scatter(phase, 'annual phase [rad]',
                                                          'station_seasonal_phase.png'))
    if args.phaseamp_per_station:
        figures.append(lambda: stats.plot_phaseamp_per_station())

    grids = []
    with step('grids'):
        if args.grid_heatmap:
            grids.append(('grid_heatmap', stats.grid_map('count'), 'station count', 'count'))
        for stat, flag, absolute in (
            ('mean', args.grid_delay_mean, False),
            ('median', args.grid_delay_median, False),
            ('stdev', args.grid_delay_stdev, False),
            ('mean', args.grid_delay_absolute_mean, True),
            ('median', args.grid_delay_absolute_median, True),
            ('stdev', args.grid_delay_absolute_stdev, True),
        ):
            if flag:
                tag = f"grid_{'absolute_' if absolute else ''}{stat}"
                grids.append((tag, stats.grid_map_masked(stat, absolute=absolute), None, stat))
    if seasonal is not None and len(seasonal['ID']):
        with step('seasonal_grids'):
            for key, flag, tag in (
                ('annual_amplitude', args.grid_seasonal_amplitude, 'grid_seasonal_amplitude'),
                ('annual_phase', args.grid_seasonal_phase, 'grid_seasonal_phase'),
                ('annual_phase', args.grid_seasonal_absolute_phase,
                 'grid_seasonal_absolute_phase'),
            ):
                if not flag:
                    continue
                if 'absolute' in tag:
                    # observation-weighted: the station's value on every one
                    # of its rows (the station-mean cell average is the
                    # non-absolute variant)
                    lat, lon, val = stats.absolute_phase_rows(seasonal, key)
                else:
                    lat, lon, val = seasonal['Lat'], seasonal['Lon'], seasonal[key]
                grids.append((tag, grid_statistic(lat, lon, val, stats.lat_edges,
                                                  stats.lon_edges, 'mean'), key, key))
    for tag, g, label, stat in grids:
        rec['grids'][tag] = g
        figures.append(lambda tag=tag, g=g, label=label, stat=stat: stats.plot_grid(
            stat, grid=g, label=label, fname=f'{tag}.png'))
    if args.grid_to_raster:
        for tag, g, _, _ in grids:
            wrote(stats.grid_to_raster(g, f'{tag}.tif'))

    if args.variogramplot or args.binnedvariogram:
        with step('variogram'):
            vg = stats.variogram(args.variogram_model, errlimit=args.variogram_errlimit)
        rec['variogram'] = vg
        logger.info('variogram: sill=%.3e, range=%.3f', vg['sill'], vg['range'])
        figures.append(lambda: stats.draw_variogram(vg))
        with step('gridded_variogram'):
            gsill, grange = stats.gridded_variogram(args.variogram_model)
        rec['gridded_variogram'] = (gsill, grange)
        for name, arr in (('variogram_sill.npy', gsill), ('variogram_range.npy', grange)):
            np.save(os.path.join(args.workdir, name), arr)
            rec['files'].append(os.path.join(args.workdir, name))
        logger.info('Wrote variogram sill/range maps to %s', args.workdir)
    if args.variogram_per_timeslice:
        with step('timeslice_variograms'):
            rec['timeslices'] = stats.timeslice_variograms(args.variogram_model)
        for ts, _, _, _, sill, rng_ in rec['timeslices']:
            logger.info('variogram %s: sill=%.3e range=%.3f', ts, sill, rng_)

    for fig in figures:
        path = fig()
        rec['figures'].append(path)
        logger.info('Wrote %s', path)
    return rec


if __name__ == '__main__':
    stats_analyses()
