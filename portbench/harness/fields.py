"""Seeded raw HRRR fields on the device, and the fetcher's cut of them.

A frozen copy of the field arithmetic of the port's synthetic raw-file
writer (``raider_tpu_torch/scripts/raw_weather.py``: ``standard_atmosphere``,
``terrain``, ``_levels`` and ``_projected_grid`` as ``write_hrrr`` uses
them), kept here so that the benchmark's inputs do not move when the port
changes. Nothing is written to disk: the fields stay on the device in the
precision of the raw file (float32), and the grid's lat/lon come from the
benchmark's own Lambert conformal projection.

Each date draws its own atmosphere over one seeded terrain, and scales its
humidity, pressure and temperature by factors drawn from the seed (as the
port's smoke run does for its epochs), so that two dates differ everywhere.
"""

import numpy as np
import torch

from portbench.reference.hrrr import LambertConformal

P0 = 101325.0


def sub_seed(seed: int, *key: int) -> int:
    """A 63-bit seed for one use of ``seed`` (any non-negative integer)."""
    return int(np.random.SeedSequence([int(seed), *key]).generate_state(1, np.uint64)[0] >> 1)


def standard_atmosphere(h, gen):
    t = torch.where(h < 11000.0, 288.15 - 0.0065 * h, 216.65 + 0.001 * (h - 20000.0).clamp_min(0.0))
    p = torch.where(h < 11000.0, P0 * (1.0 - 2.25577e-5 * h.clamp_max(11000.0)) ** 5.25588,
                    22632.0 * torch.exp(-(h - 11000.0) / 6341.6))
    q = 0.015 * torch.exp(-h.clamp_min(0.0) / 2000.0)
    t = t + 0.5 * torch.randn(h.shape, generator=gen, device=h.device, dtype=h.dtype)
    p = p * (1.0 + 1e-3 * torch.randn(h.shape, generator=gen, device=h.device, dtype=h.dtype))
    q = q * (0.7 + 0.4 * torch.rand(h.shape, generator=gen, device=h.device, dtype=h.dtype))
    return t, p, q


def terrain(lat, lon, gen):
    t = (800.0 + 600.0 * torch.sin(torch.deg2rad(lat) * 40.0) * torch.cos(torch.deg2rad(lon) * 30.0)
         + 50.0 * torch.randn(lat.shape, generator=gen, device=lat.device, dtype=lat.dtype))
    return t.clamp_min(0.0)


def levels(ground, nz: int, top: float):
    sigma = torch.linspace(0.0, 1.0, nz, dtype=ground.dtype, device=ground.device) ** 1.5
    return ground[None] + (top - ground[None]) * sigma[:, None, None]


def grid_axes(grid: dict, device):
    """(projection, xs, ys (host float64), lat, lon (ny, nx) on ``device``) of
    a grid given by its first point, spacing and size."""
    proj = LambertConformal(grid['crs_cf'])
    lat0 = torch.tensor(grid['first_point_lat'], dtype=torch.float64)
    lon0 = torch.tensor(grid['first_point_lon'], dtype=torch.float64)
    x0, y0 = (float(v) for v in proj.forward(lat0, lon0))
    xs = x0 + grid['spacing_m'] * np.arange(grid['nx'], dtype=np.float64)
    ys = y0 + grid['spacing_m'] * np.arange(grid['ny'], dtype=np.float64)
    yy, xx = torch.meshgrid(torch.as_tensor(ys, device=device), torch.as_tensor(xs, device=device),
                            indexing='ij')
    lat, lon = proj.inverse(xx, yy)
    return proj, xs, ys, lat, lon


def date_scales(seed: int, date: int) -> dict:
    rng = np.random.default_rng(sub_seed(seed, 2, date))
    return dict(q=float(rng.uniform(0.8, 1.2)), pres=float(rng.uniform(0.995, 1.005)),
                t=float(rng.uniform(0.99, 1.01)))


def raw_fields(grid: dict, seed: int, date: int, device) -> dict:
    """One date's raw fields on the whole grid: host ``xs``, ``ys``; (ny, nx)
    float64 ``lat`` and ``lon`` (-180..180) and (nz, ny, nx) float32 ``t``,
    ``q``, ``pres`` and geopotential height ``z`` (bottom up) on ``device``."""
    device = torch.device(device)
    _, xs, ys, lat, lon = grid_axes(grid, device)
    gen = torch.Generator(device=device)
    gen.manual_seed(sub_seed(seed, 1))
    h = levels(terrain(lat, lon, gen), grid['native_levels'], grid['top_m'])
    gen.manual_seed(sub_seed(seed, 3, date))
    t, p, q = standard_atmosphere(h, gen)
    s = date_scales(seed, date)
    out = dict(xs=xs, ys=ys, lat=lat, lon=lon, z=h.float())
    del h
    out.update(t=(t * s['t']).float(), pres=(p * s['pres']).float(), q=(q * s['q']).float())
    return out


def fetcher_cut(ll_bounds, lat, lon) -> tuple:
    """(y0, y1, x0, x1): the rows and columns HRRR's fetcher keeps for the
    SNWE bounds (a copy of ``wx/hrrr.py::get_bounds_indices`` on the grid's
    0-360 longitudes, and its slices, whose ends are exclusive)."""
    s, n, w, e = (float(v) for v in ll_bounds)
    w, e = w % 360.0, e % 360.0
    lon = torch.remainder(lon, 360.0)
    m = (s <= lat) & (n >= lat) & (w <= lon) & (e >= lon)
    if not bool(m.any()):
        raise ValueError(f'the bounds {ll_bounds} miss the grid')
    rows = torch.nonzero(m.any(1)).flatten()
    cols = torch.nonzero(m.any(0)).flatten()
    return int(rows[0]), int(rows[-1]), int(cols[0]), int(cols[-1])


def cut(fields: dict, window) -> dict:
    y0, y1, x0, x1 = window
    out = dict(xs=fields['xs'][x0:x1], ys=fields['ys'][y0:y1])
    for k in ('lat', 'lon'):
        out[k] = fields[k][y0:y1, x0:x1].contiguous()
    for k in ('t', 'q', 'pres', 'z'):
        out[k] = fields[k][:, y0:y1, x0:x1].contiguous()
    return out
