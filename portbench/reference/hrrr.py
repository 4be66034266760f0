"""Plain reference of a delay request on a processed HRRR model.

Written from the semantics that RAiDER's HRRR path states, independently
of the program under test: it imports numpy and torch only. Everything is
float64; ``store`` (the control) rounds each stored field (the processed
t, p, e, both refractivities and both zenith totals) to a lower precision
and back, the step a port would be tempted to take.

  * Processing a column: geopotential to ellipsoidal height
    (h = zg Re / (g(lat)/g0 Re - zg)), the vapour pressure
    e = w R_v (p - svp(t)) / R_d with w = q / (1 - q), linear
    interpolation of t, p and e onto the model's fixed height ladder (NaN
    outside the column), the backward fill below the column and the
    fill above it (p, e: 0; t: 1e16), N_wet = k2 e/t + k3 e/t^2 and
    N_hydro = k1 p/t, and the zenith totals from each ladder height to the
    top by the trapezoid rule.
  * A raytraced delay: the pixel at (lat, lon, ht) in WGS84 ECEF, the
    satellite at zero Doppler on the analytic circular orbit, and
    1e-6 times the integral of the trilinear interpolant of N along the
    straight ray, from where the ray crosses the first contributing level
    (RAiDER's level rules: nothing below the ladder's bottom, intervals
    thinner than 1 m dropped) up to ``zref``; heights are exact geodetic
    heights of the ray's points, the horizontal position their Lambert
    conformal coordinates, and the integral a trapezoid over points that
    crowd toward the ground.
"""

import math

import numpy as np
import torch

WGS84_A = 6378137.0
WGS84_F = 1.0 / 298.257223563
WGS84_E2 = WGS84_F * (2.0 - WGS84_F)
R_EARTH_MAX = 6378137.0
R_EARTH_MIN = 6356752.0
G0 = 9.80665
G1 = 9.80616
R_V = 461.524
R_D = 287.06
F64 = torch.float64


def rounded(a, store):
    """``a`` stored in ``store`` (None: float64) and read back as float64."""
    return a if store is None else a.to(store).to(F64)


# ---------------------------------------------------------------- geodesy
def geodetic_to_ecef(lat, lon, h):
    lat, lon = torch.deg2rad(lat), torch.deg2rad(lon)
    n = WGS84_A / torch.sqrt(1.0 - WGS84_E2 * torch.sin(lat) ** 2)
    return torch.stack([(n + h) * torch.cos(lat) * torch.cos(lon),
                        (n + h) * torch.cos(lat) * torch.sin(lon),
                        (n * (1.0 - WGS84_E2) + h) * torch.sin(lat)], -1)


def ecef_to_geodetic(xyz):
    """(lat, lon) in degrees and height: Bowring's start and three fixed-point
    refinements of the latitude (converged to well below a micrometre)."""
    x, y, z = xyz[..., 0], xyz[..., 1], xyz[..., 2]
    b = WGS84_A * math.sqrt(1.0 - WGS84_E2)
    ep2 = WGS84_E2 / (1.0 - WGS84_E2)
    p = torch.hypot(x, y)
    th = torch.atan2(z * WGS84_A, p * b)
    lat = torch.atan2(z + ep2 * b * torch.sin(th) ** 3, p - WGS84_E2 * WGS84_A * torch.cos(th) ** 3)
    for _ in range(3):
        n = WGS84_A / torch.sqrt(1.0 - WGS84_E2 * torch.sin(lat) ** 2)
        h = p / torch.cos(lat) - n
        lat = torch.atan2(z, p * (1.0 - WGS84_E2 * n / (n + h)))
    n = WGS84_A / torch.sqrt(1.0 - WGS84_E2 * torch.sin(lat) ** 2)
    h = p / torch.cos(lat) - n
    return torch.rad2deg(lat), torch.rad2deg(torch.atan2(y, x)), h


def up_vector(lat, lon):
    lat, lon = torch.deg2rad(lat), torch.deg2rad(lon)
    return torch.stack([torch.cos(lat) * torch.cos(lon), torch.cos(lat) * torch.sin(lon),
                        torch.sin(lat)], -1)


class LambertConformal:
    """Lambert conformal conic on a sphere (Snyder, Map Projections, 1987,
    eqs. 15-1 to 15-11), from CF grid-mapping attributes."""

    def __init__(self, cf: dict):
        par = cf['standard_parallel']
        p1, p2 = (par, par) if np.isscalar(par) else (par[0], par[-1])
        self.r = float(cf['earth_radius'])
        phi1, phi2 = math.radians(p1), math.radians(p2)
        self.lon0 = float(cf['longitude_of_central_meridian'])
        self.fe, self.fn = float(cf.get('false_easting', 0.0)), float(cf.get('false_northing', 0.0))

        def t(phi):
            return math.tan(math.pi / 4.0 + phi / 2.0)

        self.n = (math.sin(phi1) if abs(phi1 - phi2) < 1e-12 else
                  math.log(math.cos(phi1) / math.cos(phi2)) / math.log(t(phi2) / t(phi1)))
        self.f = math.cos(phi1) * t(phi1) ** self.n / self.n
        self.rho0 = self.r * self.f / t(math.radians(cf['latitude_of_projection_origin'])) ** self.n

    def forward(self, lat, lon):
        dlon = torch.remainder(lon - self.lon0 + 180.0, 360.0) - 180.0
        rho = self.r * self.f / torch.tan(math.pi / 4.0 + torch.deg2rad(lat) / 2.0) ** self.n
        theta = self.n * torch.deg2rad(dlon)
        return rho * torch.sin(theta) + self.fe, self.rho0 - rho * torch.cos(theta) + self.fn

    def inverse(self, x, y):
        x, y = x - self.fe, self.rho0 - (y - self.fn)
        rho = math.copysign(1.0, self.n) * torch.hypot(x, y)
        theta = torch.atan2(math.copysign(1.0, self.n) * x, math.copysign(1.0, self.n) * y)
        lat = 2.0 * torch.atan((self.r * self.f / rho) ** (1.0 / self.n)) - math.pi / 2.0
        lon = torch.remainder(self.lon0 + torch.rad2deg(theta / self.n) + 180.0, 360.0) - 180.0
        return torch.rad2deg(lat), lon


# ------------------------------------------------------------- processing
def geo_to_ht(lat, zg):
    """Ellipsoidal height of geopotential height ``zg`` at latitude ``lat``."""
    rad = torch.deg2rad(lat)
    c2 = torch.cos(2.0 * rad)
    g_ll = G1 * (1.0 - 0.002637 * c2 + 0.0000059 * c2 ** 2)
    re = torch.sqrt(1.0 / (torch.cos(rad) ** 2 / R_EARTH_MAX ** 2
                           + torch.sin(rad) ** 2 / R_EARTH_MIN ** 2))
    return zg * re / (g_ll / G0 * re - zg)


def saturation_vapour_pressure(t):
    """Buck over water above 0 C, Alduchov-Eskridge over ice below -23 C,
    the quadratic blend between (Pa)."""
    tc = t - 273.15
    w = (t - 250.15) / 23.0
    water = 6.1121 * torch.exp(17.502 * tc / (240.97 + tc))
    ice = 6.1121 * torch.exp(22.587 * tc / (273.86 + tc))
    svp = torch.where(t > 273.15, water, torch.where(t < 250.15, ice, ice + (water - ice) * w ** 2))
    return 100.0 * svp


def _onto_ladder(z_cols, f_cols, ladder):
    """Linear interpolation of (nz, M) column values at heights ``z_cols``
    onto ``ladder`` (L,), NaN outside each column's span."""
    zc = z_cols.T.contiguous()
    q = ladder[None, :].expand(zc.shape[0], -1).contiguous()
    i = torch.searchsorted(zc, q, right=True).clamp(1, zc.shape[1] - 1)
    z0, z1 = torch.gather(zc, 1, i - 1), torch.gather(zc, 1, i)
    v0, v1 = torch.gather(f_cols.T, 1, i - 1), torch.gather(f_cols.T, 1, i)
    out = v0 + (q - z0) / (z1 - z0) * (v1 - v0)
    out = torch.where((q < zc[:, :1]) | (q > zc[:, -1:]), torch.nan, out)
    return out.T


def _fill(a, above):
    """NaNs below the first valid value take it; those above the last valid
    value take ``above``."""
    valid = ~torch.isnan(a)
    idx = torch.arange(a.shape[0], device=a.device)[:, None].expand(a.shape)
    first = torch.where(valid, idx, a.shape[0]).amin(0)
    last = torch.where(valid, idx, -1).amax(0)
    lowest = torch.gather(a, 0, first.clamp_max(a.shape[0] - 1)[None])[0]
    out = torch.where((idx < first) & (first < a.shape[0]), lowest, a)
    return torch.where(idx > last, above, out)


def process_columns(raw_cols: dict, ladder, k: dict, store=None) -> dict:
    """The processed model on a set of columns: ``raw_cols`` holds (nz, M)
    native ``t``, ``q``, ``pres`` and geopotential height ``z`` (bottom
    up) and the (M,) latitudes ``lat``; returns (L, M) float64 ``t``,
    ``p``, ``e``, ``wet``, ``hydro``, ``wet_total``, ``hydro_total``."""
    t, q, p, zg = (raw_cols[n].to(F64) for n in ('t', 'q', 'pres', 'z'))
    lat = raw_cols['lat'].to(F64)
    ladder = torch.as_tensor(np.asarray(ladder, dtype=np.float64), device=t.device)
    zs = geo_to_ht(lat[None], zg)
    e = q / (1.0 - q) * R_V * (p - saturation_vapour_pressure(t)) / R_D
    out = {}
    for name, f, above in (('t', t, 1e16), ('p', p, 0.0), ('e', e, 0.0)):
        out[name] = rounded(_fill(_onto_ladder(zs, f, ladder), above), store)
    t, p, e = out['t'], out['p'], out['e']
    out['wet'] = rounded(k['k2'] * e / t + k['k3'] * e / t ** 2, store)
    out['hydro'] = rounded(k['k1'] * p / t, store)
    dz = (ladder[1:] - ladder[:-1])[:, None]
    for name in ('wet', 'hydro'):
        # the refractivities the totals integrate are B1's own, from t, p, e
        n = (k['k2'] * e / t + k['k3'] * e / t ** 2) if name == 'wet' else k['k1'] * p / t
        layer = 0.5e-6 * (n[:-1] + n[1:]) * dz
        tot = torch.flip(torch.cumsum(torch.flip(layer, (0,)), 0), (0,))
        out[name + '_total'] = rounded(torch.cat([tot, torch.zeros_like(tot[:1])]), store)
    return out


# ------------------------------------------------------------------- rays
def level_chain(ladder, ht: float, zref: float):
    """The heights at which a ray from ``ht`` crosses a level boundary, by
    RAiDER's level rules (the top level nudged down 0.01 m; levels below
    ``ht`` or above ``zref`` dropped, the ends clamped to them, intervals
    thinner than 1 m dropped), or None when no level contributes."""
    ladder = np.asarray(ladder, dtype=np.float64)
    kept = []
    for lo, hi in zip(ladder[:-1], ladder[1:]):
        if hi == ladder[-1]:
            hi = hi - 0.01
        if hi < ht or lo >= zref:
            continue
        lo, hi = max(lo, ht), min(hi, zref)
        if abs(hi - lo) >= 1.0:
            kept.append((lo, hi))
    return [kept[0][0]] + [hi for _, hi in kept] if kept else None


def chain_ends(ladder, ht: float, zref: float):
    """(lowest, highest) height a ray from ``ht`` integrates over, or None."""
    chain = level_chain(ladder, ht, zref)
    return (chain[0], chain[-1]) if chain else None


def zero_doppler_satellite(xyz, orbit: dict):
    """The satellite's ECEF position at zero Doppler for each target, on the
    circular orbit ``orbit`` (radius_m, period_s, track_lon_deg,
    ref_lat_deg, span_s): its plane holds the z axis, so the zero-Doppler
    angle is atan2(z, x cos(lon) + y sin(lon)). NaN off the orbit's span."""
    lon = math.radians(orbit['track_lon_deg'])
    ang = torch.atan2(xyz[..., 2], xyz[..., 0] * math.cos(lon) + xyz[..., 1] * math.sin(lon))
    t = (ang - math.radians(orbit['ref_lat_deg'])) * orbit['period_s'] / (2.0 * math.pi)
    r = orbit['radius_m']
    sat = torch.stack([r * torch.cos(ang) * math.cos(lon), r * torch.cos(ang) * math.sin(lon),
                       r * torch.sin(ang)], -1)
    return torch.where((t.abs() <= orbit['span_s'])[..., None], sat, torch.nan)


def crossing(xyz, look, height, iters: int = 8):
    """Distance along each ray to where its geodetic height is ``height``
    (a scalar or per ray), by Newton on the exact height."""
    lat, lon, h = ecef_to_geodetic(xyz)
    s = (height - h) / (look * up_vector(lat, lon)).sum(-1)
    for _ in range(iters):
        lat, lon, h = ecef_to_geodetic(xyz + s[..., None] * look)
        s = s + (height - h) / (look * up_vector(lat, lon)).sum(-1)
    return s


def ray_geometry(lat, lon, ht: float, orbit: dict, ladder, zref: float):
    """(pixel ECEF (N, 3), unit look vectors (N, 3), start and end distances
    (N,)) of the rays from (lat, lon) at ``ht``, or None."""
    ends = chain_ends(ladder, ht, zref)
    if ends is None:
        return None
    xyz = geodetic_to_ecef(lat, lon, torch.full_like(lat, float(ht)))
    sat = zero_doppler_satellite(xyz, orbit)
    look = (sat - xyz) / torch.linalg.norm(sat - xyz, dim=-1, keepdim=True)
    return xyz, look, crossing(xyz, look, ends[0]), crossing(xyz, look, ends[1])


class Grid:
    """A model grid: regular Lambert conformal axes ``xs``, ``ys`` (metres,
    ascending) and the height ladder ``zs``."""

    def __init__(self, xs, ys, zs, proj: LambertConformal):
        self.xs, self.ys, self.zs = (np.asarray(a, dtype=np.float64) for a in (xs, ys, zs))
        self.proj = proj
        self.dx = (self.xs[-1] - self.xs[0]) / (self.xs.size - 1)
        self.dy = (self.ys[-1] - self.ys[0]) / (self.ys.size - 1)


def trilinear(cube, zs, z, fy, fx):
    """``cube`` (L, wy, wx) at heights ``z`` and fractional row and column
    positions ``fy``, ``fx`` of the cube's window; NaN off the window."""
    nz, ny, nx = cube.shape
    zt = torch.as_tensor(zs, device=cube.device)
    iz = (torch.searchsorted(zt, z.contiguous(), right=True) - 1).clamp(0, nz - 2)
    wz = (z - zt[iz]) / (zt[iz + 1] - zt[iz])
    iy = torch.floor(fy).clamp(0, ny - 2).long()
    ix = torch.floor(fx).clamp(0, nx - 2).long()
    wy, wx = fy - iy, fx - ix
    flat = cube.reshape(-1)
    out = 0.0
    for dz, az in ((0, 1.0 - wz), (1, wz)):
        for dy, ay in ((0, 1.0 - wy), (1, wy)):
            for dxx, ax in ((0, 1.0 - wx), (1, wx)):
                out = out + az * ay * ax * flat[((iz + dz) * ny + iy + dy) * nx + ix + dxx]
    off = (fy < 0) | (fy > ny - 1) | (fx < 0) | (fx > nx - 1)
    return torch.where(off, torch.nan, out)


def ray_points(xyz, look, s0, s1, grid: Grid, n_points: int):
    """Points along each ray, crowding toward the ground as u^2: (heights,
    model rows, model columns, trapezoid weights), each (N, n_points)."""
    u = torch.linspace(0.0, 1.0, n_points, dtype=F64, device=xyz.device) ** 2
    s = s0[:, None] + (s1 - s0)[:, None] * u[None]
    lat, lon, h = ecef_to_geodetic(xyz[:, None] + s[..., None] * look[:, None])
    x, y = grid.proj.forward(lat, lon)
    w = torch.zeros_like(s)
    ds = s[:, 1:] - s[:, :-1]
    w[:, 1:] += 0.5 * ds
    w[:, :-1] += 0.5 * ds
    return h.clamp(float(grid.zs[0]), float(grid.zs[-1])), (y - grid.ys[0]) / grid.dy, \
        (x - grid.xs[0]) / grid.dx, w


def window_of(fy, fx, grid: Grid, margin: int = 2):
    """Row and column bounds of the model cells under the points."""
    fin = torch.isfinite(fy) & torch.isfinite(fx)
    y0 = max(int(torch.floor(fy[fin].min())) - margin, 0)
    y1 = min(int(torch.ceil(fy[fin].max())) + margin + 1, grid.ys.size)
    x0 = max(int(torch.floor(fx[fin].min())) - margin, 0)
    x1 = min(int(torch.ceil(fx[fin].max())) + margin + 1, grid.xs.size)
    return y0, y1, x0, x1


def ray_delays(lat, lon, ht: float, orbit: dict, grid: Grid, columns, zref: float,
               n_points: int = 3072, block: int = 512):
    """Raytraced (wet, hydro) delays (N,) of the pixels (lat, lon) at height
    ``ht``. ``columns(y0, y1, x0, x1)`` returns the processed (wet, hydro)
    refractivity cubes (L, y1 - y0, x1 - x0) of that window of the grid."""
    geom = ray_geometry(lat, lon, ht, orbit, grid.zs, zref)
    if geom is None:
        return torch.zeros_like(lat), torch.zeros_like(lat)
    xyz, look, s0, s1 = geom
    wet, hyd = [], []
    for b in range(0, lat.numel(), block):
        sl = slice(b, b + block)
        z, fy, fx, w = ray_points(xyz[sl], look[sl], s0[sl], s1[sl], grid, n_points)
        y0, y1, x0, x1 = window_of(fy, fx, grid)
        cw, ch = columns(y0, y1, x0, x1)
        for cube, out in ((cw, wet), (ch, hyd)):
            out.append(1e-6 * (trilinear(cube, grid.zs, z, fy - y0, fx - x0) * w).sum(1))
    return torch.cat(wet), torch.cat(hyd)
