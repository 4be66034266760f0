#!/usr/bin/env python3
"""Smoke run of the PyTorch port (``raider_tpu_torch``) on one CUDA GPU.

    python3 chip_smoke.py

Phases, each printing one line; any failure exits non-zero:

  0. device: needs CUDA; prints the card (nvidia-smi name, power limit),
     the torch and CUDA versions and both TF32 flags (set off).
  1. build: compiles the CUDA kernels in raider_tpu_torch/csrc/ with nvcc.
  2. kernels vs their plain-torch twins on the card, at the main path's
     shapes: ZTD totals (B1) on seeded 51x400x400 cubes in both layouts it
     reads ((z, y, x) rows, and the weather model's (y, x, z) columns) and
     on columns of the HRRR CONUS grid 51x1059x1799 (cubes drawn on the
     card), bit for bit (B1's ms is its call's CUDA-event time, as for
     every kernel, and its device_ms the kernel's time in a torch.profiler
     trace: host work is most of a call); the brick integrate (B2) on a
     51x400x400 table with ~1.2M synthetic slant rays.
  3. main path, through the user entry points: a synthetic HRRR-sized
     weather model (50 native levels, 400x400) processed by
     ``WeatherModel.load(device='cuda')``, then ``tropo_delay`` for a zenith
     and a raytraced request over a ~1.2M-pixel grid at three heights (each
     step of ``load`` timed). The
     kernel launch counts of this phase must be >= 1, the cubes mostly
     finite, and a 64x64 sub-grid of the raytraced 0 m slice must match a
     plain-torch recomputation; then B2 is timed on the whole 0 m slice's
     coherent pixel rays, beside phase 2's incoherent ones, and the model's
     ``_get_ztd`` (B1 on its own t, p, e) alone.
  4. the windowed path: the window ablation's scene (a 50x400x400 cube,
     1000x1000 coherent rays) through ``integrate_rays_windowed`` (kernel
     B3), which must take the batch; then B3 against its twin on the same
     operands (bit for bit, equal NaN masks) and against the brick path (B2)
     on the same rays; B3's launch (threads, shared bytes, ring slots,
     stages) and its ptxas registers and spills.
  5. the 16-bit probes: ``probe_f16.run`` (kernel S4 for bf16, f16 and int16,
     kernel S5, each against its twin, and the row-gather timings).
  6. the kernel profile: ``kernel_profile.run`` on its own scene (50x400x400
     random cubes, 1M incoherent rays), spec (7,3,3,6) through prod, tensor,
     pallas (K1), pallas2 (K2), prodmerged (K3), prodpallas (B2) and prodi16
     (K4), then split, then spec (8,4,4,24) through pallas2 and prodpallas
     (24 samples a group); each passes the script's 4096-ray check. Then
     K1-K4 against their twins on all rays (K1 and K3 bit for bit), K4 also
     against B2.
  7. large cubes through ``integrate_rays`` with the mode ``pack_mode_for``
     picks: bench's midcube (50x640x640, brick_i16, kernel K4) against
     pack16, and the HRRR CONUS grid (50x1059x1799, pack16_i16) against
     pack4, on 1M rays each.
  8. weather models from their raw files (netCDF-3, written by
     ``scripts/raw_weather.py`` in each reader's format; the card's machine
     has no h5py), through the user's path ``get_wm_by_name`` -> ``load`` ->
     ``to_dataset`` -> ``tropo_delay``: (a) HRRR CONUS at its native size
     (50 levels x 1059 x 1799 on its Lambert conformal grid), each step of
     ``load`` timed in a second load, B1 bit for bit against its twin on the model's fields;
     (b) a zenith and a raytraced request on that LCC cube over ~1.2M pixels
     of an AOI in Kansas at three heights, seen from an orbit whose ground
     track runs ~300 km west of it, with phase 3's finite-share gates; the
     0 m slice's 64x64 sub-grid against a float64 reference from the same
     geometry that reads neither table (an 8-corner gather of the float64
     cubes at every quadrature point: 1e-5 m, or 1e-4 m for an int16
     table), and a brick mode also against its twin; (c) every other
     family (ERA5, ERA5T, ERAI, HRES, GMAO, MERRA2, NCMR, WRF over a
     20 x 20 deg domain, HRRR-AK on a 400 x 400 cut of its
     polar-stereographic grid) at its native level count: B1 against its
     twin, a zenith request; (d) the LCC, polar stereographic and UTM
     forward and inverse on 2^20 points on the card against the CPU
     (1e-8 m, 1e-10 deg).
  9. point requests on 8a's raw HRRR CONUS file, each through the steps of
     the calc-delays workflow (the AOI buffered by the model's grid, its
     output grid on EPSG:4326, the model's bounds, widened toward the
     sensor for raytracing, a cropped ``load``, ``to_dataset``,
     ``tropo_delay``): (a) a CSV of 2,000 GNSS stations (a few duplicate
     rows) drawn in the LCC grid's interior, zenith on the whole CONUS
     model; (b) ENVI lat/lon/hgt rasters of a Sentinel-1 frame in radar
     coordinates (2048 x 2048, seeded terrain, a few nodata heights) in
     Kansas, raytraced at the model's levels from an ESA EOF orbit file;
     (c) the same frame zenith and projected (``Conventional``) from a
     2-band incidence/heading raster and from the EOF file; (d) a
     3600 x 3600 GeoTIFF DEM (one GLO-30 tile) and a GUNW-style geocube
     (netCDF-3), zenith and raytraced. Gates: finite shares, delay ranges,
     the point step against scipy in float64 (1e-5 m), projected = zenith
     / factor (1e-6 relative), the card's projection factor against the
     CPU's (1e-12), the incidence (20-50 deg), the brick mode and B1 and
     B2 launched.
 10. the calc-delays workflow through the CLI (``cli.__main__.main`` in
     this process, ``--nc_format NETCDF3_64BIT_OFFSET``, ``verbose:
     false``) on run configs written here: (a) a bbox cube over phase 8b's
     Kansas AOI, zenith, at 4 heights, 2 km, on two dates (the prefetch
     worker loads the second); (b) the same bbox raytraced from 9b's EOF;
     (c) 9a's 2,000 stations, zenith, ``center_time`` at 12:45 between the
     12:00 and 13:00 epochs; (d) 9b's radar frame raytraced from the EOF
     with ``azimuth_time_grid``, ``s1_timing``'s two network look-ups
     replaced by functions that return the local EOF. HRRR's download is
     replaced by a cut of 8a's CONUS raw file for the bounds it is asked
     for, each epoch's humidity scaled by a seeded factor. Gates: outputs
     under the names ``checkArgs`` gives; every netCDF-3 write read back
     equal bit for bit; each output equal bit for bit to ``tropo_delay``
     called directly on the processed (or combined) file it should use;
     (c) the delays = 0.25 d(12:00) + 0.75 d(13:00) (1e-5 m); (d) the
     azimuth time grid on the card = the CPU's (1 ms), its weights sum to
     1 (1e-12); B1 at least once a fresh load, B2 in (b) and (d). Where
     matplotlib is importable, 10a once more with ``verbose: true`` must
     write the two plots.
 11. the GUNW and GNSS tools, in phase 8's temp dir on 8a's raw file (HRRR's
     download replaced by its cuts, each epoch's q, p and T scaled by
     seeded factors, ``s1_timing``'s look-ups by local EOFs of both
     epochs): (a) ``workflows.gunw.run_gunw`` on the card from the
     metadata record of a Sentinel-1 interferogram over 8b's Kansas box
     (~200 x 200 km, epochs 12 days apart, HRRR at 0.05 deg, heights -500
     to 9000 m, ``azimuth_time_grid``, cubes as netCDF-3), then its
     packaging layout; gates: each phase array is float32(float64(delay) *
     -4 pi / lambda) of its cube read back, bit for bit, the axes are the
     cube's in float32, the names, dtypes and attributes a GUNW product
     holds, phases finite and negative inside the frame, both phases of
     the two epochs differ, each epoch's 0 m slice (B2 on the card) on a
     64x64 sub-grid within 1e-5 m of the brick twin and of the float64
     reference on the same operands, B1 once a fresh load and B2 in each
     date; where h5py can be imported, the whole
     ``calcDelaysGUNW --file`` on a GUNW written with h5py, its troposphere
     group read back equal (else a line says it was not run); (b) 500
     stations through ``++process downloadGNSS`` (each station's synthetic
     UNR archive copied in place of the download; 288 epochs a day, a few
     missing), calcDelays at the stations on the same two dates, and
     ``gnss_combine``; gates: one GNSS row per station and date, each ZTD
     the archive's TROTOT / 1000 at the nearest epoch with data, a merged
     row per matched (ID, Datetime), ``ZTD_minus_RAiDER`` = ZTD -
     totalDelay bit for bit; (c) ``gacos.main`` on a seeded .ztd grid read
     back by the ENVI reader; and, in phase 3, the stage timers' report
     after its two requests (every JAX stage name present, the stages'
     sums within the requests' wall times).
 12. raiderStats and several shards, in phase 8's temp dir: (a) a seeded
     combined GNSS/model CSV in raiderCombine's layout (2,000 stations over
     CONUS, a 12:00 UTC epoch a day for 760 days, 5% of station-days
     missing, 50 stations under two years; ZTD of annual and semiannual
     harmonics, a trend and noise) read by ``utils.table.read_csv`` and
     analysed by ``workflows.stats.stats_analyses`` through its argv
     (-plotall, the absolute grids, the absolute phase grid, rasters, the
     per-day variograms, 1 deg cells), then once more with the row filters
     (-b, -ti, a wrapping -si, -oe, -variogram_errlimit, -u mm); each
     twice on the card and once on the CPU. Where matplotlib is missing
     only the drawing is replaced by a counter. Gates: every non-figure
     product reads back; two card runs equal bit for bit (numbers and
     files); the card against the CPU (grids and variogram gamma rtol
     1e-12 with the same NaN cells, counts and medians equal, seasonal
     coefficients 1e-9, sill and range 1e-6); the span filter drops
     exactly the 50 short stations and every kept station's annual
     amplitude is within 3 mm and its phase within 0.2 rad of the seeded
     ones. (b) raiderStats on 11b's merged product (-sp 0.5, grids,
     rasters), card against CPU; its seasonal table is empty (two days of
     record). (c) phase 3's zenith and raytraced requests with ``mesh``
     = 4 shards of the one card: bit for bit phase 3's cubes, B2 3 x 4
     times. (d) phase 7's bigcube (pack16_i16, pack4) integrated in 4
     z-slabs against the whole table (rtol 2e-6, the same NaN), each
     slab's bytes; the midcube's brick_i16 slice ray-sharded by
     ``shard_rays`` (K4 once a shard, bit for bit); 8b's raytraced request
     with ``zshard=True`` over 4 shards against the same request with the
     whole table (rtol 2e-6).

Phases 3 to 12 each start with the launch counts at 0 and read them when
their path ends; the comparisons after that do not count. The line before
the last is a JSON record of the kernels (with each kernel's bound: the
least time the card could take for the same work, from the bytes each
input read once and each output written once at 3.35 TB/s, or its float32
operations at 67 TFLOP/s, whichever is larger); the last line is
``{"ok": true, "device": {...}}``. Data are random, made from a fixed seed.
"""

import contextlib
import datetime as dt
import json
import os
import re
import sys
import tempfile
import time
from pathlib import Path

import numpy as np

SEED = 0
B2_TOL = 1e-5      # max relative difference, kernel B2 vs twin (finite rays)
SUBGRID_TOL = 1e-5  # metres, raytraced 0 m slice vs its twin or a float64 reference
BBOX = [18.5, 21.5, 3.5, 6.0]
HEIGHTS = [0.0, 500.0, 1500.0]
# sizes: the benchmark headline's (bench.py:80-86)
DEVICE = 'cuda'
KERNEL_GRID = (51, 400, 400)     # phase 2 cubes (nz, ny, nx)
ZTD_BIG_GRID = (51, 1059, 1799)  # phase 2: B1 on the HRRR CONUS grid
N_RAYS = 1201 * 1001             # phase 2 rays, as many as the main path's pixels
MODEL_GRID = (50, 400, 400)      # native levels, lat, lon of the weather model
SPACING_M = 250.0                # output cube spacing: ~1.2M pixels over BBOX
MIN_PIXELS = 1_000_000
WINDOW_SIDE = 1000               # phase 4 rays per side (the window ablation's)
WINDOW_GRID = (50, 400, 400)     # phase 4 cube
B3_TOL = 1e-5      # max relative difference, kernel B3 vs B2 (B3 vs its twin: bit for bit)
PROBE_N = 1 << 20                # phase 5 block rows (the probe's)
GATHER_ROWS = 50 * 400 * 400     # phase 5 gather table rows (the probe's)
PROFILE_GRID = (50, 400, 400)    # phase 6: the kernel profile's scene
PROFILE_RAYS = 1_000_000
PROFILE_VARIANTS = ('prod', 'tensor', 'pallas', 'pallas2', 'prodmerged', 'prodpallas', 'prodi16')
K_TOL = 1e-5       # max relative difference, kernels K1-K4 vs their twins
I16_TOL = 1e-4     # metres, an int16 table vs an exact one or float64 on the same rays
MID_GRID = (50, 640, 640)        # phase 7: bench.py's midcube
BIG_GRID = (50, 1059, 1799)      # phase 7: bench.py's bigcube (HRRR CONUS)
LARGE_RAYS = 1_000_000
WX_BOX = [36.0, 39.0, -100.0, -97.5]  # phase 8b AOI (Kansas), inside HRRR CONUS
WX_TRACK = (-103.4, 37.5)        # phase 8b ground track: longitude, latitude at t = 0
WX_HEIGHTS = [0.0, 500.0, 1500.0]
ZENITH_SPACING_M = 1000.0        # phase 8c zenith requests
# phase 8c: (model, time, query bounds SNWE or None for the whole grid, zenith AOI SNWE)
_WX_SNWE, _WX_AOI = [26.0, 44.0, -109.0, -91.0], [33.0, 37.0, -102.0, -98.0]
WX_FAMILIES = (
    ('ERA5', dt.datetime(2020, 1, 30, 12), _WX_SNWE, _WX_AOI),
    ('ERA5T', dt.datetime(2020, 1, 30, 12), _WX_SNWE, _WX_AOI),
    ('ERAI', dt.datetime(2018, 1, 30, 12), _WX_SNWE, _WX_AOI),
    ('HRES', dt.datetime(2018, 1, 30, 12), _WX_SNWE, _WX_AOI),
    ('GMAO', dt.datetime(2020, 1, 30, 12), _WX_SNWE, _WX_AOI),
    ('MERRA2', dt.datetime(2020, 1, 30, 12), _WX_SNWE, _WX_AOI),
    ('NCMR', dt.datetime(2018, 7, 30, 12), _WX_SNWE, _WX_AOI),
    ('WRF', dt.datetime(2020, 1, 30, 12), None, _WX_AOI),
    ('HRRRAK', dt.datetime(2020, 1, 30, 15), None, [60.6, 61.8, -151.4, -148.4]),
)
# the steps of WeatherModel.load that phases 3 and 8a time, in a load of their own
WX_STEPS = ('load_weather', '_get_heights', '_find_e', '_uniform_in_z', '_check_for_nans',
            '_get_wet_refractivity', '_get_hydro_refractivity', '_adjust_grid', '_get_ztd')
CRS_POINTS = 1 << 20             # phase 8d
CRS_TOL_M = 1e-8                 # card vs CPU, projected coordinates
CRS_TOL_DEG = 1e-10              # card vs CPU, longitude and latitude
# phase 9: point requests on the raw HRRR CONUS file of phase 8a
PT_TIME = dt.datetime(2021, 7, 1, 12, 0, 0)
N_STATIONS = 2000                # 9a: GNSS stations drawn in the LCC grid's interior
STATION_DUPLICATES = 5
STATION_MARGIN = 0.05            # share of the grid kept clear on each side
RDR_SHAPE = (2048, 2048)         # 9b/9c: a Sentinel-1 frame's lat/lon/hgt rasters
RDR_CENTER = (37.5, -98.75)      # inside phase 8b's Kansas box
RDR_EXTENT = (2.2, 0.9)          # deg along and across the track (~2.3 x 1.6 deg of lat/lon)
RDR_SKEW = 10.0                  # deg, the track from north
RDR_HEIGHTS = (300.0, 1200.0)
RDR_NODATA = 64                  # pixels with the nodata height
NODATA = -9999.0
EOF_STEP = 10.0                  # s between the EOF file's statevectors
PATCH = 64                       # point step against scipy on a PATCH x PATCH subset
DEM_SHAPE = (3600, 3600)         # 9d: one GLO-30 1-degree tile
DEM_ORIGIN = (-99.0, 38.0)       # its west and north edges
GEOCUBE_SHAPE = (41, 41)         # 9d: latitude x longitude nodes over the DEM tile
GEOCUBE_HEIGHTS = np.linspace(-500.0, 9000.0, 20)
POINT_TOL = 1e-5                 # metres, the point step vs scipy in float64
PROJ_REL_TOL = 1e-6              # projected delay vs zenith / factor
FACTOR_TOL = 1e-12               # state_to_los_factor, card vs CPU
# phase 10: the calc-delays workflow through the CLI
WF_HEIGHTS = [0.0, 500.0, 1500.0, 3000.0]
WF_SPACING_M = 2000.0            # cube_spacing_in_m of every config
WF_STATION_TIME = PT_TIME.replace(minute=45)   # 10c: between the 12:00 and 13:00 epochs
WF_CENTER_WEIGHTS = (0.25, 0.75)
WF_CENTER_TOL = 1e-5             # metres, 10c vs the weighted delays of the two epochs
GUNW_REF = PT_TIME                                      # 11a: the reference epoch
GUNW_SEC = PT_TIME - dt.timedelta(days=12)              # and the secondary, 12 days earlier
GUNW_NAME = (f'S1-GUNW-A-R-064-tops-{GUNW_REF:%Y%m%d}_{GUNW_SEC:%Y%m%d}-120000-'
             '38400N_36600N-PP-0000-v3_0_0.nc')
GUNW_POLYGON = [(-99.88, 36.6), (-97.62, 36.6), (-97.62, 38.4), (-99.88, 38.4), (-99.88, 36.6)]
GUNW_WAVELENGTH = 0.05546576     # m, Sentinel-1 C band
N_GNSS = 500                     # 11b: stations in phase 8b's Kansas box
GNSS_DATES = (PT_TIME.date() - dt.timedelta(days=1), PT_TIME.date())
GNSS_GAPS = 4                    # epochs missing a day in each archive
GACOS_SHAPE = (240, 300)         # 11c: a GACOS .ztd grid (rows, columns)
STATS_STATIONS = 2000            # 12a: GNSS stations over CONUS
STATS_DAYS = 760                 # one epoch a day at 12:00 UTC from 2019-01-01
STATS_SHORT = 50                 # stations with less than two years of record
STATS_BOX = (25.0, 49.0, -124.0, -67.0)
STATS_FLAGS = ['-plotall', '-grid_delay_absolute_mean', '-grid_delay_absolute_median',
               '-grid_delay_absolute_stdev', '-grid_seasonal_absolute_phase', '-grid_to_raster',
               '-variogram_per_timeslice', '-sp', '1']
STATS_FILTER_FLAGS = [*STATS_FLAGS, '-b', '30 45 -110 -80', '-ti', '2019-03-01 2020-12-31',
                      '-si', '11 2', '-oe', '0.015', '-variogram_errlimit', '0.01', '-u', 'mm',
                      '-min_span', '1', '0.2']
STATS_RTOL = 1e-12               # card vs CPU: grids, variogram gamma
STATS_RTOL_FIT = 1e-9            # card vs CPU: seasonal coefficients
STATS_RTOL_SILL = 1e-6           # card vs CPU: variogram sill and range
SHARDS = 4                       # 12c/12d: logical shards on the one card
ZSHARD_RTOL = 2e-6               # z-slab tables vs the whole table (the JAX test's bound)
HBM_BYTES_PER_S = 3.35e12        # H100 SXM published peaks (NVIDIA data sheet)
F32_FLOP_PER_S = 67e12


def say(msg: str) -> None:
    print(msg, flush=True)


def max_rel(torch, a, b) -> float:
    ok = torch.isfinite(b) & (b != 0)
    return float(((a[ok] - b[ok]).abs() / b[ok].abs()).max()) if bool(ok.any()) else 0.0


def check(cond: bool, what: str) -> None:
    if not cond:
        raise AssertionError(what)


def bound(n_bytes: float, flops: float) -> dict:
    """The least time for the work: bytes at the memory rate or float32
    operations at the peak rate, whichever takes longer."""
    t_bytes, t_ops = n_bytes / HBM_BYTES_PER_S, flops / F32_FLOP_PER_S
    return dict(bound_ms=max(t_bytes, t_ops) * 1e3,
                bound_by='bytes' if t_bytes >= t_ops else 'operations')


def brick_rows_used(torch, plan, bnd_y, bnd_x, ys, xs) -> int:
    """Distinct brick-table rows kernel B2 reads for these rays: per group,
    the anchor row (z anchor, lowest y and x cell of the group's samples)."""
    from raider_tpu_torch.ops.interp import _locate

    rows = []
    for g in range(plan.anchor.size):
        if plan.pad[g].all():
            continue
        ay = ax = None
        for s in range(plan.G):
            lv, f = int(plan.lvl[g, s]), float(np.float32(plan.frac[g, s]))
            iy = _locate(ys, bnd_y[lv] + f * (bnd_y[lv + 1] - bnd_y[lv]))[0]
            ix = _locate(xs, bnd_x[lv] + f * (bnd_x[lv + 1] - bnd_x[lv]))[0]
            ay = iy if ay is None else torch.minimum(ay, iy)
            ax = ix if ax is None else torch.minimum(ax, ix)
        rows.append((int(plan.anchor[g]) * len(ys) + ay) * len(xs) + ax)
    return int(torch.unique(torch.cat(rows)).numel())


def brick_shape(kernels, plan, table, n_rays: int) -> dict:
    """Kernel B2/K4's launch shape for this plan and table, and the bytes its
    staged planes move: per ray and group, each plane some sample of the
    group reads (dzo, dzo+1), wy x wx (wet, hydro) pairs; the kernel's ring
    copies each once, since dzo never falls within a group."""
    isz = table.element_size()
    threads, smem = kernels.brick_launch_shape(plan.wy, plan.wx, isz, plan.G, plan.anchor.size)
    planes = sum(len({int(d) + k for d, p in zip(plan.dzoff[g], plan.pad[g]) if not p
                      for k in (0, 1)}) for g in range(plan.anchor.size))
    return dict(threads=threads, smem_bytes=smem,
                issued_bytes=n_rays * planes * plan.wy * plan.wx * 2 * isz)


def brick_resources(kernels) -> dict:
    """Registers and spills that ptxas reported for each B2/K4 instance
    ('f32 3x3', 'i16 4x4', ...; '0x0' is the instance for any other window)."""
    out = {}
    for fn, res in kernels.ptxas_resources('brick_integrate.cu').items():
        m = re.search(r'brick_integrate_kernelI([fs])Li(\d+)ELi(\d+)E', fn)
        if m:
            out[f"{'f32' if m.group(1) == 'f' else 'i16'} {m.group(2)}x{m.group(3)}"] = res
    return out


def instance_resources(kernels, source: str, kernel: str) -> dict:
    """Registers and spills that ptxas reported for each window instance of
    ``kernel`` in ``source`` ('3x3', '4x4'; '0x0' is the instance for any
    other window up to 8x8): K1 and K3."""
    out = {}
    for fn, res in kernels.ptxas_resources(source).items():
        m = re.search(kernel + r'ILi(\d+)ELi(\d+)E', fn)
        if m:
            out[f'{m.group(1)}x{m.group(2)}'] = res
    return out


def window_cells_used(torch, b) -> int:
    """Distinct cube cells kernel B3 reads for a batch: the 8 corners of
    every sample that passes its tests (per cube)."""
    nz, ny, nxp = b.cube_w.shape
    plane = ny * nxp
    seen = torch.zeros(nz * plane, dtype=torch.bool, device=b.re.device)
    for g in range(b.lvl.shape[0]):
        for s in range(b.lvl.shape[1]):
            if b.pad[g, s]:
                continue
            lv, f = int(b.lvl[g, s]), float(b.frac[g, s])
            py = b.lo[0, lv] + f * (b.hi[0, lv] - b.lo[0, lv])
            px = b.lo[1, lv] + f * (b.hi[1, lv] - b.lo[1, lv])
            posy, posx = (py - b.ylo) * b.yinv, (px - b.xlo) * b.xinv
            ok = (py >= b.ylo) & (posy <= ny - 1) & (px >= b.xlo) & (posx <= b.nx - 1)
            iy = torch.floor(posy[ok]).clamp(0, ny - 2).long()
            ix = torch.floor(posx[ok]).clamp(0, b.nx - 2).long()
            base = int(b.za[g] + b.dzo[g, s]) * plane + iy * nxp + ix
            for off in (0, 1, nxp, nxp + 1, plane, plane + 1, plane + nxp, plane + nxp + 1):
                seen[base + off] = True
    return int(seen.sum())


def ztd_cubes(torch, grid, layout: str):
    """B1's t, p, e as (nz, ny, nx) cubes drawn on the card: contiguous
    (z, y, x) rows, or the (z, y, x) views of contiguous (y, x, z) columns
    (the weather model's layout); and the level heights."""
    nz, ny, nx = grid
    gen = torch.Generator(device=DEVICE)
    gen.manual_seed(SEED)
    shape = (nz, ny, nx) if layout == 'rows' else (ny, nx, nz)
    fields = [lo + (hi - lo) * torch.rand(shape, generator=gen, device=DEVICE)
              for lo, hi in ((200.0, 310.0), (1e3, 1.05e5), (1.0, 4000.0))]
    if layout == 'columns':
        fields = [torch.movedim(a, -1, 0) for a in fields]
    zs = torch.as_tensor(-100.0 + 27100.0 * np.linspace(0.0, 1.0, nz) ** 1.4, device=DEVICE)
    return fields + [zs]


def phase_ztd(torch) -> dict:
    """Phase 2, B1: the kernel against its twin, bit for bit, on both layouts
    at the headline cube and on the model's columns at the CONUS grid. The
    kernels line gets the main path's layout (columns, headline cube)."""
    from raider_tpu_torch.ops.ztd import ztd_totals, ztd_totals_ref
    from raider_tpu_torch.scripts import cuda_ms, device_ms

    k1, k2, k3 = 0.776, 0.233, 3.75e3
    recs, errs = {}, []
    for grid, layout in ((KERNEL_GRID, 'rows'), (KERNEL_GRID, 'columns'),
                         (ZTD_BIG_GRID, 'columns')):
        t, p, e, zs = ztd_cubes(torch, grid, layout)
        w_k, h_k = ztd_totals(t, p, e, zs, k1, k2, k3)
        w_r, h_r = ztd_totals_ref(t, p, e, zs, k1, k2, k3)
        err = float(max((w_k - w_r).abs().max(), (h_k - h_r).abs().max()))
        equal = bool(torch.equal(w_k, w_r) and torch.equal(h_k, h_r))
        del w_k, h_k, w_r, h_r
        cells = int(np.prod(grid))
        r = dict(max_abs_err=err, ms=cuda_ms(lambda: ztd_totals(t, p, e, zs, k1, k2, k3)),
                 device_ms=device_ms(lambda: ztd_totals(t, p, e, zs, k1, k2, k3),
                                     'ztd_totals_kernel')[1],
                 plain_ms=cuda_ms(lambda: ztd_totals_ref(t, p, e, zs, k1, k2, k3)),
                 **bound(5 * 4 * cells, 14 * cells))
        r['bound_share'] = r['bound_ms'] / r['device_ms'] if r['device_ms'] else None
        name = f'{"x".join(map(str, grid))} {layout}'
        say(f'B1 ztd_totals {name}: max-abs {err:.3e} m, equal to the twin {equal}; call '
            f'{r["ms"]:.3f} ms, kernel {r["device_ms"]} ms on the device, twin '
            f'{r["plain_ms"]:.3f} ms; bound {r["bound_ms"]:.4f} ms ({r["bound_by"]}), '
            f'{r["bound_share"]} of the device time')
        check(equal and err == 0.0, f'B1 differs from its twin on {name}: max-abs {err}')
        check(r['device_ms'] is not None, 'the profiler trace holds no device time for B1')
        recs[name] = r
        errs.append(err)
        del t, p, e
        torch.cuda.empty_cache()
    head = recs[f'{"x".join(map(str, KERNEL_GRID))} columns']
    return dict(head, max_abs_err=max(errs), library_ms=None, layout='columns', layouts=recs)


def phase_kernels(torch, kernels):
    """Phase 2: both kernels against their twins at the main path's shapes."""
    from raider_tpu_torch.delay.raytrace import (build_group_plan, integrate_bricks,
                                                 integrate_bricks_ref, pack_cubes)
    from raider_tpu_torch.scripts import cuda_ms

    b1 = phase_ztd(torch)
    rng = np.random.default_rng(SEED)
    dev = DEVICE
    nz, ny, nx = KERNEL_GRID
    zs = (-100.0 + 27100.0 * np.linspace(0.0, 1.0, nz) ** 1.4)
    # B2's scene as in earlier runs: skip the draws that B1's cubes took there
    rng.bit_generator.advance(3 * nz * ny * nx)

    # B2: bench.py's synthetic slant rays (random start, azimuth, 25-45 deg
    # zenith), contiguous through the level chain, on an origin-shifted grid
    ys = np.linspace(30.0, 40.0, ny) - 30.0
    xs = np.linspace(-125.0, -115.0, nx) + 125.0
    wet = torch.as_tensor(rng.uniform(0.1, 100.0, (nz, ny, nx)).astype(np.float32), device=dev)
    hyd = torch.as_tensor(rng.uniform(50.0, 300.0, (nz, ny, nx)).astype(np.float32), device=dev)
    n_rays = N_RAYS
    zen = torch.as_tensor(rng.uniform(np.deg2rad(25.0), np.deg2rad(45.0), n_rays), device=dev)
    azi = torch.as_tensor(rng.uniform(0.0, 2.0 * np.pi, n_rays), device=dev)
    y0 = torch.as_tensor(rng.uniform(2.0, 8.0, n_rays), device=dev)
    x0 = torch.as_tensor(rng.uniform(2.0, 8.0, n_rays), device=dev)
    dzv = np.diff(zs)
    deg_per_m = 1.0 / 111000.0
    dzv_d = torch.as_tensor(dzv, device=dev)
    dh = dzv_d[:, None] * torch.tan(zen)[None, :]
    zero = torch.zeros((1, n_rays), dtype=torch.float64, device=dev)
    bnd_y = (y0 + torch.cat([zero, torch.cumsum(dh * torch.cos(azi) * deg_per_m, 0)])).float()
    bnd_x = (x0 + torch.cat([zero, torch.cumsum(dh * torch.sin(azi) * deg_per_m, 0)])).float()
    bnd_z = torch.as_tensor(zs, dtype=torch.float32, device=dev)[:, None].expand(nz, n_rays).contiguous()
    ray_len = (dzv_d[:, None] / torch.cos(zen)[None, :]).float()
    d2 = (dh * dh).float()
    re = torch.full((n_rays,), 6371000.0, dtype=torch.float32, device=dev)
    per_level_max = dzv * float((1.0 / torch.cos(zen)).max())
    hstep_max = dzv * float(torch.tan(zen).max()) * deg_per_m * (1.0 + 1e-5) + 1e-7
    del zen, azi, y0, x0, dh, zero
    table, _ = pack_cubes(wet, hyd, grouped=True)
    plan = build_group_plan(per_level_max, zs, hstep_max, ys, xs, zs)
    rays = (bnd_y, bnd_x, bnd_z, d2, ray_len, re)
    wk, hk = integrate_bricks(table, *rays, plan, ys, xs, zs)
    wr, hr = integrate_bricks_ref(table, *rays, plan, ys, xs, zs)
    torch.cuda.synchronize()
    same_nan = bool(torch.equal(torch.isnan(wk), torch.isnan(wr))
                    and torch.equal(torch.isnan(hk), torch.isnan(hr)))
    b2_rel = max(max_rel(torch, wk, wr), max_rel(torch, hk, hr))
    fin = torch.isfinite(wr) & torch.isfinite(hr)
    b2_abs = float(max((wk - wr)[fin].abs().max(), (hk - hr)[fin].abs().max()))
    b2_ms = cuda_ms(lambda: integrate_bricks(table, *rays, plan, ys, xs, zs))
    b2_plain = cuda_ms(lambda: integrate_bricks_ref(table, *rays, plan, ys, xs, zs))
    say(f'B2 brick_integrate {nz}x{ny}x{nx} table, {n_rays} rays, {plan.anchor.size} groups: '
        f'max-rel {b2_rel:.3e} max-abs {b2_abs:.3e} m, NaN masks equal {same_nan}, '
        f'finite {float(fin.float().mean()):.4f}; kernel {b2_ms:.3f} ms, twin {b2_plain:.3f} ms')
    check(same_nan, 'B2 NaN masks differ from the twin')
    check(b2_rel <= B2_TOL, f'B2 max-rel {b2_rel} > {B2_TOL}')
    check(float(fin.float().mean()) > 0.99, 'B2 synthetic rays mostly NaN')
    # bound: B2 reads its ray operands, the table rows the rays use and the
    # plan, and writes wet and hydro (~300 flops a sample)
    n_rows = brick_rows_used(torch, plan, bnd_y, bnd_x, ys, xs)
    width = table.shape[1]
    n_samples = int((~plan.pad).sum()) * n_rays
    b2_bytes = 4 * n_rays * (3 * nz + 2 * (nz - 1) + 1 + 2) + 4 * width * n_rows
    b2_bound = bound(b2_bytes, 300 * n_samples)
    shape = brick_shape(kernels, plan, table, n_rays)
    say(f'B2 reads {n_rows} distinct table rows '
        f'({4 * width * n_rows / 1e9:.3f} GB of the {table.numel() * 4 / 1e9:.3f} GB table), '
        f'{b2_bytes / 1e9:.3f} GB in all: bound {b2_bound}; launch {shape}')
    return {
        'ztd_totals': b1,
        'brick_integrate': dict(max_abs_err=b2_abs, ms=b2_ms, plain_ms=b2_plain, **b2_bound,
                                library_ms=None, **shape),
    }


def smoke_model_class():
    from raider_tpu_torch.wx.base import WeatherModel

    class SmokeModel(WeatherModel):
        """HRRR-sized synthetic model: standard atmosphere plus seeded noise
        on 50 terrain-following native levels over a 400x400 grid."""

        def __init__(self):
            super().__init__()
            self._k1, self._k2, self._k3 = 0.776, 0.233, 3.75e3
            self._Name = 'SMOKE'
            self._lat_res = self._lon_res = 0.02

        def load_weather(self, *args, **kwargs):
            rng = np.random.default_rng(SEED + 1)
            nlev, ny, nx = MODEL_GRID
            self._ys = np.linspace(16.0, 24.0, ny)
            self._xs = np.linspace(1.5, 7.5, nx)
            self._lons, self._lats = np.meshgrid(self._xs, self._ys)
            terrain = (800.0 + 600.0 * np.sin(np.deg2rad(self._lats) * 40.0)
                       * np.cos(np.deg2rad(self._lons) * 30.0)
                       + rng.normal(0.0, 50.0, (ny, nx))).clip(0.0, None)
            sigma = np.linspace(0.0, 1.0, nlev) ** 1.5
            h = terrain[..., None] + (27000.0 - terrain[..., None]) * sigma
            t = np.where(h < 11000.0, 288.15 - 0.0065 * h, 216.65 + 0.001 * np.maximum(h - 20000.0, 0.0))
            p = np.where(h < 11000.0, 101325.0 * (1.0 - 2.25577e-5 * h) ** 5.25588,
                         22632.0 * np.exp(-(h - 11000.0) / 6341.6))
            q = 0.015 * np.exp(-h / 2000.0)
            self._zs = h
            self._t = t + rng.normal(0.0, 0.5, h.shape)
            self._p = p * (1.0 + rng.normal(0.0, 1e-3, h.shape))
            self._q = q * rng.uniform(0.7, 1.1, h.shape)

    return SmokeModel


def polar_orbit():
    """bench.py's 700 km polar orbit (ground track on longitude 0)."""
    from raider_tpu_torch.geometry.orbit import Orbit

    tt = np.arange(-600.0, 601.0, 30.0)
    inc = np.deg2rad(90.0)
    r_orb = 6378137.0 + 700e3
    ang = 2.0 * np.pi / 5800.0 * tt
    pos = np.stack([r_orb * np.cos(ang), r_orb * np.sin(ang) * np.cos(inc),
                    r_orb * np.sin(ang) * np.sin(inc)], -1)
    return Orbit(times=tt, pos=pos, vel=np.gradient(pos, 30.0, axis=0),
                 ref_time=dt.datetime(2020, 1, 1, 12, 0, 0))


def stage_gates(report, stages) -> None:
    """Phase 11c: the engine's stage timers over phase 3's two requests,
    printed as one line. Every JAX stage name is there, and the stages'
    sums fit the wall times: the zenith and raytraced cubes in their
    requests, the disjoint steps of the slices (geometry, integrate, the
    final fetch) in the raytraced cube, and a slice's look vectors and
    intersections in its geometry."""
    say('phase 11c stage report after phase 3\'s requests (host wall clock, no added '
        'synchronization; s): ' + json.dumps({k: {'total_s': round(v['total_s'], 6),
                                                    'calls': v['calls']}
                                                for k, v in report.items()}))
    names = ('delay.ztd_cube', 'delay.raytrace_cube', 'raytrace.device_geometry',
             'raytrace.look_vectors', 'raytrace.build_ray', 'raytrace.integrate',
             'raytrace.final_fetch')
    check(set(names) <= set(report), f'11c: stage names {sorted(report)} lack some of {names}')
    s = {k: report[k]['total_s'] for k in names}
    check(s['delay.ztd_cube'] <= stages['zenith_s']
          and s['delay.raytrace_cube'] <= stages['raytrace_s']
          and s['delay.ztd_cube'] + s['delay.raytrace_cube'] <= stages['zenith_s']
          + stages['raytrace_s']
          and s['raytrace.device_geometry'] + s['raytrace.integrate']
          + s['raytrace.final_fetch'] <= s['delay.raytrace_cube']
          and s['raytrace.look_vectors'] + s['raytrace.build_ray']
          <= s['raytrace.device_geometry'],
          f'11c: the stages do not fit the wall times: {s}, {stages}')


def phase_main_path(torch, kernels, b2_incoherent_ms):
    """Phase 3: the main path through the user entry points; returns its
    launch counts, B2's time on its 0 m slice and ``_get_ztd``'s times."""
    from raider_tpu_torch.delay import engine
    from raider_tpu_torch.delay.raytrace import (integrate_bricks, integrate_bricks_ref,
                                                 pack_cubes, slice_plan)
    from raider_tpu_torch.geodesy import get_Re
    from raider_tpu_torch.geometry import BoundingBox, Raytracing, Zenith
    from raider_tpu_torch.ops.interp import interp3d_points
    from raider_tpu_torch.scripts import cuda_ms, device_ms
    from raider_tpu_torch.utils.profiling import stage_report

    when = dt.datetime(2020, 1, 1, 12, 0, 0)
    model = smoke_model_class()()
    model.setTime(when)
    orbit = polar_orbit()
    stages = {}
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    kernels.reset_launch_counts()

    t0 = time.perf_counter()
    model.load(device=DEVICE)
    ds_wm = model.to_dataset()
    torch.cuda.synchronize()
    stages['weather_model_s'] = time.perf_counter() - t0

    stage_report(reset=True)
    t0 = time.perf_counter()
    aoi_z = BoundingBox(BBOX, cube_spacing_in_m=SPACING_M)
    ds_z, _ = engine.tropo_delay(when, ds_wm, aoi_z, Zenith(), height_levels=HEIGHTS,
                                 device=DEVICE)
    torch.cuda.synchronize()
    stages['zenith_s'] = time.perf_counter() - t0

    t0 = time.perf_counter()
    aoi_r = BoundingBox(BBOX, cube_spacing_in_m=SPACING_M)
    los = Raytracing(orbit=orbit, time=when)
    ds_r, _ = engine.tropo_delay(when, ds_wm, aoi_r, los, height_levels=HEIGHTS, device=DEVICE)
    torch.cuda.synchronize()
    stages['raytrace_s'] = time.perf_counter() - t0
    launches = dict(kernels.LAUNCHES)
    report = stage_report(reset=True)
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    steps_model = smoke_model_class()()
    steps_model.setTime(when)
    steps = step_seconds(torch, steps_model)
    del steps_model
    # the model's ZTD step alone, B1 reading its contiguous (y, x, z) fields
    ztd = dict(ms=cuda_ms(model._get_ztd))
    ztd['device_ms'], ztd['kernel_device_ms'] = device_ms(model._get_ztd, 'ztd_totals_kernel')

    nzc = tuple(np.shape(ds_wm['wet'].data))
    say('main path stages (s): ' + ', '.join(f'{k} {v:.3f}' for k, v in stages.items())
        + '; weather-model steps (s, a second load, synchronized around each): '
        + json.dumps({k: round(v, 4) for k, v in steps.items()})
        + f'; weather cube {nzc}; peak device memory {peak_gb:.2f} GB; launches {launches}; '
        f'_get_ztd alone: {ztd["ms"]:.3f} ms (device: all kernels {ztd["device_ms"]} ms, '
        f'B1 {ztd["kernel_device_ms"]} ms)')
    for name, ds in (('zenith', ds_z), ('raytraced', ds_r)):
        w = np.asarray(ds['wet'].data)
        h = np.asarray(ds['hydro'].data)
        fin = float(np.mean(np.isfinite(w) & np.isfinite(h)))
        say(f'{name} cube {w.shape} ({w.shape[1] * w.shape[2]} pixels x {w.shape[0]} heights): '
            f'finite share {fin:.6f}, mean wet {np.nanmean(w):.6f} m, '
            f'mean hydro {np.nanmean(h):.6f} m')
        check(w.shape[0] == 3 and w.shape[1] * w.shape[2] >= MIN_PIXELS, f'{name} cube too small')
        check(fin >= 0.99, f'{name} finite share {fin} < 0.99')
    zh = np.nanmean(np.asarray(ds_z['hydro'].data)[0])
    check(1.5 < zh < 3.0, f'zenith hydrostatic delay {zh} m outside 1.5-3 m')
    slant = np.nanmean(np.asarray(ds_r['hydro'].data)[0]) / zh
    check(1.0 < slant < 2.0, f'slant/zenith hydrostatic ratio {slant} outside 1-2')
    check(launches['ztd_totals'] >= 1 and launches['brick_integrate'] >= 1,
          f'a kernel was not launched on the main path: {launches}')
    stage_gates(report, stages)

    # zenith cube (separable fp32 contractions) vs a float64 8-corner gather
    # on 4096 pixels: f32 rounding of ~2.5 m totals stays well under 1e-6 m
    rng = np.random.default_rng(SEED + 2)
    wm = engine.WeatherCube(ds_wm, DEVICE)
    iy = rng.integers(0, aoi_z.ypts.size, 4096)
    ix = rng.integers(0, aoi_z.xpts.size, 4096)
    py = torch.as_tensor(aoi_z.ypts[iy], dtype=torch.float64, device=DEVICE)
    px = torch.as_tensor(aoi_z.xpts[ix], dtype=torch.float64, device=DEVICE)
    zen_err = 0.0
    for field, out in (('wet_total', 'wet'), ('hydro_total', 'hydro')):
        cube = wm.field(field, torch.float64)
        for k, hgt in enumerate(HEIGHTS):
            g = interp3d_points(cube, wm.ys, wm.xs, wm.zs, py, px, torch.full_like(py, hgt))
            zen_err = max(zen_err, float(np.max(np.abs(
                g.cpu().numpy() - np.asarray(ds_z[out].data)[k, iy, ix]))))
    say(f'zenith: separable fp32 contractions vs float64 gather on 4096 pixels: '
        f'max |diff| {zen_err:.3e} m')
    check(zen_err <= 1e-6, f'zenith separable vs gather {zen_err} m > 1e-6 m')

    # raytraced 0 m slice vs a plain-torch recomputation on a 64x64 sub-grid
    xx, yy = np.meshgrid(aoi_r.xpts, aoi_r.ypts)
    lat = torch.as_tensor(yy.ravel(), dtype=torch.float64, device=DEVICE)
    lon = torch.as_tensor(xx.ravel(), dtype=torch.float64, device=DEVICE)
    zref = float(wm.zs.max() - 1)
    geom = engine._slice_geometry(wm, lat, lon, HEIGHTS[0], los, zref)
    rows = np.linspace(0, aoi_r.ypts.size - 1, 64).round().astype(int)
    cols = np.linspace(0, aoi_r.xpts.size - 1, 64).round().astype(int)
    flat = torch.as_tensor((rows[:, None] * aoi_r.xpts.size + cols[None, :]).ravel(), device=DEVICE)
    sub = [geom[k][:, flat].float().contiguous()
           for k in ('bnd_y', 'bnd_x', 'bnd_z', 'd2', 'ray_len')]
    re_sub = get_Re(lat[flat]).float()
    cw, ch = wm.field('wet', torch.float32), wm.field('hydro', torch.float32)
    table, _ = pack_cubes(cw, ch, grouped=True)
    ys_k, xs_k = wm.ys - wm.ys[0], wm.xs - wm.xs[0]
    plan = slice_plan(cw.shape, np.float32, ys_k, xs_k, wm.zs, geom['per_level_max'],
                      geom['heights'], geom['hstep_max'])
    w_ref, h_ref = integrate_bricks_ref(table, *sub, re_sub, plan, ys_k, xs_k, wm.zs)
    w_main = np.asarray(ds_r['wet'].data)[0][rows[:, None], cols[None, :]].ravel()
    h_main = np.asarray(ds_r['hydro'].data)[0][rows[:, None], cols[None, :]].ravel()
    sub_err = float(max(np.max(np.abs(w_ref.cpu().numpy() - w_main)),
                        np.max(np.abs(h_ref.cpu().numpy() - h_main))))
    say(f'raytraced 0 m slice vs plain-torch recomputation on a 64x64 sub-grid: '
        f'max |diff| {sub_err:.3e} m')
    check(sub_err <= SUBGRID_TOL, f'sub-grid twin check {sub_err} m > {SUBGRID_TOL} m')

    # B2 on the whole 0 m slice: the main path's coherent pixel rays
    full = [geom[k].float().contiguous() for k in ('bnd_y', 'bnd_x', 'bnd_z', 'd2', 'ray_len')]
    full.append(get_Re(lat).float())
    main_ms = cuda_ms(lambda: integrate_bricks(table, *full, plan, ys_k, xs_k, wm.zs))
    say(f'B2 on the 0 m slice of the main path ({lat.numel()} coherent pixel rays, '
        f'{plan.anchor.size} groups, launch {brick_shape(kernels, plan, table, lat.numel())}): '
        f'kernel {main_ms:.3f} ms; phase 2 ({N_RAYS} incoherent rays) {b2_incoherent_ms:.3f} ms')
    ctx = dict(when=when, ds_wm=ds_wm, orbit=orbit, zenith=ds_z, raytraced=ds_r, stages=stages)
    return launches, main_ms, ztd, ctx


def phase_window(torch, kernels):
    """Phase 4: the windowed path (kernel B3) on the window ablation's scene."""
    from raider_tpu_torch.delay.pallas_window import (integrate_rays_windowed, prepare_windowed,
                                                      window_integrate, window_integrate_ref,
                                                      window_launch_shape)
    from raider_tpu_torch.delay.raytrace import pack_cubes
    from raider_tpu_torch.scripts import cuda_ms, device_ms
    from raider_tpu_torch.scripts import window_ablation as wa
    from raider_tpu_torch.scripts.kernel_profile import same_bits

    sc = wa.build_scene(WINDOW_SIDE, grid=WINDOW_GRID, device=DEVICE, seed=SEED)
    args = wa.windowed_args(sc)
    torch.cuda.synchronize()
    kernels.reset_launch_counts()
    t0 = time.perf_counter()
    w3, h3, used = integrate_rays_windowed(*args, device=DEVICE)
    torch.cuda.synchronize()
    first_s = time.perf_counter() - t0
    launches = dict(kernels.LAUNCHES)
    n_pix = WINDOW_SIDE * WINDOW_SIDE
    check(used, 'the windowed path declined the coherent batch')
    check(launches['window_integrate'] >= 1, f'B3 was not launched on its path: {launches}')

    # B3 against its twin on the same operands (tile order)
    b = prepare_windowed(*args, device=DEVICE)
    wk, hk = window_integrate(b)
    wr, hr = window_integrate_ref(b)
    torch.cuda.synchronize()
    same_nan = bool(torch.equal(torch.isnan(wk), torch.isnan(wr))
                    and torch.equal(torch.isnan(hk), torch.isnan(hr)))
    exact = same_bits(wk, wr) and same_bits(hk, hr)
    fin = torch.isfinite(wr) & torch.isfinite(hr)
    b3_abs = float(max((wk - wr)[fin].abs().max(), (hk - hr)[fin].abs().max()))
    b3_ms = cuda_ms(lambda: window_integrate(b))
    b3_device = device_ms(lambda: window_integrate(b), 'window_integrate_kernel')[1]
    b3_plain = cuda_ms(lambda: window_integrate_ref(b))
    entry_ms = cuda_ms(lambda: integrate_rays_windowed(*args, device=DEVICE))
    prep_ms = cuda_ms(lambda: prepare_windowed(*args, device=DEVICE))
    shape = window_launch_shape(b)
    ptxas = kernels.ptxas_resources('window_integrate.cu')
    say(f'B3 window_integrate {WINDOW_GRID} cube, {n_pix} rays ({b.re.shape[0]} in '
        f'{b.ay.shape[0]} tiles), {b.lvl.shape[0]} groups, WY {b.wy}: vs twin bit-identical '
        f'{exact}, max-abs {b3_abs:.3e} m, NaN masks equal {same_nan}; kernel {b3_ms:.3f} ms '
        f'(device {b3_device}), twin {b3_plain:.3f} ms; entry point {entry_ms:.3f} ms (tile order '
        f'and pre-pass {prep_ms:.3f} ms; first call {first_s:.3f} s); launch {shape}, ptxas '
        f'{ptxas}')
    check(same_nan, 'B3 NaN masks differ from the twin')
    check(exact, 'B3 is not bit-identical to its twin')

    # B3 against the brick path on the same rays
    pack_ms = cuda_ms(lambda: pack_cubes(sc['wet'], sc['hydro'], grouped=True))
    table, mode = pack_cubes(sc['wet'], sc['hydro'], grouped=True)
    w2, h2 = wa.brick(sc, table, mode)
    b2_ms = cuda_ms(lambda: wa.brick(sc, table, mode))
    del table
    both = torch.isfinite(w3) & torch.isfinite(w2) & torch.isfinite(h3) & torch.isfinite(h2)
    rel_b2 = max(max_rel(torch, w3[both], w2[both]), max_rel(torch, h3[both], h2[both]))
    only3 = int((torch.isnan(w3) & ~torch.isnan(w2)).sum())
    only2 = int((torch.isnan(w2) & ~torch.isnan(w3)).sum())
    fin3 = float((torch.isfinite(w3) & torch.isfinite(h3)).float().mean())
    say(f'B3 vs brick path (B2) on the same rays: max-rel {rel_b2:.3e}, NaN only in B3 {only3}, '
        f'only in B2 {only2}, B3 finite {fin3:.6f}; brick pack {pack_ms:.3f} ms + integrate '
        f'{b2_ms:.3f} ms = {pack_ms + b2_ms:.3f} ms against windowed {entry_ms:.3f} ms')
    check(rel_b2 < B3_TOL, f'B3 vs B2 max-rel {rel_b2} >= {B3_TOL}')
    check(fin3 >= 0.999, f'B3 finite share {fin3} < 0.999')

    # bound: the segment operands, Re, the anchors, the cube cells read
    # (both cubes) and wet/hydro written; ~70 flops a sample
    n = b.re.shape[0]
    n_cells = window_cells_used(torch, b)
    n_samples = int((~b.pad).sum()) * n
    b3_bytes = 4 * (b.lo.numel() + b.hi.numel() + b.d2.numel() + b.ray_len.numel() + 3 * n
                    + 2 * b.ay.numel() + 2 * n_cells)
    b3_bound = bound(b3_bytes, 70 * n_samples)
    say(f'B3 reads {n_cells} distinct cells of each cube, {b3_bytes / 1e9:.3f} GB in all: '
        f'bound {b3_bound}')
    return launches, dict(max_abs_err=b3_abs, ms=b3_ms, plain_ms=b3_plain, **b3_bound,
                          library_ms=None, device_ms=b3_device, threads=shape['threads'],
                          smem_bytes=shape['smem_bytes'], stages=shape['stages'], ring_slots=shape['n_slots'], ptxas=ptxas,
                          entry_ms=entry_ms, prepare_ms=prep_ms,
                          brick_pack_ms=pack_ms,
                          brick_ms=b2_ms, max_rel_vs_brick=rel_b2)


def phase_probes(torch, kernels):
    """Phase 5: the 16-bit probes (kernels S4 and S5) through their entry point."""
    from raider_tpu_torch.scripts import cuda_ms, probe_f16

    torch.cuda.synchronize()
    kernels.reset_launch_counts()
    records = probe_f16.run(DEVICE, n=PROBE_N, gather_rows=GATHER_ROWS, say=say)
    torch.cuda.synchronize()
    launches = dict(kernels.LAUNCHES)
    loads = {k.removeprefix('probe_load_'): r for r in records for k in r if k.startswith('probe_load_')}
    cast = next(r for r in records if 'bitcast_i16_bf16' in r)
    check(len(loads) == 3 and all(r['max_abs_err'] == 0.0 for r in loads.values()),
          f'S4 differs from its twin: {loads}')
    check(cast['max_abs_err'] == 0.0, f'S5 differs from its twin: {cast}')
    check(launches['probe_load'] >= 1 and launches['probe_bitcast_i16_bf16'] >= 1,
          f'a probe kernel was not launched on its path: {launches}')
    x = probe_f16.make_block(torch.bfloat16, PROBE_N, DEVICE).view(torch.int16)
    cast_library = cuda_ms(lambda: x.view(torch.bfloat16).to(torch.float32))
    row = PROBE_N * probe_f16.WIDTH
    s4 = dict(max_abs_err=max(r['max_abs_err'] for r in loads.values()), ms=loads['bf16']['ms'],
              plain_ms=loads['bf16']['plain_ms'], **bound(2 * row + 4 * PROBE_N, 16 * PROBE_N),
              library_ms=None, ms_by_dtype={k: r['ms'] for k, r in loads.items()})
    s5 = dict(max_abs_err=cast['max_abs_err'], ms=cast['ms'], plain_ms=cast['plain_ms'],
              **bound(6 * row, 0), library_ms=cast_library)
    return launches, s4, s5


def compare(torch, got, want) -> tuple:
    """(max-rel, max-abs over entries finite in ``want``, NaN masks equal)
    of matching tensor sequences."""
    rel, err, same = 0.0, 0.0, True
    for a, b in zip(got, want):
        same = same and bool(torch.equal(torch.isnan(a), torch.isnan(b)))
        rel = max(rel, max_rel(torch, a, b))
        fin = torch.isfinite(b)
        if bool(fin.any()):
            err = max(err, float((a[fin] - b[fin]).abs().max()))
    return rel, err, same


def phase_profile(torch, kernels):
    """Phase 6: the kernel profile's path, then K1-K4 against their twins."""
    from raider_tpu_torch.delay.raytrace import integrate_bricks, integrate_bricks_ref
    from raider_tpu_torch.scripts import cuda_ms
    from raider_tpu_torch.scripts import kernel_profile as kp

    sc = kp.build_scene(DEVICE, n_rays=PROFILE_RAYS, grid=PROFILE_GRID, seed=SEED)
    torch.cuda.synchronize()
    kernels.reset_launch_counts()
    t0 = time.perf_counter()
    recs = kp.run(DEVICE, (7, 3, 3, 6), PROFILE_VARIANTS, scene=sc, say=say)
    recs += kp.run(DEVICE, 'split', scene=sc, say=say)
    recs += kp.run(DEVICE, (8, 4, 4, 24), ('pallas2', 'prodpallas'), scene=sc, say=say)
    torch.cuda.synchronize()
    launches = dict(kernels.LAUNCHES)
    say(f'kernel profile path: {time.perf_counter() - t0:.1f} s; launches {launches}')
    for k in ('brick_contract', 'brick_group_rows', 'brick_group_merged', 'brick_integrate_i16'):
        check(launches[k] >= 1, f'{k} was not launched on the kernel-profile path: {launches}')
    timed = {(tuple(r['spec']), r['variant']): r['ms'] for r in recs if 'spec' in r}

    st = kp.spec_setup(sc, (7, 3, 3, 6))
    planes, wy, wx, groups = st['planes'], st['wy'], st['wx'], st['groups']
    ys, xs, zs, rays = sc['ys'], sc['xs'], sc['zs'], sc['rays']
    n = rays[0].shape[1]
    consts = kp.group_consts(ys, xs, zs, wy, wx)
    out = {}

    def hold(name, ops, kernel, twin, n_bytes, flops, exact=False):
        got = [kernel(*o) for o in ops]
        want = [twin(*o) for o in ops]
        torch.cuda.synchronize()
        # K1 returns (wet, hydro), K2/K3 a (2, N) part: both iterate as two rows
        got = [t for p in got for t in p]
        want = [t for p in want for t in p]
        rel, err, same = compare(torch, got, want)
        if exact:   # bit for bit, inf included, beside equal NaN masks
            check(all(kp.same_bits(a, b) for a, b in zip(got, want)),
                  f'{name} is not bit-identical to its twin (max-abs {err})')
        ms = cuda_ms(lambda: [kernel(*o) for o in ops])
        plain = cuda_ms(lambda: [twin(*o) for o in ops])
        b = bound(n_bytes, flops)
        say(f'{name} vs twin on {n} rays, {len(ops)} groups: max-rel {rel:.3e} max-abs {err:.3e}, '
            f'NaN masks equal {same}; kernel {ms:.3f} ms, twin {plain:.3f} ms; bound {b}')
        check(same, f'{name} NaN masks differ from the twin')
        check(rel <= K_TOL, f'{name} max-rel {rel} > {K_TOL}')
        out[name] = dict(max_abs_err=err, ms=ms, plain_ms=plain, **b, library_ms=None)

    ops = [o + (planes, wy, wx) for o in kp.contract_inputs(st['table'], rays, groups, wy, wx,
                                                          ys, xs, zs)]
    hold('brick_contract', ops, kp.brick_contract, kp.contract_ref,
         sum(4 * (o[0].numel() + o[1].numel() + 2 * n) for o in ops),
         sum(n * o[0].shape[1] * (12 * len(o[2]) + 6) for o in ops), exact=True)
    threads, smem = kernels.brick_contract_shape(max(len(o[2]) for o in ops), planes, wy, wx)
    out['brick_contract'].update(variant_ms=timed[(7, 3, 3, 6), 'pallas'], threads=threads,
                                 smem_bytes=smem,
                                 ptxas=instance_resources(kernels, 'brick_contract.cu',
                                                          'brick_contract_kernel'))
    say(f'brick_contract launch: {threads} threads, {smem} shared bytes a block (at the '
        f'largest group); ptxas {json.dumps(out["brick_contract"]["ptxas"])}')
    del ops
    # K2 and K3 read, of each ray's brick row, only the planes dzo and dzo + 1
    # of the group's samples (wy wx (wet, hydro) pairs a plane)
    def brick_floats(samples):
        return n * len({s[8] + d for s in samples for d in (0, 1)}) * wy * wx * 2

    ops = [o + (consts,) for o in kp.rows_inputs(st['table'], rays, groups, ys, xs)]
    hold('brick_group_rows', ops, kp.brick_group_rows, kp.group_rows_ref,
         sum(4 * (brick_floats(o[7]) + sum(t.numel() for t in o[1:7]) + 2 * n) for o in ops),
         sum(n * len(o[7]) * (60 + 8 * wy * wx) for o in ops))
    out['brick_group_rows']['variant_ms'] = timed[(7, 3, 3, 6), 'pallas2']
    out['brick_group_rows']['g24_variant_ms'] = timed[(8, 4, 4, 24), 'pallas2']
    del ops
    ops = [o + (consts,) for o in kp.merged_inputs(st['table'], rays, groups, ys, xs)]
    hold('brick_group_merged', ops, kp.brick_group_merged, kp.group_merged_ref,
         sum(4 * (brick_floats(o[2]) + o[1].numel() + 2 * n) for o in ops),
         sum(n * len(o[2]) * (60 + 8 * wy * wx) for o in ops), exact=True)
    big = max(ops, key=lambda o: (o[1].shape[0], len(o[2])))
    threads, smem = kernels.brick_group_merged_shape(len(big[2]), big[0].shape[1], big[4], big[5],
                                                     wy, wx)
    out['brick_group_merged'].update(variant_ms=timed[(7, 3, 3, 6), 'prodmerged'], threads=threads,
                                     smem_bytes=smem,
                                     ptxas=instance_resources(kernels, 'brick_group.cu',
                                                              'brick_group_merged_kernel'))
    say(f'brick_group_merged launch: {threads} threads, {smem} shared bytes a block (at the '
        f'group with the most merged rows); ptxas '
        f'{json.dumps(out["brick_group_merged"]["ptxas"])}')
    del ops, big

    # K4: the spec's int16 table against its twin, and against B2 on f32
    from raider_tpu_torch.delay.raytrace import _pack_bricks, _quantized_pair

    plan = st['plan']
    qw, qh, deq = _quantized_pair(sc['wet_d'], sc['hydro_d'])
    t16 = _pack_bricks(qw, qh, planes, wy, wx)
    del qw, qh
    wk, hk = integrate_bricks(t16, *rays, plan, ys, xs, zs, deq=deq)
    wr, hr = integrate_bricks_ref(t16, *rays, plan, ys, xs, zs, deq=deq)
    w2, h2 = integrate_bricks(st['table'], *rays, plan, ys, xs, zs)
    torch.cuda.synchronize()
    rel, err, same = compare(torch, (wk, hk), (wr, hr))
    _, err_b2, same_b2 = compare(torch, (wk, hk), (w2, h2))
    ms = cuda_ms(lambda: integrate_bricks(t16, *rays, plan, ys, xs, zs, deq=deq))
    plain = cuda_ms(lambda: integrate_bricks_ref(t16, *rays, plan, ys, xs, zs, deq=deq))
    b2_ms = cuda_ms(lambda: integrate_bricks(st['table'], *rays, plan, ys, xs, zs))
    n_rows = brick_rows_used(torch, plan, rays[0], rays[1], ys, xs)
    L = rays[3].shape[0]
    k4_bytes = 4 * n * (3 * (L + 1) + 2 * L + 1 + 2) + 2 * t16.shape[1] * n_rows
    b = bound(k4_bytes, 300 * plan.n_points * n)
    shape = brick_shape(kernels, plan, t16, n)
    say(f'brick_integrate_i16 vs twin on {n} rays: max-rel {rel:.3e} max-abs {err:.3e} m, NaN masks '
        f'equal {same}; vs f32 B2 max-abs {err_b2:.3e} m, NaN masks equal {same_b2}; kernel '
        f'{ms:.3f} ms, twin {plain:.3f} ms, f32 B2 {b2_ms:.3f} ms; {n_rows} distinct '
        f'{2 * t16.shape[1]}-byte rows; bound {b}; launch {shape}')
    check(same and same_b2, 'K4 NaN masks differ from its twin or from B2')
    check(rel <= K_TOL, f'K4 max-rel {rel} > {K_TOL}')
    check(err_b2 <= I16_TOL, f'K4 vs f32 B2 max-abs {err_b2} > {I16_TOL} m')
    out['brick_integrate_i16'] = dict(max_abs_err=err, ms=ms, plain_ms=plain, **b,
                                      library_ms=None, **shape, max_abs_vs_f32_b2=err_b2,
                                      f32_b2_ms=b2_ms,
                                      variant_ms=timed[(7, 3, 3, 6), 'prodi16'],
                                      prodpallas_ms=timed[(7, 3, 3, 6), 'prodpallas'])
    return launches, out


def large_scene(torch, grid, y_span, x_span, y0_span, x0_span, on_device_cubes):
    """bench.py's midcube/bigcube scene: cubes, 1M slant rays (float64 on the
    device, then float32), the level chain and the plan inputs."""
    from raider_tpu_torch.scripts.kernel_profile import build_rays

    rng = np.random.default_rng(SEED)
    nz, ny, nx = grid
    zs = -500.0 + 26500.0 * np.linspace(0.0, 1.0, nz) ** 1.4
    if on_device_cubes:
        gen = torch.Generator(device=DEVICE)
        gen.manual_seed(SEED)
        wet = 0.1 + 99.9 * torch.rand(grid, generator=gen, device=DEVICE)
        hydro = 50.0 + 250.0 * torch.rand(grid, generator=gen, device=DEVICE)
    else:
        wet = torch.as_tensor(rng.uniform(0.1, 100.0, grid).astype(np.float32), device=DEVICE)
        hydro = torch.as_tensor(rng.uniform(50.0, 300.0, grid).astype(np.float32), device=DEVICE)
    n = LARGE_RAYS
    sc = dict(zen=rng.uniform(np.deg2rad(25.0), np.deg2rad(45.0), n),
              azi=rng.uniform(0.0, 2.0 * np.pi, n), y0=rng.uniform(*y0_span, n),
              x0=rng.uniform(*x0_span, n), dzv=np.diff(zs), zs=zs, deg_per_m=1.0 / 111000.0)
    rays = build_rays(sc, DEVICE)
    return dict(wet=wet, hydro=hydro, zs=zs, ys=np.linspace(*y_span, ny),
                xs=np.linspace(*x_span, nx), rays=rays,
                plm=(sc['dzv'] * float((1.0 / np.cos(sc['zen'])).max())).astype(np.float32),
                hstep=sc['dzv'] * float(np.tan(sc['zen']).max()) * sc['deg_per_m'])


def limits_line(torch) -> str:
    """What each table byte limit of the ladder admits (cells, at the
    (7,3,3,6) brick spec), and what the same share of this card's memory
    would admit; the limits were sized for a 16 GiB TPU v5e."""
    from raider_tpu_torch.delay import raytrace as rt

    card_bytes = torch.cuda.get_device_properties(0).total_memory
    brick = rt._padded_row_width(7 * 3 * 3 * 2)
    limits = (('brick f32', rt._BRICK_SPECS[-1][4], brick * 4),
              ('brick_i16', rt._BRICK_SPECS[-1][4], brick * 2),
              ('pack16 f32', rt._PACK16_BYTE_LIMIT, 16 * 4),
              ('pack16_i16', rt._PACK16_I16_BYTE_LIMIT, 16 * 2))
    mid, big = int(np.prod(MID_GRID)), int(np.prod(BIG_GRID))
    parts = [f'{name}: limit {lim / 2**30:.0f} GiB admits {lim // row:,} cells, the same share '
             f'of {card_bytes / 1e9:.1f} GB {int(lim / 2**34 * card_bytes) // row:,}; the '
             f'midcube table {mid * row / 1e9:.2f} GB, the bigcube one {big * row / 1e9:.2f} GB'
             for name, lim, row in limits]
    return (f'table byte limits (sized for a 16 GiB TPU v5e; midcube {mid:,} cells, bigcube '
            f'{big:,}): ' + '; '.join(parts))


def phase_large(torch, kernels):
    """Phase 7: the midcube and bigcube through ``integrate_rays`` in the
    auto mode (the engine's per-slice call), each against an exact mode."""
    from raider_tpu_torch.delay.raytrace import integrate_rays, pack_cubes, pack_mode_for
    from raider_tpu_torch.scripts import cuda_ms

    res, launches = {}, None
    # (name, grid, y axis, x axis, y0 span, x0 span, cubes made on the device,
    #  the JAX ladder's answer for the grid, the exact mode it is held to)
    cells = (('midcube', MID_GRID, (28.0, 42.0), (-127.0, -113.0), (30.0, 40.0),
              (-125.0, -115.0), False, 'brick_i16', 'pack16'),
             ('bigcube', BIG_GRID, (21.0, 53.0), (-134.0, -60.0), (25.0, 49.0),
              (-124.0, -70.0), True, 'pack16_i16', 'pack4'))
    for name, grid, ysp, xsp, y0s, x0s, on_dev, jax_mode, exact in cells:
        sc = large_scene(torch, grid, ysp, xsp, y0s, x0s, on_dev)
        auto = pack_mode_for(grid, np.float32, grouped=True)
        check(auto == jax_mode, f'{name}: pack_mode_for gives {auto}, the JAX ladder {jax_mode}')

        def pack(mode, sc=sc):
            return pack_cubes(sc['wet'], sc['hydro'], mode=mode)[0]

        def integrate(table, mode, sc=sc):
            return integrate_rays(sc['wet'], sc['hydro'], sc['ys'], sc['xs'], sc['zs'],
                                  *sc['rays'], sc['plm'], packed2d=table, mode=mode,
                                  heights=sc['zs'].copy(), hstep_max=sc['hstep'])

        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        kernels.reset_launch_counts()
        wq, hq = integrate(pack(auto), auto)
        torch.cuda.synchronize()
        got = dict(kernels.LAUNCHES)
        peak_q = torch.cuda.max_memory_allocated() / 1e9
        if name == 'midcube':
            launches = got
            check(got['brick_integrate_i16'] >= 1, f'K4 was not launched on the midcube: {got}')
        torch.cuda.reset_peak_memory_stats()
        we, he = integrate(pack(exact), exact)
        torch.cuda.synchronize()
        peak_e = torch.cuda.max_memory_allocated() / 1e9
        both = torch.isfinite(wq) & torch.isfinite(we) & torch.isfinite(hq) & torch.isfinite(he)
        err = float(max((wq - we)[both].abs().max(), (hq - he)[both].abs().max()))
        fin = float((torch.isfinite(wq) & torch.isfinite(hq)).float().mean())
        only_q = int((torch.isnan(wq) & ~torch.isnan(we)).sum())
        only_e = int((torch.isnan(we) & ~torch.isnan(wq)).sum())
        times = {}
        for mode in (auto, exact):
            table = pack(mode)
            times[mode] = dict(total_ms=cuda_ms(lambda m=mode: integrate(pack(m), m)),
                               pack_ms=cuda_ms(lambda m=mode: pack(m)),
                               integrate_ms=cuda_ms(lambda m=mode, t=table: integrate(t, m)))
            del table
        say(f'{name} {grid}, {LARGE_RAYS} rays: auto mode {auto} (the JAX ladder: {jax_mode}) '
            f'{times[auto]}, peak {peak_q:.2f} GB; {exact} {times[exact]}, peak {peak_e:.2f} GB '
            f'(ms, pack + integrate); max |diff| {err:.3e} m, finite {fin:.6f}, NaN only in '
            f'{auto} {only_q}, only in {exact} {only_e}; launches {got}')
        check(err <= I16_TOL, f'{name}: {auto} vs {exact} max |diff| {err} m > {I16_TOL} m')
        check(fin >= 0.99, f'{name}: finite share {fin} < 0.99')
        res[name] = dict(mode=auto, exact_mode=exact, times_ms=times, peak_gb=peak_q,
                         exact_peak_gb=peak_e, max_abs=err, finite=fin)
        del sc, wq, hq, we, he, both
        torch.cuda.empty_cache()
    say(limits_line(torch))
    return launches, res


@contextlib.contextmanager
def timed_calls(torch, owner, names):
    """While open, calls of ``owner``'s functions or methods ``names`` (a
    module's, or an object's) record their seconds (the device synchronized
    before and after each), their count and the last call's arguments and
    result into the dict it yields (``each``: every call's seconds)."""
    rec = {n: {'seconds': 0.0, 'calls': 0, 'each': []} for n in names}
    own = {n: vars(owner).get(n) for n in names}

    def wrap(name, fn):
        def timed(*args, **kwargs):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = fn(*args, **kwargs)
            torch.cuda.synchronize()
            r = rec[name]
            r['each'].append(time.perf_counter() - t0)
            r['seconds'] += r['each'][-1]
            r['calls'] += 1
            r['args'], r['out'] = args, out
            return out
        return timed

    for n in names:
        setattr(owner, n, wrap(n, getattr(owner, n)))
    try:
        yield rec
    finally:
        for n in names:
            if own[n] is None:
                delattr(owner, n)
            else:
                setattr(owner, n, own[n])


def step_seconds(torch, model) -> dict:
    """Seconds of each step of a ``model.load`` of its own, the device
    synchronized before and after each step (so the stage times around
    the user's call carry no synchronization)."""
    with timed_calls(torch, model, WX_STEPS) as steps:
        model.load(device=DEVICE)
    return {k: v['seconds'] for k, v in steps.items()}


def b1_against_twin(torch, model) -> bool:
    """B1's output inside ``load`` (the model's ZTD cubes) against the twin
    on the same fields, bit for bit."""
    from raider_tpu_torch.ops.ztd import ztd_totals_ref

    w, h = ztd_totals_ref(*(torch.movedim(a, -1, 0) for a in (model._t, model._p, model._e)),
                          torch.as_tensor(model._zs, dtype=torch.float32, device=DEVICE),
                          float(model._k1), float(model._k2), float(model._k3))
    return bool(torch.equal(torch.movedim(w, 0, -1), model._wet_ztd)
                and torch.equal(torch.movedim(h, 0, -1), model._hydrostatic_ztd))


def track_orbit(lon_deg: float, lat_deg: float, step: float = 30.0):
    """A 700 km polar orbit whose ground track runs along ``lon_deg``,
    over ``lat_deg`` at its reference time; statevectors every ``step`` s."""
    from raider_tpu_torch.geometry.orbit import Orbit

    tt = np.arange(-600.0, 601.0, step)
    r_orb = 6378137.0 + 700e3
    ang = 2.0 * np.pi / 5800.0 * tt + np.deg2rad(lat_deg)
    lon = np.deg2rad(lon_deg)
    pos = np.stack([r_orb * np.cos(ang) * np.cos(lon), r_orb * np.cos(ang) * np.sin(lon),
                    r_orb * np.sin(ang)], -1)
    return Orbit(times=tt, pos=pos, vel=np.gradient(pos, step, axis=0),
                 ref_time=dt.datetime(2021, 7, 1, 12, 0, 0))


def cube_finite(name, ds, n_heights, min_pixels) -> dict:
    w, h = np.asarray(ds['wet'].data), np.asarray(ds['hydro'].data)
    fin = float(np.mean(np.isfinite(w) & np.isfinite(h)))
    check(w.shape[0] == n_heights and w.shape[1] * w.shape[2] >= min_pixels,
          f'{name} cube {w.shape} too small')
    check(fin >= 0.99, f'{name} finite share {fin} < 0.99')
    return dict(shape=list(w.shape), finite=fin, mean_wet=float(np.nanmean(w[0])),
                mean_hydro=float(np.nanmean(h[0])))


def rays_f64(torch, wm, geom, flat, re_local):
    """A float64 reference of one slice's integrate on the rays ``flat``,
    independent of the packed and brick tables: every point of the packed
    modes' quadrature (``build_sampling_plan``) placed on its segment with
    the sagitta, an 8-corner gather of the float64 cubes
    (``interp3d_points``) and the trapezoid weights, all points at once."""
    from raider_tpu_torch.delay.raytrace import build_sampling_plan
    from raider_tpu_torch.ops.interp import interp3d_points

    g = {k: geom[k][:, flat].double() for k in ('bnd_y', 'bnd_x', 'bnd_z', 'd2', 'ray_len')}
    lvl, frac, wa_lvl, wa, wb_lvl, wb = build_sampling_plan(geom['per_level_max'])
    lv = torch.as_tensor(lvl, dtype=torch.int64, device=DEVICE)
    f = torch.as_tensor(frac, dtype=torch.float64, device=DEVICE)[:, None]

    def along(key):
        lo = g[key][lv]
        return lo + f * (g[key][lv + 1] - lo)

    def weight(w, w_lvl):
        return (torch.as_tensor(w, dtype=torch.float64, device=DEVICE)[:, None]
                * g['ray_len'][torch.as_tensor(w_lvl, dtype=torch.int64, device=DEVICE)])

    py, px, pz = along('bnd_y'), along('bnd_x'), along('bnd_z')
    hbar = 0.5 * (g['bnd_z'][lv] + g['bnd_z'][lv + 1])
    pz = pz - f * (1.0 - f) * g['d2'][lv] / (2.0 * (re_local.double() + hbar))
    zs = np.asarray(wm.zs)
    pz = pz.clamp(float(zs[0]), float(zs[-1]))
    rl = weight(wa, wa_lvl) + weight(wb, wb_lvl)
    ys_k, xs_k = wm.ys - wm.ys[0], wm.xs - wm.xs[0]
    return [(1e-6 * rl * interp3d_points(wm.field(k, torch.float64), ys_k, xs_k, zs,
                                         py, px, pz)).sum(0) for k in ('wet', 'hydro')]


def subgrid_check(torch, wm, ds_r, los, zref, height=WX_HEIGHTS[0]):
    """The slice at ``height`` (0 m) of a raytraced request on a 64x64
    sub-grid against references from the same geometry: the brick twin
    (kernel B2/K4's) for a brick mode, and for every mode the float64
    reference of :func:`rays_f64`. Returns (mode, max |diff| to the twin or
    None, to the float64 reference, seconds of the slice's geometry, ms of
    its integrate)."""
    from raider_tpu_torch.delay import engine
    from raider_tpu_torch.delay.raytrace import (integrate_bricks_ref, integrate_rays,
                                                 pack_cubes, slice_plan)
    from raider_tpu_torch.geodesy import get_Re
    from raider_tpu_torch.scripts import cuda_ms

    ys_o, xs_o = np.asarray(ds_r.coords['y'].data), np.asarray(ds_r.coords['x'].data)
    xx, yy = np.meshgrid(xs_o, ys_o)
    lat = torch.as_tensor(yy.ravel(), dtype=torch.float64, device=DEVICE)
    lon = torch.as_tensor(xx.ravel(), dtype=torch.float64, device=DEVICE)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    geom = engine._slice_geometry(wm, lat, lon, height, los, zref)
    torch.cuda.synchronize()
    geom_s = time.perf_counter() - t0
    rows = np.linspace(0, ys_o.size - 1, 64).round().astype(int)
    cols = np.linspace(0, xs_o.size - 1, 64).round().astype(int)
    flat = torch.as_tensor((rows[:, None] * xs_o.size + cols[None, :]).ravel(), device=DEVICE)
    hh = int(np.flatnonzero(np.asarray(ds_r.coords['z'].data) == height)[0])
    main = [np.asarray(ds_r[k].data)[hh][rows[:, None], cols[None, :]].ravel()
            for k in ('wet', 'hydro')]

    def err(w, h):
        return float(max(np.max(np.abs(w.cpu().numpy() - main[0])),
                         np.max(np.abs(h.cpu().numpy() - main[1]))))

    cw, ch = wm.field('wet', torch.float32), wm.field('hydro', torch.float32)
    ys_k, xs_k = wm.ys - wm.ys[0], wm.xs - wm.xs[0]
    table, mode = pack_cubes(cw, ch, grouped=True)
    twin_err = None
    if mode in ('brick', 'brick_i16'):
        keys = ('bnd_y', 'bnd_x', 'bnd_z', 'd2', 'ray_len')
        plan = slice_plan(cw.shape, np.float32 if mode == 'brick' else np.int16, ys_k, xs_k,
                          wm.zs, geom['per_level_max'], geom['heights'], geom['hstep_max'])
        tab, deq = table if mode == 'brick_i16' else (table, None)
        twin_err = err(*integrate_bricks_ref(tab, *[geom[k][:, flat].float().contiguous()
                                                    for k in keys],
                                             get_Re(lat[flat]).float(), plan, ys_k, xs_k,
                                             wm.zs, deq=deq))
    ref_err = err(*rays_f64(torch, wm, geom, flat, get_Re(lat[flat])))
    full = [geom[k].float().contiguous() for k in ('bnd_y', 'bnd_x', 'bnd_z', 'd2', 'ray_len')]
    slice_ms = cuda_ms(lambda: integrate_rays(
        cw, ch, ys_k, xs_k, wm.zs, *full, get_Re(lat).float(), geom['per_level_max'],
        packed2d=table, mode=mode, heights=geom['heights'], hstep_max=geom['hstep_max']), reps=3)
    return mode, twin_err, ref_err, geom_s, slice_ms


def phase_hrrr(torch, kernels, tmp, card_s):
    """Phase 8a and 8b: HRRR CONUS from its raw file at native size, then
    the headline's zenith and raytraced requests on its LCC cube."""
    from raider_tpu_torch.delay import engine
    from raider_tpu_torch.geometry import BoundingBox, Raytracing, Zenith
    from raider_tpu_torch.scripts import cuda_ms, raw_weather
    from raider_tpu_torch.wx.base import make_raw_weather_data_filename
    from raider_tpu_torch.wx.registry import get_wm_by_name

    when = dt.datetime(2021, 7, 1, 12, 0, 0)
    model = get_wm_by_name('HRRR')[1]()
    model.setTime(when)
    model.set_wmLoc(tmp)
    raw = make_raw_weather_data_filename(tmp, model.Model(), when)
    sec = {}
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    raw_weather.write_hrrr(raw, seed=SEED, device=DEVICE)
    sec['write_raw_file'] = time.perf_counter() - t0
    gb = os.path.getsize(raw) / 1e9
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    kernels.reset_launch_counts()
    t0 = time.perf_counter()
    model.load(device=DEVICE)
    torch.cuda.synchronize()
    sec['load'] = time.perf_counter() - t0
    t0 = time.perf_counter()
    ds_wm = model.to_dataset()
    torch.cuda.synchronize()
    sec['to_dataset'] = time.perf_counter() - t0
    peak_load = torch.cuda.max_memory_allocated() / 1e9

    aoi_z = BoundingBox(WX_BOX, cube_spacing_in_m=SPACING_M)
    t0 = time.perf_counter()
    ds_z, _ = engine.tropo_delay(when, ds_wm, aoi_z, Zenith(), height_levels=WX_HEIGHTS,
                                 device=DEVICE)
    torch.cuda.synchronize()
    sec['zenith_request'] = time.perf_counter() - t0
    los = Raytracing(orbit=track_orbit(*WX_TRACK), time=when)
    aoi_r = BoundingBox(WX_BOX, cube_spacing_in_m=SPACING_M)
    t0 = time.perf_counter()
    ds_r, _ = engine.tropo_delay(when, ds_wm, aoi_r, los, height_levels=WX_HEIGHTS, device=DEVICE)
    torch.cuda.synchronize()
    sec['raytraced_request'] = time.perf_counter() - t0
    launches = dict(kernels.LAUNCHES)
    peak = torch.cuda.max_memory_allocated() / 1e9
    steps_model = get_wm_by_name('HRRR')[1]()
    steps_model.setTime(when)
    steps_model.set_wmLoc(tmp)
    steps = step_seconds(torch, steps_model)
    del steps_model
    sec['read_raw_file'] = steps['load_weather'] - steps['_get_heights']
    sec.update(steps)

    shape = tuple(model._t.shape)
    equal = b1_against_twin(torch, model)
    ztd_ms = cuda_ms(model._get_ztd)
    say(f'phase 8a [{card_s}] HRRR CONUS from its raw file ({gb:.3f} GB netCDF-3, '
        f'{raw_weather.DOMAINS["HRRR"][0]} native levels): model (y, x, z) {shape}, '
        f'{model.getProjection().to_cf()["grid_mapping_name"]}, no query bounds (the whole '
        f'grid); seconds (the steps and the read from a second load, synchronized around '
        f'each step) ' + json.dumps({k: round(v, 4) for k, v in sec.items()})
        + f'; peak device memory {peak_load:.2f} GB; B1 equal to its twin {equal}; '
        f'_get_ztd alone {ztd_ms:.3f} ms')
    check(equal, 'phase 8a: B1 differs from its twin on the HRRR CONUS fields')
    check(launches['ztd_totals'] >= 1, f'B1 was not launched on the HRRR load: {launches}')
    check(shape[:2] == raw_weather.DOMAINS['HRRR'][1][1:3], f'HRRR CONUS model grid {shape}')
    res = dict(seconds=sec, raw_gb=gb, model_shape=list(shape), load_peak_gb=peak_load,
               request_peak_gb=peak, get_ztd_ms=ztd_ms, b1_equal=equal)

    zen = cube_finite('8b zenith', ds_z, len(WX_HEIGHTS), MIN_PIXELS)
    ray = cube_finite('8b raytraced', ds_r, len(WX_HEIGHTS), MIN_PIXELS)
    check(1.5 < zen['mean_hydro'] < 3.0, f'8b zenith hydrostatic delay {zen["mean_hydro"]} m')
    slant = ray['mean_hydro'] / zen['mean_hydro']
    check(1.0 < slant < 2.0, f'8b slant/zenith hydrostatic ratio {slant} outside 1-2')
    wm = engine.WeatherCube(ds_wm, DEVICE)
    mode, twin_err, ref_err, geom_s, slice_ms = subgrid_check(torch, wm, ds_r, los,
                                                              float(wm.zs.max() - 1))
    ref_tol = I16_TOL if mode.endswith('i16') else SUBGRID_TOL
    inc = incidence_range(torch, los, ds_r)
    say(f'phase 8b [{card_s}] requests on the LCC cube {tuple(np.shape(ds_wm["wet"].data))}: '
        f'zenith {zen}, raytraced {ray} (incidence {inc[0]:.1f}-{inc[1]:.1f} deg), slant/zenith '
        f'{slant:.4f}; the ladder chose {mode}; 0 m slice geometry {geom_s:.3f} s, integrate '
        f'{slice_ms:.3f} ms; 64x64 sub-grid vs the float64 reference max |diff| '
        f'{ref_err:.3e} m (bound {ref_tol:g} m), vs the brick twin {twin_err}; '
        f'launches {launches}; peak device memory {peak:.2f} GB')
    check(ref_err <= ref_tol, f'8b sub-grid vs the float64 reference {ref_err} m > {ref_tol} m')
    check(twin_err is None or twin_err <= SUBGRID_TOL,
          f'8b sub-grid twin check {twin_err} m > {SUBGRID_TOL} m')
    check(20.0 <= inc[0] and inc[1] <= 50.0, f'8b incidence {inc} outside 20-50 deg')
    res.update(zenith=zen, raytraced=ray, pack_mode=mode, subgrid_twin_err=twin_err,
               subgrid_f64_err=ref_err, slice_geometry_s=geom_s, slice_integrate_ms=slice_ms,
               incidence_deg=list(inc))
    del model, ds_wm, wm, ds_z, ds_r
    torch.cuda.empty_cache()
    return launches, res


def incidence_range(torch, los, ds_r):
    """Min and max incidence [deg] of the request's pixels at 0 m."""
    from raider_tpu_torch.geodesy.ellipsoid import geodetic_normal, lla2ecef

    ys_o, xs_o = np.asarray(ds_r.coords['y'].data), np.asarray(ds_r.coords['x'].data)
    lat = torch.as_tensor(ys_o[[0, 0, -1, -1]], dtype=torch.float64, device=DEVICE)
    lon = torch.as_tensor(xs_o[[0, -1, 0, -1]], dtype=torch.float64, device=DEVICE)
    hts = torch.zeros_like(lat)
    xyz = torch.stack(lla2ecef(lat, lon, hts), dim=-1)
    look = los.getLookVectors(0.0, [lon, lat, hts], xyz)
    cosi = (look * geodetic_normal(lat, lon)).sum(-1) / look.norm(dim=-1)
    inc = torch.rad2deg(torch.acos(cosi.abs())).cpu().numpy()
    return float(inc.min()), float(inc.max())


def phase_families(torch, kernels, tmp, card_s):
    """Phase 8c: every other family from its raw file through ``load`` at its
    native level count, B1 against its twin, a zenith request."""
    from raider_tpu_torch.delay import engine
    from raider_tpu_torch.geometry import BoundingBox, Zenith
    from raider_tpu_torch.scripts import raw_weather
    from raider_tpu_torch.wx.base import make_raw_weather_data_filename
    from raider_tpu_torch.wx.registry import get_wm_by_name

    total, res = {}, {}
    for name, when, bounds, box in WX_FAMILIES:
        model = get_wm_by_name(name)[1]()
        model.setTime(when)
        model.set_wmLoc(tmp)
        if bounds is not None:
            model.set_latlon_bounds(bounds)
        raw = make_raw_weather_data_filename(tmp, model.Model(), when)
        sec = {}
        t0 = time.perf_counter()
        raw_weather.write(name, raw, seed=SEED, device=DEVICE)
        sec['write_raw_file'] = time.perf_counter() - t0
        torch.cuda.synchronize()
        kernels.reset_launch_counts()
        t0 = time.perf_counter()
        model.load(device=DEVICE)
        ds_wm = model.to_dataset()
        torch.cuda.synchronize()
        sec['load'] = time.perf_counter() - t0
        t0 = time.perf_counter()
        ds_z, _ = engine.tropo_delay(when, ds_wm, BoundingBox(box, cube_spacing_in_m=ZENITH_SPACING_M),
                                     Zenith(), height_levels=WX_HEIGHTS, device=DEVICE)
        torch.cuda.synchronize()
        sec['zenith_request'] = time.perf_counter() - t0
        got = dict(kernels.LAUNCHES)
        for k, v in got.items():
            total[k] = total.get(k, 0) + v
        equal = b1_against_twin(torch, model)
        zen = cube_finite(f'8c {name} zenith', ds_z, len(WX_HEIGHTS), 10_000)
        levels = raw_weather.DOMAINS[name][0]
        say(f'phase 8c [{card_s}] {name} ({levels} native levels, '
            f'{model.getProjection().to_cf()["grid_mapping_name"]}): model (y, x, z) '
            f'{tuple(model._t.shape)}; B1 equal to its twin {equal}, launches {got["ztd_totals"]}; '
            f'zenith {zen}; seconds ' + json.dumps({k: round(v, 4) for k, v in sec.items()}))
        check(equal, f'phase 8c: B1 differs from its twin on {name}')
        check(got['ztd_totals'] >= 1, f'B1 was not launched on the {name} load: {got}')
        check(1.5 < zen['mean_hydro'] < 3.0, f'8c {name} zenith hydrostatic {zen["mean_hydro"]} m')
        res[name] = dict(levels=levels, model_shape=list(model._t.shape), b1_equal=equal,
                         zenith=zen, seconds=sec)
        os.remove(raw)
        del model, ds_wm, ds_z
    torch.cuda.empty_cache()
    return total, res


def phase_crs(torch, card_s):
    """Phase 8d: the projected CRSs forward and inverse on the card against
    the CPU, on 2^20 seeded points each."""
    from raider_tpu_torch.geodesy import utm_crs
    from raider_tpu_torch.scripts import cuda_ms
    from raider_tpu_torch.wx.hrrr import HRRR_AK_PROJ, HRRR_CONUS_PROJ

    rng = np.random.default_rng(SEED + 3)
    res = {}
    for name, crs, (w, e, s, n) in (('lcc_hrrr', HRRR_CONUS_PROJ, (-135.0, -60.0, 20.0, 55.0)),
                                    ('polar_stereographic_hrrr_ak', HRRR_AK_PROJ,
                                     (-180.0, 180.0, 40.0, 85.0)),
                                    ('utm_14n', utm_crs(14), (-102.0, -96.0, 0.0, 80.0)),
                                    ('utm_23s', utm_crs(23, south=True), (-48.0, -42.0, -80.0, 0.0))):
        lon_h = torch.as_tensor(rng.uniform(w, e, CRS_POINTS))
        lat_h = torch.as_tensor(rng.uniform(s, n, CRS_POINTS))
        lon_d, lat_d = lon_h.to(DEVICE), lat_h.to(DEVICE)
        xd, yd = crs.forward(lon_d, lat_d)
        xh, yh = crs.forward(lon_h, lat_h)
        err_m = float(max((xd.cpu() - xh).abs().max(), (yd.cpu() - yh).abs().max()))
        ld, bd = crs.inverse(xh.to(DEVICE), yh.to(DEVICE))
        lh, bh = crs.inverse(xh, yh)
        dlon = torch.remainder(ld.cpu() - lh + 180.0, 360.0) - 180.0
        err_deg = float(max(dlon.abs().max(), (bd.cpu() - bh).abs().max()))
        xdd, ydd = xd, yd
        r = dict(max_abs_m=err_m, max_abs_deg=err_deg,
                 forward_ms=cuda_ms(lambda: crs.forward(lon_d, lat_d)),
                 inverse_ms=cuda_ms(lambda: crs.inverse(xdd, ydd)))
        t0 = time.perf_counter()
        crs.forward(lon_h, lat_h)
        r['cpu_forward_ms'] = (time.perf_counter() - t0) * 1e3
        say(f'phase 8d [{card_s}] {name} on {CRS_POINTS} points, card vs CPU: forward max '
            f'|diff| {err_m:.3e} m, inverse {err_deg:.3e} deg; card forward {r["forward_ms"]:.3f} ms, '
            f'inverse {r["inverse_ms"]:.3f} ms; CPU forward {r["cpu_forward_ms"]:.1f} ms')
        check(err_m <= CRS_TOL_M, f'8d {name}: card vs CPU {err_m} m > {CRS_TOL_M} m')
        check(err_deg <= CRS_TOL_DEG, f'8d {name}: card vs CPU {err_deg} deg > {CRS_TOL_DEG} deg')
        res[name] = r
    return res


def load_for(torch, tmp, aoi, los=None, whole=False) -> tuple:
    """The calc-delays steps on the raw HRRR CONUS file: ``aoi`` buffered by
    the model's grid, its output grid on EPSG:4326, the model's bounds
    (widened toward the sensor for a Raytracing ``los``), the raw file HRRR's
    fetcher writes for those bounds (cut from 8a's whole-grid file into a
    directory of its own; ``whole``: 8a's file itself), then ``load`` and
    ``to_dataset``. Returns (dataset, model grid, seconds of the cut, of
    the load)."""
    from raider_tpu_torch.geometry import Raytracing
    from raider_tpu_torch.scripts import raw_weather
    from raider_tpu_torch.wx.base import make_raw_weather_data_filename
    from raider_tpu_torch.wx.registry import get_wm_by_name

    model = get_wm_by_name('HRRR')[1]()
    model.setTime(PT_TIME)
    aoi.add_buffer(model.getLLRes())
    aoi.set_output_xygrid(4326)
    if isinstance(los, Raytracing):
        bounds = aoi.calc_buffer_ray(los.getSensorDirection(), lookDir=los.getLookDirection(),
                                     incAngle=30)
    else:
        bounds = aoi.bounds()
    model.set_latlon_bounds(bounds, output_spacing=aoi.get_output_spacing())
    t0 = time.perf_counter()
    if whole:
        model.set_wmLoc(tmp)
    else:
        model.set_wmLoc(tempfile.mkdtemp(dir=tmp))
        raw_weather.crop_hrrr(make_raw_weather_data_filename(tmp, 'HRRR', PT_TIME),
                              make_raw_weather_data_filename(model.get_wmLoc(), 'HRRR', PT_TIME),
                              model.get_latlon_bounds())
    cut_s = time.perf_counter() - t0
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    model.load(device=DEVICE)
    ds_wm = model.to_dataset()
    torch.cuda.synchronize()
    return ds_wm, list(model._t.shape), cut_s, time.perf_counter() - t0


def request(torch, ds_wm, aoi, los, heights=None) -> tuple:
    """``tropo_delay`` on the card, its steps timed: the AOI read (readLL,
    readZ), the point step, the slice geometry and ``state_to_los_factor``.
    Returns (result, seconds, the point step's arguments, pack mode)."""
    from raider_tpu_torch.delay import engine
    from raider_tpu_torch.geometry import los as los_module

    with timed_calls(torch, aoi, ('readLL', 'readZ')) as read, \
            timed_calls(torch, engine, ('_delays_at_points', '_slice_geometry',
                                        'pack_cubes')) as eng, \
            timed_calls(torch, los_module, ('state_to_los_factor',)) as fac:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = engine.tropo_delay(PT_TIME, ds_wm, aoi, los, height_levels=heights, device=DEVICE)
        torch.cuda.synchronize()
        total = time.perf_counter() - t0
    # readZ of a DEM-backed AOI includes a readLL of its own
    sec = {'tropo_delay': total, 'readLL': read['readLL']['seconds'],
           'readZ': read['readZ']['seconds'],
           'point_step': eng['_delays_at_points']['seconds'],
           'slice_geometry': eng['_slice_geometry']['seconds'],
           'slices': eng['_slice_geometry']['calls'],
           'state_to_los_factor': fac['state_to_los_factor']['seconds']}
    mode = eng['pack_cubes']['out'][1] if eng['pack_cubes']['calls'] else None
    return out, sec, eng['_delays_at_points'].get('args'), mode


def points_vs_scipy(ds, lat, lon, hgt, got) -> float:
    """Max |diff| of the point delays ``got`` (wet, hydro) to scipy's
    RegularGridInterpolator in float64 on the host, on the same cube at the
    same points; the NaN masks must agree."""
    from scipy.interpolate import RegularGridInterpolator

    z, y, x = (np.asarray(ds.coords[k].data, dtype=np.float64) for k in ('z', 'y', 'x'))
    pts = np.stack([np.ravel(a) for a in (hgt, lat, lon)], -1)
    err = 0.0
    for name, g in zip(('wet', 'hydro'), got):
        cube = np.asarray(ds[name].data, dtype=np.float64)
        zz, yy = z, y
        if z.size > 1 and z[0] > z[-1]:
            zz, cube = z[::-1], cube[::-1]
        if y[0] > y[-1]:
            yy, cube = y[::-1], cube[:, ::-1]
        ref = RegularGridInterpolator((zz, yy, x), cube, bounds_error=False,
                                      fill_value=np.nan)(pts)
        g = np.asarray(g, dtype=np.float64).ravel()
        check(np.array_equal(np.isnan(ref), np.isnan(g)), f'{name}: NaN masks differ from scipy')
        err = max(err, float(np.nanmax(np.abs(ref - g))))
    return err


def point_stats(wet, hydro, valid) -> dict:
    """Finite share of the points where ``valid`` (finite heights), and the
    mean delays there."""
    fin = np.isfinite(wet) & np.isfinite(hydro)
    return dict(points=int(wet.size), valid=int(valid.sum()), finite=float(fin[valid].mean()),
                mean_wet=float(np.nanmean(wet[valid])), mean_hydro=float(np.nanmean(hydro[valid])))


def stations(torch, path):
    """9a's station CSV: N_STATIONS seeded stations drawn in the interior of
    the HRRR CONUS LCC grid, inverse-projected, heights 0-3000 m, and
    STATION_DUPLICATES duplicate rows."""
    from raider_tpu_torch.scripts import point_inputs, raw_weather
    from raider_tpu_torch.wx.hrrr import HRRR_CONUS_PROJ

    _, ny, nx, step, lat0, lon0 = raw_weather.DOMAINS['HRRR'][1]
    x0, y0 = (float(v) for v in HRRR_CONUS_PROJ.forward(lon0, lat0))
    rng = np.random.default_rng(SEED + 9)
    fx, fy = (rng.uniform(STATION_MARGIN, 1.0 - STATION_MARGIN, N_STATIONS) for _ in range(2))
    lon, lat = HRRR_CONUS_PROJ.inverse(torch.as_tensor(x0 + fx * step * (nx - 1)),
                                       torch.as_tensor(y0 + fy * step * (ny - 1)))
    return point_inputs.write_station_csv(path, lat.numpy(), lon.numpy(),
                                          rng.uniform(0.0, 3000.0, N_STATIONS),
                                          n_duplicates=STATION_DUPLICATES, seed=SEED + 9)


def phase_stations(torch, kernels, tmp, card_s):
    """9a: GNSS stations, zenith delays on the whole CONUS model."""
    from raider_tpu_torch.geometry import StationFile, Zenith

    csv_file = stations(torch, os.path.join(tmp, 'stations.csv'))
    torch.cuda.reset_peak_memory_stats()
    kernels.reset_launch_counts()
    t0 = time.perf_counter()
    aoi = StationFile(csv_file)
    sec = {'aoi': time.perf_counter() - t0}
    ds_wm, grid, _, sec['load'] = load_for(torch, tmp, aoi, whole=True)
    (wet, hydro), req, args, _ = request(torch, ds_wm, aoi, Zenith())
    launches = dict(kernels.LAUNCHES)
    sec.update(req)
    peak = torch.cuda.max_memory_allocated() / 1e9
    ds, (lat, lon, hgt) = args[0], (a.cpu().numpy() for a in args[1:4])
    err = points_vs_scipy(ds, lat, lon, hgt, (wet, hydro))
    st = point_stats(wet, hydro, np.isfinite(hgt))
    say(f'phase 9a [{card_s}] {N_STATIONS} GNSS stations ({STATION_DUPLICATES} duplicate rows '
        f'dropped to {wet.size}), zenith on the CONUS model (y, x, z) {tuple(grid)}, cube '
        f'{tuple(np.shape(ds["wet"].data))}: {st}; point step vs scipy float64 max |diff| '
        f'{err:.3e} m (bound {POINT_TOL:g} m); seconds '
        + json.dumps({k: round(v, 4) for k, v in sec.items()})
        + f'; launches {launches}; peak device memory {peak:.2f} GB')
    check(wet.size == N_STATIONS, f'9a: {wet.size} stations after de-duplication')
    check(st['finite'] >= 0.99, f'9a finite share {st["finite"]} < 0.99')
    check(1.5 < st['mean_hydro'] < 3.0, f'9a mean hydrostatic delay {st["mean_hydro"]} m')
    check(err <= POINT_TOL, f'9a point step vs scipy {err} m > {POINT_TOL} m')
    return launches, dict(stations=st, model_shape=grid, cube_shape=list(np.shape(ds['wet'].data)),
                          scipy_err=err, seconds=sec, peak_gb=peak)


def radar_inputs(torch, tmp, orbit):
    """9b/9c inputs: ENVI lat/lon/hgt rasters of a skewed radar grid (the
    heights seeded terrain with RDR_NODATA nodata pixels), the 2-band
    incidence/heading raster of the orbit's geometry, and the orbit's EOF."""
    from raider_tpu_torch.geodesy.ellipsoid import geodetic_normal, lla2ecef
    from raider_tpu_torch.geometry.orbit import geo2rdr
    from raider_tpu_torch.io import write_envi
    from raider_tpu_torch.scripts import point_inputs

    lat, lon = point_inputs.radar_grid(RDR_CENTER, RDR_SHAPE, RDR_EXTENT, RDR_SKEW)
    hgt = point_inputs.terrain(RDR_SHAPE, *RDR_HEIGHTS, seed=SEED + 9)
    la, lo, h = (torch.as_tensor(a, device=DEVICE) for a in (lat, lon, hgt))
    xyz = torch.stack(lla2ecef(la, lo, h), -1)
    _, sr, sat, _ = geo2rdr(*orbit.on(DEVICE), xyz)
    look = (sat - xyz) / sr[..., None]
    phi, lam = torch.deg2rad(la), torch.deg2rad(lo)
    east = torch.stack([-torch.sin(lam), torch.cos(lam), torch.zeros_like(lam)], -1)
    north = torch.stack([-torch.sin(phi) * torch.cos(lam), -torch.sin(phi) * torch.sin(lam),
                         torch.cos(phi)], -1)
    enu = torch.stack([(look * e).sum(-1) for e in (east, north, geodetic_normal(la, lo))], -1)
    inc, heading = point_inputs.inc_hd_from_look(enu.cpu().numpy())
    rng = np.random.default_rng(SEED + 10)
    hgt = hgt.copy()
    hgt.ravel()[rng.choice(hgt.size, RDR_NODATA, replace=False)] = NODATA
    f = {k: os.path.join(tmp, f'{k}.rdr') for k in ('lat', 'lon', 'hgt', 'los')}
    for k, a in (('lat', lat), ('lon', lon), ('hgt', hgt), ('los', np.stack([inc, heading]))):
        write_envi(a, f[k], nodata=NODATA)
    f['eof'] = point_inputs.write_eof(tmp, orbit)
    return f


def phase_radar(torch, kernels, tmp, card_s):
    """9b (raytraced) and 9c (zenith, then projected from the incidence
    raster and from the EOF) on a Sentinel-1 frame in radar coordinates."""
    from raider_tpu_torch.geometry import Conventional, RasterRDR, Raytracing, Zenith
    from raider_tpu_torch.geometry.orbit import get_orbit, read_ESA_orbit_file, state_to_los_factor
    from raider_tpu_torch.io import rio_open
    from raider_tpu_torch.geometry.los import inc_hd_to_enu

    orbit = track_orbit(*WX_TRACK, step=EOF_STEP)
    t0 = time.perf_counter()
    f = radar_inputs(torch, tmp, orbit)
    write_s = time.perf_counter() - t0
    times, pos, vel = read_ESA_orbit_file(f['eof'])
    eof_err = float(max(np.abs(pos - orbit.pos).max(), np.abs(vel - orbit.vel).max()))
    check(times == [orbit.ref_time + dt.timedelta(seconds=float(t)) for t in orbit.times]
          and eof_err <= 5e-7 + 1e-8, f'9b: the EOF read differs from the orbit by {eof_err}')

    def raster_aoi():
        return RasterRDR(f['lat'], f['lon'], f['hgt'])

    # 9b: raytraced from the EOF, at the model's levels
    torch.cuda.reset_peak_memory_stats()
    kernels.reset_launch_counts()
    t0 = time.perf_counter()
    aoi = raster_aoi()
    los = Raytracing(filename=f['eof'], time=PT_TIME)
    sec = {'aoi': time.perf_counter() - t0}
    ds_wm, grid, sec['fetch_cut'], sec['load'] = load_for(torch, tmp, aoi, los)
    (wet_r, hyd_r), req, args, mode = request(torch, ds_wm, aoi, los)
    launches_b = dict(kernels.LAUNCHES)
    sec.update(req)
    peak = torch.cuda.max_memory_allocated() / 1e9
    ds_r, (lat, lon, hgt) = args[0], (a.cpu().numpy() for a in args[1:4])
    valid = np.isfinite(hgt)
    ray = point_stats(wet_r, hyd_r, valid)
    rows = np.linspace(0, RDR_SHAPE[0] - 1, PATCH).round().astype(int)[:, None]
    cols = np.linspace(0, RDR_SHAPE[1] - 1, PATCH).round().astype(int)[None, :]
    err_b = points_vs_scipy(ds_r, lat[rows, cols], lon[rows, cols], hgt[rows, cols],
                            (wet_r[rows, cols], hyd_r[rows, cols]))
    nodata_nan = bool(np.isnan(wet_r[~valid]).all() and np.isnan(hyd_r[~valid]).all())
    del ds_wm, ds_r, args

    # 9c: zenith and projected on the same raster (one load: same bounds)
    kernels.reset_launch_counts()
    t0 = time.perf_counter()
    aoi = raster_aoi()
    sec_c = {'aoi': time.perf_counter() - t0}
    ds_wm, grid_c, sec_c['fetch_cut'], sec_c['load'] = load_for(torch, tmp, aoi)
    (wet_z, hyd_z), sec_c['zenith'], _, _ = request(torch, ds_wm, aoi, Zenith())
    (wet_i, hyd_i), sec_c['projected_raster'], _, _ = request(
        torch, ds_wm, aoi, Conventional(f['los'], time=PT_TIME))
    (wet_o, hyd_o), sec_c['projected_orbit'], _, _ = request(
        torch, ds_wm, aoi, Conventional(f['eof'], time=PT_TIME))
    launches_c = dict(kernels.LAUNCHES)
    del ds_wm
    zen = point_stats(wet_z, hyd_z, valid)
    both = valid & np.isfinite(hyd_r) & np.isfinite(hyd_z)
    ratio = hyd_r[both] / hyd_z[both]
    slant = dict(mean=float(ratio.mean()), min=float(ratio.min()), max=float(ratio.max()),
                 within_1_2=float(np.mean((ratio > 1.0) & (ratio < 2.0))))
    los_data, _ = rio_open(f['los'])
    factor_i = inc_hd_to_enu(*los_data)[..., -1]
    orbit_f = get_orbit(f['eof'], PT_TIME)
    dev = [torch.as_tensor(a, device=DEVICE) for a in (lat, lon, hgt)]
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    factor_o = state_to_los_factor(orbit_f, *dev)
    torch.cuda.synchronize()
    factor_s = time.perf_counter() - t0
    factor_o = factor_o.cpu().numpy()
    sub = (rows, cols)
    card_cpu = float(np.nanmax(np.abs(
        state_to_los_factor(orbit_f, *(d[sub] for d in dev)).cpu().numpy()
        - state_to_los_factor(orbit_f, *(a[sub] for a in (lat, lon, hgt))).numpy())))

    def rel(got, zenith, factor):
        r = np.abs(got - zenith / factor) / np.abs(zenith / factor)
        return float(np.nanmax(r))

    proj = dict(raster=max(rel(wet_i, wet_z, factor_i), rel(hyd_i, hyd_z, factor_i)),
                orbit=max(rel(wet_o, wet_z, factor_o), rel(hyd_o, hyd_z, factor_o)))
    inc = np.rad2deg(np.arccos(factor_o[valid]))
    inc_range = (float(np.nanmin(inc)), float(np.nanmax(inc)))

    say(f'phase 9b [{card_s}] a radar frame {RDR_SHAPE} ({np.prod(RDR_SHAPE)} pixels, {RDR_NODATA} '
        f'nodata heights), raytraced from an EOF file ({len(times)} statevectors, read max |diff| '
        f'{eof_err:.2e}): model (y, x, z) {tuple(grid)}, the ladder chose {mode}; {ray}; nodata '
        f'heights give NaN {nodata_nan}; slant/zenith hydrostatic {slant}; {PATCH}x{PATCH} patch vs '
        f'scipy float64 max |diff| {err_b:.3e} m; seconds (inputs written {write_s:.2f}) '
        + json.dumps({k: round(v, 4) for k, v in sec.items()})
        + f'; launches {launches_b}; peak device memory {peak:.2f} GB')
    say(f'phase 9c [{card_s}] the same frame, zenith {zen} and projected: max relative |delay - '
        f'zenith / factor| {proj} (bound {PROJ_REL_TOL:g}); incidence {inc_range[0]:.2f}-'
        f'{inc_range[1]:.2f} deg; state_to_los_factor on {lat.size} points {factor_s:.4f} s, '
        f'card vs CPU on {PATCH}x{PATCH} max |diff| {card_cpu:.3e}; seconds '
        + json.dumps({k: ({kk: round(vv, 4) for kk, vv in v.items()} if isinstance(v, dict)
                          else round(v, 4)) for k, v in sec_c.items()})
        + f'; launches {launches_c}')
    check(mode == 'brick', f'9b: the ladder chose {mode}, not brick, on the cropped cube')
    check(launches_b['ztd_totals'] >= 1 and launches_b['brick_integrate'] >= 1,
          f'9b: B1 or B2 not launched: {launches_b}')
    check(ray['finite'] >= 0.99, f'9b finite share {ray["finite"]} < 0.99')
    check(nodata_nan, '9b: a nodata height gave a delay')
    check(slant['within_1_2'] >= 0.99 and 1.0 < slant['mean'] < 2.0,
          f'9b slant/zenith ratio {slant}')
    check(err_b <= POINT_TOL, f'9b point step vs scipy {err_b} m > {POINT_TOL} m')
    check(zen['finite'] >= 0.99, f'9c zenith finite share {zen["finite"]} < 0.99')
    check(max(proj.values()) <= PROJ_REL_TOL, f'9c projected vs zenith / factor {proj}')
    check(card_cpu <= FACTOR_TOL, f'9c state_to_los_factor card vs CPU {card_cpu} > {FACTOR_TOL}')
    check(20.0 <= inc_range[0] and inc_range[1] <= 50.0, f'9c incidence {inc_range} outside 20-50')
    launches = {k: launches_b[k] + launches_c[k] for k in launches_b}
    return launches, dict(raytraced=ray, zenith=zen, pack_mode=mode, slant_zenith=slant,
                          scipy_err=err_b, eof_read_err=eof_err, projected_rel=proj,
                          incidence_deg=list(inc_range), factor_card_cpu=card_cpu,
                          factor_s=factor_s, seconds_9b=sec, seconds_9c=sec_c, model_shape=grid,
                          peak_gb=peak, inputs_s=write_s)


def phase_geocoded(torch, kernels, tmp, card_s):
    """9d: a geocoded DEM (GeoTIFF) and a GUNW-style geocube (netCDF-3)."""
    from raider_tpu_torch.geodesy import Geographic
    from raider_tpu_torch.geometry import GeocodedFile, Geocube, Raytracing, Zenith
    from raider_tpu_torch.io import GDALAffine, write_gtiff
    from raider_tpu_torch.scripts import point_inputs

    t0 = time.perf_counter()
    dem = point_inputs.terrain(DEM_SHAPE, *RDR_HEIGHTS, seed=SEED + 11).astype(np.float32)
    w, n = DEM_ORIGIN
    px = 1.0 / DEM_SHAPE[1]
    dem_file = os.path.join(tmp, 'dem.tif')
    write_gtiff(dem, dem_file, transform=GDALAffine((w, px, 0.0, n, 0.0, -1.0 / DEM_SHAPE[0])),
                crs=Geographic(), compress=True)
    cube_file = point_inputs.write_geocube(
        os.path.join(tmp, 'geocube.nc'), np.linspace(n - 1.0, n, GEOCUBE_SHAPE[0]),
        np.linspace(w, w + 1.0, GEOCUBE_SHAPE[1]), GEOCUBE_HEIGHTS)
    write_s = time.perf_counter() - t0
    del dem

    torch.cuda.reset_peak_memory_stats()
    kernels.reset_launch_counts()
    t0 = time.perf_counter()
    aoi = GeocodedFile(dem_file, is_dem=True)
    sec = {'aoi': time.perf_counter() - t0}
    ds_wm, grid_d, sec['fetch_cut'], sec['load'] = load_for(torch, tmp, aoi)
    (wet, hydro), req, args, _ = request(torch, ds_wm, aoi, Zenith())
    sec.update(req)
    del ds_wm
    valid = np.isfinite(args[3].cpu().numpy())
    st = point_stats(wet, hydro, valid)
    st['valid_share'] = float(valid.mean())
    del args

    cubes, sec_g = {}, {}
    los = Raytracing(orbit=track_orbit(*WX_TRACK), time=PT_TIME)
    for name, l in (('zenith', Zenith()), ('raytraced', los)):
        aoi = Geocube(cube_file)
        ds_wm, grid_g, cut_s, load_s = load_for(torch, tmp, aoi, l)
        (ds, none), req, _, mode = request(torch, ds_wm, aoi, l)
        check(none is None, f'9d geocube {name}: a cube-type AOI returns (Dataset, None)')
        req.update(fetch_cut=cut_s, load=load_s)
        sec_g[name] = req
        z = np.asarray(ds.coords['z'].data)
        inside = z >= float(np.min(ds_wm.coords['z'].data))
        w3, h3 = (np.asarray(ds[k].data) for k in ('wet', 'hydro'))
        fin = np.isfinite(w3) & np.isfinite(h3)
        k0 = int(np.argmin(np.abs(z)))
        cubes[name] = dict(shape=list(w3.shape), model_shape=grid_g, mode=mode,
                           finite_all=float(fin.mean()),
                           finite_in_model=float(fin[inside].mean()),
                           mean_hydro_0m=float(np.nanmean(h3[k0])))
        check(np.array_equal(z, GEOCUBE_HEIGHTS), f'9d geocube {name} heights {z}')
        del ds_wm, ds
    launches = dict(kernels.LAUNCHES)
    peak = torch.cuda.max_memory_allocated() / 1e9
    say(f'phase 9d [{card_s}] a geocoded DEM {DEM_SHAPE} (GeoTIFF, deflate) at its '
        f'{int(np.prod(DEM_SHAPE))} pixels, zenith on the model (y, x, z) {tuple(grid_d)}: {st}; '
        'seconds '
        + json.dumps({k: round(v, 4) for k, v in sec.items()})
        + f'; a geocube {GEOCUBE_SHAPE} x {GEOCUBE_HEIGHTS.size} heights '
        f'({GEOCUBE_HEIGHTS[0]:g} to {GEOCUBE_HEIGHTS[-1]:g} m): {cubes}; seconds '
        + json.dumps({k: {kk: round(vv, 4) for kk, vv in v.items()} for k, v in sec_g.items()})
        + f'; inputs written {write_s:.2f} s; launches {launches}; peak device memory {peak:.2f} GB')
    check(st['finite'] >= 0.99, f'9d DEM finite share {st["finite"]} < 0.99')
    check(1.5 < st['mean_hydro'] < 3.0, f'9d DEM mean hydrostatic delay {st["mean_hydro"]} m')
    for name, c in cubes.items():
        check(c['finite_in_model'] >= 0.99, f'9d geocube {name} finite share {c}')
        check(1.5 < c['mean_hydro_0m'] < 3.0, f'9d geocube {name} hydrostatic delay at 0 m {c}')
    return launches, dict(dem=st, dem_seconds=sec, geocube=cubes, geocube_seconds=sec_g,
                          peak_gb=peak, inputs_s=write_s)


def phase_points(torch, kernels, tmp, card_s):
    """Phase 9: point requests through the calc-delays steps on the raw
    HRRR CONUS file of phase 8a. Returns its summed launches and record."""
    launches, record = {}, {}
    t0 = time.perf_counter()
    for name, fn in (('stations', phase_stations), ('radar', phase_radar),
                     ('geocoded', phase_geocoded)):
        got, record[name] = fn(torch, kernels, tmp, card_s)
        for k, v in got.items():
            launches[k] = launches.get(k, 0) + v
        torch.cuda.empty_cache()
    check(launches['ztd_totals'] >= 1 and launches['brick_integrate'] >= 1,
          f'phase 9: B1 or B2 not launched: {launches}')
    record.update(launches=launches, seconds=time.perf_counter() - t0)
    say(json.dumps({'point_requests': record}))
    return launches, record


@contextlib.contextmanager
def local_hrrr_fetcher(conus_raw):
    """HRRR's download (``wx.hrrr.download_hrrr_file``) replaced by a cut of
    the CONUS raw file for the bounds it is asked for
    (``raw_weather.crop_hrrr``), the humidity, pressure and temperature of
    each epoch scaled by factors drawn from the seed and the epoch (q by
    0.8-1.2, p by 0.98-1.02, T by 0.99-1.01); yields the list of (epoch,
    (q, p, T) scales) cut."""
    from raider_tpu_torch.scripts import raw_weather
    from raider_tpu_torch.wx import hrrr

    cuts, own = [], hrrr.download_hrrr_file

    def fetch(ll_bounds, date, out, model='hrrr', product='nat', fxx=0, verbose=False):
        rng = np.random.default_rng(SEED + int(date.strftime('%d%H')))
        q, p, t = (float(v) for v in rng.uniform([0.8, 0.98, 0.99], [1.2, 1.02, 1.01]))
        raw_weather.crop_hrrr(conus_raw, out, ll_bounds, q_scale=q, p_scale=p, t_scale=t)
        cuts.append((date, (q, p, t)))

    hrrr.download_hrrr_file = fetch
    try:
        yield cuts
    finally:
        hrrr.download_hrrr_file = own


def write_config(path, groups: dict) -> str:
    """A run config of phase 10 (written by the port's YAML writer)."""
    from raider_tpu_torch.workflows import yaml_subset

    cfg = {'look_dir': 'right', 'weather_model': 'HRRR', 'height_group': {}, 'los_group': {}}
    for k, v in groups.items():
        cfg[k] = {**cfg.get(k, {}), **v} if isinstance(v, dict) else v
    with open(path, 'w') as f:
        yaml_subset.dump(cfg, f)
    return path


def workflow_prep(cfg):
    """calcDelays' own set-up of a run config, repeated outside it (before
    the run: its ``checkArgs`` writes a station file's template CSV where
    the run writes its output): the run config, its AOI (buffered by the
    model's grid, its output grid set), LOS, and model (with the bounds it
    fetches and processes)."""
    from raider_tpu_torch.geometry import Raytracing
    from raider_tpu_torch.workflows.check_args import checkArgs
    from raider_tpu_torch.workflows.config import read_run_config_file

    rc = checkArgs(read_run_config_file(cfg))
    aoi, los, model = rc.aoi_group.aoi, rc.los_group.los, rc.weather_model
    aoi.add_buffer(model.getLLRes())
    aoi.set_output_xygrid(rc.runtime_group.output_projection)
    if isinstance(los, Raytracing):
        bounds = aoi.calc_buffer_ray(los.getSensorDirection(), lookDir=los.getLookDirection(),
                                     incAngle=30)
    else:
        bounds = aoi.bounds()
    model.set_latlon_bounds(bounds, output_spacing=aoi.get_output_spacing())
    return rc, aoi, los, model


def processed_file(model, when) -> str:
    model.setTime(when)
    return model.out_file(model.get_wmLoc())


def combined_file(first, when, style) -> str:
    """``combine_weather_files``' output name for the processed ``first``."""
    name = os.path.basename(first)
    return os.path.join(os.path.dirname(first), name.split('_')[0] + '_'
                        + when.strftime('%Y_%m_%dT%H_%M_%S') + style
                        + '_'.join(name.split('_')[-4:]))


def attrs_equal(a: dict, b: dict) -> bool:
    if set(a) != set(b):
        return False
    for k, v in a.items():
        w = b[k]
        if isinstance(v, str) or isinstance(w, str) or isinstance(v, (list, tuple)):
            if list(v) != list(w) if isinstance(v, (list, tuple)) else v != w:
                return False
        elif not np.array_equal(np.asarray(v), np.asarray(w)):
            return False
    return True


def same_values(torch, a, b: np.ndarray) -> bool:
    """``a`` (an array, or a tensor on the card: compared there) equals the
    host array ``b`` bit for bit in value and dtype, NaN where NaN."""
    if isinstance(a, torch.Tensor):
        if a.shape != b.shape or str(a.dtype) != f'torch.{b.dtype}':
            return False
        b = torch.as_tensor(b, device=a.device)
        same = a == b
        if a.is_floating_point():
            same |= torch.isnan(a) & torch.isnan(b)
        return bool(same.all())
    a = np.asarray(a)
    return a.dtype == b.dtype and np.array_equal(a, b, equal_nan=a.dtype.kind == 'f')


def same_dataset(torch, ds, path):
    """The netCDF-3 file ``path`` read back; whether it equals ``ds`` bit
    for bit: names, dims, dtypes, values (NaN where NaN) and attributes."""
    from raider_tpu_torch.io import read_nc

    back = read_nc(path)
    if set(back.coords) != set(ds.coords) or set(back.variables) != set(ds.variables):
        return back, False
    for group, back_group in ((ds.coords, back.coords), (ds.variables, back.variables)):
        for name, var in group.items():
            if (tuple(var.dims) != tuple(back_group[name].dims)
                    or not same_values(torch, var.data, np.asarray(back_group[name].data))
                    or not attrs_equal(var.attrs, back_group[name].attrs)):
                return back, False
    return back, attrs_equal(ds.attrs, back.attrs)


@contextlib.contextmanager
def recorded_writes(torch):
    """Every ``write_nc`` of the workflow (the processed models in
    ``wx.base``, the combined files and cubes in ``calc_delays``) timed,
    then read back and held against the dataset it wrote (untimed); the
    datasets read back are kept by path, for the direct calls."""
    from raider_tpu_torch.workflows import calc_delays
    from raider_tpu_torch.wx import base

    rec = {'model': 0.0, 'combined': 0.0, 'output': 0.0, 'files': [], 'equal': [],
           'check_model': 0.0, 'check_combined': 0.0, 'check_output': 0.0, 'back': {}}
    owners = (base, calc_delays)
    own = [o.write_nc for o in owners]

    def wrap(fn, owner):
        def write(ds, path, *args, **kwargs):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = fn(ds, path, *args, **kwargs)
            kind = ('model' if owner is base else
                    'combined' if '_timeInterp' in os.path.basename(str(path)) else 'output')
            t1 = time.perf_counter()
            rec[kind] += t1 - t0
            rec['files'].append(str(path))
            back, equal = same_dataset(torch, ds, path)
            rec['equal'].append(equal)
            rec['back'][str(path)] = back
            rec['check_' + kind] += time.perf_counter() - t1
            return out
        return write

    for o, fn in zip(owners, own):
        o.write_nc = wrap(fn, o)
    try:
        yield rec
    finally:
        for o, fn in zip(owners, own):
            o.write_nc = fn


@contextlib.contextmanager
def recorded_loads():
    """Each ``WeatherModel.load``: whether it processed a raw file (it
    returned None) and on which thread."""
    import threading

    from raider_tpu_torch.wx.base import WeatherModel

    rec = []
    own = WeatherModel.load

    def load(self, *args, **kwargs):
        out = own(self, *args, **kwargs)
        rec.append((out is None, threading.current_thread().name))
        return out

    WeatherModel.load = load
    try:
        yield rec
    finally:
        WeatherModel.load = own


def run_case(torch, kernels, cfg, conus_raw) -> dict:
    """One phase 10 case through ``cli.__main__.main`` on the card, each
    step timed: returns the paths, seconds, launches, loads, the netCDF-3
    write record and the peak device memory."""
    from raider_tpu_torch.cli.__main__ import main
    from raider_tpu_torch.workflows import calc_delays
    from raider_tpu_torch.wx.base import WeatherModel
    from raider_tpu_torch.wx.hrrr import HRRR

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    kernels.reset_launch_counts()
    with local_hrrr_fetcher(conus_raw) as cuts, recorded_writes(torch) as writes, \
            recorded_loads() as loads, \
            timed_calls(torch, calc_delays, ('read_run_config_file', 'prepareWeatherModel',
                                             'combine_weather_files', 'tropo_delay',
                                             'writeDelays')) as cd, \
            timed_calls(torch, WeatherModel, ('fetch', 'load')) as wm, \
            timed_calls(torch, HRRR, ('load_weather',)) as hr:
        t0 = time.perf_counter()
        paths = main([cfg, '--nc_format', 'NETCDF3_64BIT_OFFSET'], device=DEVICE)
        torch.cuda.synchronize()
        total = time.perf_counter() - t0
    launches = dict(kernels.LAUNCHES)
    # the read-back checks of the netCDF-3 writes run inside the steps:
    # they are taken out of each step and reported on their own
    checks = writes['check_model'] + writes['check_combined'] + writes['check_output']
    sec = {'calcDelays': total - checks, 'readback_checks': checks,
           'config_read': cd['read_run_config_file']['seconds'],
           'prepareWeatherModel': cd['prepareWeatherModel']['seconds'] - writes['check_model'],
           'fetch_cut': wm['fetch']['seconds'],
           'load': wm['load']['seconds'], 'read_raw': hr['load_weather']['seconds'],
           'model_write_netcdf3': writes['model'],
           'combine': (cd['combine_weather_files']['seconds'] - writes['combined']
                       - writes['check_combined']),
           'combined_write_netcdf3': writes['combined'],
           'tropo_delay': cd['tropo_delay']['seconds'],
           'output_write': writes['output'] + cd['writeDelays']['seconds']}
    return dict(paths=[str(p) for p in paths], seconds=sec, launches=launches,
                fresh_loads=sum(fresh for fresh, _ in loads),
                load_threads=sorted({name for _, name in loads}), writes=writes,
                epochs=[(d.isoformat(), [round(v, 4) for v in s]) for d, s in cuts],
                peak_gb=torch.cuda.max_memory_allocated() / 1e9)


def case_gates(name, rec, expected_paths, min_b2=0) -> None:
    check(rec['paths'] == [str(p) for p in expected_paths],
          f'{name}: outputs {rec["paths"]} are not the names checkArgs gives {expected_paths}')
    check(all(os.path.exists(p) for p in expected_paths), f'{name}: an output is missing')
    check(rec['writes']['files'] and all(rec['writes']['equal']),
          f'{name}: a netCDF-3 file read back differs from what was written: '
          f'{list(zip(rec["writes"]["files"], rec["writes"]["equal"]))}')
    check(rec['launches']['ztd_totals'] >= rec['fresh_loads'] >= 1,
          f'{name}: B1 launched {rec["launches"]["ztd_totals"]} times for {rec["fresh_loads"]} '
          'fresh loads')
    check(rec['launches']['brick_integrate'] >= min_b2,
          f'{name}: B2 launched {rec["launches"]["brick_integrate"]} times (< {min_b2})')


def direct(torch, rc, aoi, los, when, wm_file, rec):
    """``tropo_delay`` called directly on the card on a processed file (as
    the run's write check read it back: the same values, not read again)."""
    from raider_tpu_torch.delay import engine

    check(wm_file in rec['back'], f'{wm_file} was not written in this run')
    return engine.tropo_delay(when, rec['back'][wm_file], aoi, los,
                              height_levels=rc.height_group.height_levels,
                              out_proj=rc.runtime_group.output_projection,
                              zref=rc.los_group.zref, device=DEVICE)


def read_delay_csv(path) -> tuple:
    import csv

    with open(path, newline='') as f:
        rows = list(csv.reader(f))
    i_w, i_h = rows[0].index('wetDelay'), rows[0].index('hydroDelay')
    return tuple(np.array([float(r[i]) for r in rows[1:]]) for i in (i_w, i_h))


def zero_nan(a):
    a = np.asarray(a).copy()
    a[np.isnan(a)] = 0.0
    return a


def phase_workflow(torch, kernels, tmp, card_s):
    """Phase 10: the calc-delays workflow through the CLI
    (``cli.__main__.main``) on run configs written here, every config with
    ``--nc_format NETCDF3_64BIT_OFFSET`` and ``verbose: false``. Inputs
    are phase 8a's raw HRRR CONUS file (each epoch's raw file the cut
    HRRR's fetcher would write, its humidity scaled by a seeded factor),
    9a's station CSV, 9b's radar rasters and the EOF. Returns its summed
    launches and record."""
    import glob
    import importlib.util
    import shutil

    from raider_tpu_torch.io import read_envi, read_nc
    from raider_tpu_torch.workflows import s1_timing
    from raider_tpu_torch.wx.base import make_raw_weather_data_filename

    t_phase = time.perf_counter()
    conus_raw = make_raw_weather_data_filename(tmp, 'HRRR', PT_TIME)
    eof = glob.glob(os.path.join(tmp, '*.EOF'))[0]
    root = tempfile.mkdtemp(prefix='phase10_', dir=tmp)
    spacing = {'cube_spacing_in_m': WF_SPACING_M, 'verbose': False}

    def case_dirs(name):
        out = os.path.join(root, name)
        os.makedirs(out)
        return {'output_directory': out, 'weather_model_directory': os.path.join(out, 'wm')}

    bbox = {'bounding_box': ' '.join(str(v) for v in WX_BOX)}
    heights = {'height_levels': ' '.join(str(int(h)) for h in WF_HEIGHTS)}
    day = PT_TIME.strftime('%Y%m%d')
    cfgs = {
        '10a': write_config(os.path.join(root, '10a.yaml'), {
            'date_group': {'date_start': int(day),
                           'date_end': int((PT_TIME + dt.timedelta(days=1)).strftime('%Y%m%d'))},
            'time_group': {'time': PT_TIME.strftime('%H:%M:%S'), 'interpolate_time': 'none'},
            'aoi_group': bbox, 'height_group': heights,
            'runtime_group': {**spacing, **case_dirs('10a'), 'output_projection': 'EPSG:4326'}}),
        '10b': write_config(os.path.join(root, '10b.yaml'), {
            'date_group': {'date_start': int(day)},
            'time_group': {'time': PT_TIME.strftime('%H:%M:%S'), 'interpolate_time': 'none'},
            'aoi_group': bbox, 'height_group': heights,
            'los_group': {'ray_trace': True, 'orbit_file': eof},
            'runtime_group': {**spacing, **case_dirs('10b')}}),
        '10c': write_config(os.path.join(root, '10c.yaml'), {
            'date_group': {'date_start': int(day)},
            'time_group': {'time': WF_STATION_TIME.strftime('%H:%M:%S'),
                           'interpolate_time': 'center_time'},
            'aoi_group': {'station_file': os.path.join(tmp, 'stations.csv')},
            'runtime_group': {**spacing, **case_dirs('10c')}}),
        '10d': write_config(os.path.join(root, '10d.yaml'), {
            'date_group': {'date_start': int(day)},
            'time_group': {'time': PT_TIME.strftime('%H:%M:%S'),
                           'interpolate_time': 'azimuth_time_grid'},
            'aoi_group': {'lat_file': os.path.join(tmp, 'lat.rdr'),
                          'lon_file': os.path.join(tmp, 'lon.rdr')},
            'height_group': {'height_file_rdr': os.path.join(tmp, 'hgt.rdr')},
            'los_group': {'ray_trace': True, 'orbit_file': eof},
            'runtime_group': {**spacing, **case_dirs('10d')}}),
    }
    record, launches = {}, {}

    # 10a: a bbox cube, zenith, two dates (the prefetch worker loads the second)
    rc, aoi, los, model = workflow_prep(cfgs['10a'])
    rec = run_case(torch, kernels, cfgs['10a'], conus_raw)
    out = [Path(w.replace('wet', 'tropo')).with_suffix('.nc') for w in rc.wetFilenames]
    case_gates('10a', rec, out)
    check(rec['fresh_loads'] == 2 and 'wm-prefetch_0' in rec['load_threads'],
          f'10a: loads {rec["fresh_loads"]} on threads {rec["load_threads"]}')
    eq = []
    for when, path in zip(rc.date_group.date_list, out):
        want, _ = direct(torch, rc, aoi, los, when, processed_file(model, when), rec['writes'])
        got = read_nc(path)
        eq.append(all(np.array_equal(np.asarray(got[k].data), np.asarray(want[k].data),
                                     equal_nan=True) for k in ('wet', 'hydro')))
    differ = not np.array_equal(np.asarray(read_nc(out[0])['wet'].data),
                                np.asarray(read_nc(out[1])['wet'].data), equal_nan=True)
    rec.update(direct_equal=eq, dates_differ=differ)
    check(all(eq), f'10a: an output differs from tropo_delay on its processed file: {eq}')
    check(differ, '10a: the two dates wrote the same wet delays')
    rec['writes'].pop('back')
    record['10a'] = rec
    shutil.rmtree(os.path.join(root, '10a'))   # its files are checked

    # 10b: the same bbox raytraced from the EOF (kernel B2)
    rc, aoi, los, model = workflow_prep(cfgs['10b'])
    rec = run_case(torch, kernels, cfgs['10b'], conus_raw)
    out = [Path(w.replace('wet', 'tropo').replace('_std', '_ray')).with_suffix('.nc')
           for w in rc.wetFilenames]
    case_gates('10b', rec, out, min_b2=1)
    want, _ = direct(torch, rc, aoi, los, PT_TIME, processed_file(model, PT_TIME), rec['writes'])
    got = read_nc(out[0])
    rec['direct_equal'] = all(np.array_equal(np.asarray(got[k].data), np.asarray(want[k].data),
                                             equal_nan=True) for k in ('wet', 'hydro'))
    check(rec['direct_equal'], '10b: the cube differs from tropo_delay on its processed file')
    rec['writes'].pop('back')
    record['10b'] = rec
    shutil.rmtree(os.path.join(root, '10b'))   # its files are checked

    # 10c: the stations, zenith, center_time between two epochs
    rc, aoi, los, model = workflow_prep(cfgs['10c'])
    rec = run_case(torch, kernels, cfgs['10c'], conus_raw)
    case_gates('10c', rec, rc.wetFilenames)
    when = rc.date_group.date_list[0]
    epochs = [when.replace(minute=0, second=0), when.replace(minute=0, second=0)
              + dt.timedelta(hours=1)]
    files = [processed_file(model, e) for e in epochs]
    comb = combined_file(files[0], when, '_timeInterp_')
    got = read_delay_csv(rc.wetFilenames[0])
    want = direct(torch, rc, aoi, los, when, comb, rec['writes'])
    # a value's shortest repr in its dtype reads back as that value
    rec['direct_equal'] = all(np.array_equal(g.astype(w.dtype), zero_nan(w))
                              for g, w in zip(got, want))
    each = [direct(torch, rc, aoi, los, e, f, rec['writes']) for e, f in zip(epochs, files)]
    w = WF_CENTER_WEIGHTS
    rec['weights_err'] = float(max(np.max(np.abs(
        g - zero_nan(w[0] * np.asarray(a, np.float64) + w[1] * np.asarray(b, np.float64))))
        for g, a, b in zip(got, each[0], each[1])))
    check(rec['direct_equal'], '10c: the CSV differs from tropo_delay on the combined file')
    check(rec['weights_err'] <= WF_CENTER_TOL,
          f'10c: delays vs {w[0]} d({epochs[0]}) + {w[1]} d({epochs[1]}): '
          f'{rec["weights_err"]} m > {WF_CENTER_TOL} m')
    check(comb in rec['writes']['files'], f'10c: no combined file {comb}')
    rec['writes'].pop('back')
    record['10c'] = rec
    shutil.rmtree(os.path.join(root, '10c'))   # its files are checked

    # 10d: the radar frame raytraced, azimuth_time_grid; the two look-ups of
    # s1_timing (the ASF catalogue, the orbit download) return the local EOF
    rc, aoi, los, model = workflow_prep(cfgs['10d'])
    own = (s1_timing.get_slc_ids_from_time, s1_timing.get_orbits_from_slc_ids_hyp3lib)
    s1_timing.get_slc_ids_from_time = lambda lon, lat, time: ['S1A_local_EOF']
    s1_timing.get_orbits_from_slc_ids_hyp3lib = lambda ids, orbit_directory=None: [eof]
    try:
        with timed_calls(torch, s1_timing, ('get_azimuth_time_grid',
                                            'get_inverse_weights_for_dates')) as s1:
            rec = run_case(torch, kernels, cfgs['10d'], conus_raw)
    finally:
        s1_timing.get_slc_ids_from_time, s1_timing.get_orbits_from_slc_ids_hyp3lib = own
    out = [(w.replace('_std', '_ray'), h.replace('_std', '_ray'))
           for w, h in zip(rc.wetFilenames, rc.hydroFilenames)]
    case_gates('10d', rec, [o[0] for o in out], min_b2=1)
    args = s1['get_azimuth_time_grid']['args']
    grid = s1['get_azimuth_time_grid']['out']
    grid_cpu = s1_timing.get_azimuth_time_grid(*args, device='cpu')
    both = ~np.isnat(grid) & ~np.isnat(grid_cpu)
    rec['time_grid_ms_err'] = float(np.max(np.abs(
        (grid[both] - grid_cpu[both]).astype('timedelta64[ms]').astype(np.float64))))
    rec['time_grid_nat_equal'] = bool(np.array_equal(np.isnat(grid), np.isnat(grid_cpu)))
    wsum = np.sum(s1['get_inverse_weights_for_dates']['out'], axis=0)
    rec['weights_sum_err'] = float(np.nanmax(np.abs(wsum - 1.0)))
    rec['time_grid_shape'] = list(grid.shape)
    times = s1_timing.get_times_for_azimuth_interpolation(PT_TIME, 1)
    comb = combined_file(processed_file(model, times[0]), PT_TIME, '_timeInterpAziGrid_')
    wet, hydro = direct(torch, rc, aoi, los, PT_TIME, comb, rec['writes'])
    got = [read_envi(o)[0] for o in out[0]]   # (bands, rows, cols)
    rec['direct_equal'] = all(g.shape == (1, *w.shape)
                              and np.array_equal(g[0], zero_nan(w).astype(np.float32))
                              for g, w in zip(got, (wet, hydro)))
    check(rec['time_grid_ms_err'] <= 1.0 and rec['time_grid_nat_equal'],
          f'10d: azimuth time grid card vs CPU {rec["time_grid_ms_err"]} ms')
    check(rec['weights_sum_err'] <= 1e-12, f'10d: weights sum to 1 +- {rec["weights_sum_err"]}')
    check(rec['direct_equal'], '10d: the rasters differ from tropo_delay on the combined file')
    rec['writes'].pop('back')
    record['10d'] = rec
    shutil.rmtree(os.path.join(root, '10d'))   # its files are checked
    launches = {k: sum(r['launches'][k] for r in record.values()) for k in kernels.LAUNCHES}

    found = {m: importlib.util.find_spec(m) is not None for m in ('matplotlib', 'yaml')}
    say(f'phase 10 [{card_s}] importable on this machine: matplotlib {found["matplotlib"]}, '
        f'PyYAML {found["yaml"]}')
    if found['matplotlib']:
        # the plots of a fresh load, written to the working directory
        os.environ.setdefault('MPLBACKEND', 'Agg')
        plots = os.path.join(root, 'plots')
        cfg = write_config(os.path.join(root, '10a_verbose.yaml'), {
            'date_group': {'date_start': int(day)},
            'time_group': {'time': PT_TIME.strftime('%H:%M:%S'), 'interpolate_time': 'none'},
            'aoi_group': bbox, 'height_group': heights,
            'runtime_group': {**spacing, **case_dirs('10a_verbose'), 'verbose': True}})
        os.makedirs(plots)
        with contextlib.chdir(plots):
            run_case(torch, kernels, cfg, conus_raw)
        pdfs = sorted(os.listdir(plots))
        check(pdfs == ['HRRR_weather_hgt500.0_and_15000.0m.pdf',
                       'HRRR_weather_model_refractivity.pdf']
              and all(os.path.getsize(os.path.join(plots, p)) > 0 for p in pdfs),
              f'10a verbose: plots {pdfs}')
        record['10a_verbose_plots'] = pdfs
    for name, rec in record.items():
        if isinstance(rec, dict):
            say(f'phase {name} [{card_s}] seconds '
                + json.dumps({k: round(v, 4) for k, v in rec['seconds'].items()})
                + f'; B1 {rec["launches"]["ztd_totals"]}, B2 {rec["launches"]["brick_integrate"]} '
                f'launches; fresh loads {rec["fresh_loads"]} on {rec["load_threads"]}; epochs '
                f'(humidity scale) {rec["epochs"]}; netCDF-3 writes read back equal '
                f'{rec["writes"]["equal"]}; peak device memory {rec["peak_gb"]:.2f} GB; '
                + ', '.join(f'{k} {rec[k]}' for k in ('direct_equal', 'dates_differ',
                                                       'weights_err', 'time_grid_ms_err',
                                                       'time_grid_shape', 'weights_sum_err')
                            if k in rec))
            rec['writes'] = dict(files=[os.path.basename(p) for p in rec['writes']['files']],
                                 equal=rec['writes']['equal'])
    check(launches['ztd_totals'] >= 1 and launches['brick_integrate'] >= 1,
          f'phase 10: B1 or B2 not launched: {launches}')
    record.update(launches=launches, seconds=time.perf_counter() - t_phase,
                  note='10d: s1_timing.get_slc_ids_from_time and '
                       'get_orbits_from_slc_ids_hyp3lib replaced by the local EOF; HRRR\'s '
                       'download replaced by a cut of the CONUS raw file')
    say(json.dumps({'workflow': record}))
    return launches, record


@contextlib.contextmanager
def local_s1_lookups(eofs):
    """``s1_timing``'s two network look-ups (the ASF catalogue, the orbit
    download) answered by the local EOF files ``eofs``."""
    from raider_tpu_torch.workflows import s1_timing

    own = (s1_timing.get_slc_ids_from_time, s1_timing.get_orbits_from_slc_ids_hyp3lib)
    s1_timing.get_slc_ids_from_time = lambda lon, lat, time: ['S1A_local_EOF']
    s1_timing.get_orbits_from_slc_ids_hyp3lib = lambda ids, orbit_directory=None: list(eofs)
    try:
        yield
    finally:
        s1_timing.get_slc_ids_from_time, s1_timing.get_orbits_from_slc_ids_hyp3lib = own


@contextlib.contextmanager
def plots_where_possible():
    """The plots of each fresh model (``wx.plots``, ``verbose`` is on in a
    GUNW run config) need matplotlib; where it cannot be imported they are
    replaced by a counter of the calls. Yields the count (None when the
    plots ran)."""
    import importlib.util

    from raider_tpu_torch.wx import plots

    if importlib.util.find_spec('matplotlib') is not None:
        os.environ.setdefault('MPLBACKEND', 'Agg')
        yield None
        return
    calls = [0]
    own = (plots.plot_wh, plots.plot_pqt)

    def count(*args, **kwargs):
        calls[0] += 1
    plots.plot_wh = plots.plot_pqt = count
    try:
        yield calls
    finally:
        plots.plot_wh, plots.plot_pqt = own


@contextlib.contextmanager
def b2_per_call(kernels, owner, name):
    """Each call of ``owner.name``: a list it yields of (B2 launches in the
    call, its arguments, its keyword arguments, its result)."""
    per, own = [], getattr(owner, name)

    def counted(*args, **kwargs):
        before = kernels.LAUNCHES['brick_integrate']
        out = own(*args, **kwargs)
        per.append((kernels.LAUNCHES['brick_integrate'] - before, args, kwargs, out))
        return out
    setattr(owner, name, counted)
    try:
        yield per
    finally:
        setattr(owner, name, own)


def gunw_metadata(root):
    """11a's GUNW metadata record: a Sentinel-1 interferogram over phase
    8b's Kansas box (a ~200 x 200 km frame around 37.5 N, -98.75 E),
    reference and secondary granules 12 days apart (24 s each around
    12:00:00)."""
    from raider_tpu_torch.workflows.gunw import GUNWMetadata

    def granule(day, n):
        t0 = dt.datetime.combine(day.date(), dt.time(11, 59, 48))
        return (f'S1A_IW_SLC__1SDV_{t0:%Y%m%dT%H%M%S}_'
                f'{t0 + dt.timedelta(seconds=24):%Y%m%dT%H%M%S}_03857{n}_048D2{n}_00{n}{n}.zip')
    xs, ys = zip(*GUNW_POLYGON)
    wkt = 'POLYGON ((' + ', '.join(f'{x} {y}' for x, y in GUNW_POLYGON) + '))'
    return GUNWMetadata(path=os.path.join(root, GUNW_NAME), bbox_wkt=wkt,
                        granules={'reference': [granule(GUNW_REF, 1)],
                                  'secondary': [granule(GUNW_SEC, 2)]},
                        wavelength=GUNW_WAVELENGTH,
                        data_extent=(min(xs), min(ys), max(xs), max(ys)))


def gunw_layout_gates(run, layout):
    """11a's gates on the run and on the packaging layout (the names,
    dtypes and attributes tests/test_gunw_schema.py asserts of a written
    product); returns the record."""
    from raider_tpu_torch.geodesy.crs import crs_from_wkt
    from raider_tpu_torch.io import read_nc
    from raider_tpu_torch.utils.geom2d import point_in_polygon
    from raider_tpu_torch.workflows.gunw import DIM_NAMES, TROPO_GROUP, TROPO_NAMES

    rec = {}
    check(len(run.cube_paths) == 2 and len(set(run.cube_paths)) == 2,
          f'11a: cubes {run.cube_paths}')
    phase2range = (-4 * np.pi) / GUNW_WAVELENGTH
    cubes = {}
    for path in run.cube_paths:
        with open(path, 'rb') as f:
            check(f.read(4) in (b'CDF\x01', b'CDF\x02'), f'11a: {path} is not netCDF-3')
        day = dt.datetime.strptime(os.path.basename(path).split('_')[2], '%Y%m%dT%H%M%S')
        cubes['reference' if day.date() == GUNW_REF.date() else 'secondary'] = read_nc(path)
    check(set(cubes) == {'reference', 'secondary'}, f'11a: cube dates {run.cube_paths}')
    check(layout['group'] == f'{TROPO_GROUP}/HRRR' and set(layout['epochs']) == set(cubes),
          f'11a: layout group {layout["group"]}, epochs {sorted(layout["epochs"])}')
    poly = [tuple(p) for p in GUNW_POLYGON]
    exact, inside_ok, n_inside = True, True, 0
    for rs, ds in cubes.items():
        ep = layout['epochs'][rs]
        check(list(ep['dims']) == DIM_NAMES and sorted(ep['variables']) == sorted(TROPO_NAMES),
              f'11a: {rs} layout names {list(ep["dims"])}, {sorted(ep["variables"])}')
        for dim, axis in zip(DIM_NAMES, ('z', 'y', 'x')):
            want = np.asarray(ds.coords[axis].data, dtype=np.float32)
            check(ep['dims'][dim].dtype == np.float32 and np.array_equal(ep['dims'][dim], want),
                  f'11a: {rs} {dim} is not the cube\'s {axis} in float32')
        heights, lats, lons = (ep['dims'][d] for d in DIM_NAMES)
        check(np.array_equal(heights, np.arange(-500, 9500, 500).astype(np.float32)),
              f'11a: heights {heights}')
        for axis, lo, hi in ((lats, 36.6, 38.4), (lons, -99.88, -97.62)):
            check(np.allclose(np.diff(axis), np.diff(axis).mean(), atol=1e-4)
                  and axis.min() >= lo - 0.8 and axis.max() <= hi + 0.8,
                  f'11a: {rs} axis {axis.min()}..{axis.max()} not a uniform grid over the frame')
        crs = ep['crs']
        check(crs['attrs'].get('grid_mapping_name') == b'latitude_longitude'
              and crs_from_wkt(crs['wkt']['crs_wkt'].decode()).to_epsg() == 4326,
              f'11a: {rs} crs {crs["attrs"]}')
        inside = np.array([[point_in_polygon((float(x), float(y)), poly) for x in lons]
                           for y in lats])
        n_inside = int(inside.sum())
        for name, var in zip(TROPO_NAMES, ('wet', 'hydro')):
            v = ep['variables'][name]
            want = (np.asarray(ds[var].data, dtype=np.float64) * phase2range).astype(np.float32)
            exact &= (v['data'].dtype == np.float32 and v['dims'] == DIM_NAMES
                      and np.array_equal(v['data'], want, equal_nan=True)
                      and np.array_equal(run.arrays[f'{rs}_{name}'].astype(np.float32), want,
                                         equal_nan=True))
            a = v['attrs']
            check(v['data'].shape == (heights.size, lats.size, lons.size)
                  and a['units'] == b'radians' and a['grid_mapping'] == b'crs'
                  and a['long_name'] == a['standard_name'] == name.encode(),
                  f'11a: {rs} {name} layout attrs {a}, shape {v["data"].shape}')
            sel = v['data'][:, inside]
            inside_ok &= bool(np.isfinite(sel).all() and (sel < 0).all())
            rec[f'{rs}_{name}_mean_rad'] = float(np.nanmean(sel))
    epochs = layout['epochs']
    differ = {name: not np.array_equal(epochs['reference']['variables'][name]['data'],
                                       epochs['secondary']['variables'][name]['data'],
                                       equal_nan=True) for name in TROPO_NAMES}
    rec.update(phases_bit_for_bit=bool(exact), inside_pixels=n_inside,
               finite_negative_inside=inside_ok, epochs_differ=differ,
               cube_shape=list(epochs['reference']['variables'][TROPO_NAMES[0]]['data'].shape))
    check(exact, '11a: a phase array is not float32(float64(delay) * -4 pi / lambda) of its cube')
    check(n_inside > 0 and inside_ok, '11a: a phase inside the frame is not finite and negative')
    check(all(differ.values()), f'11a: the reference and secondary phases are equal: {differ}')
    return rec


def gunw_slice_checks(torch, calls):
    """11a's raytraced 0 m slice of each epoch, as the run's ``tropo_delay``
    computed it (B2 on the card), against the brick twin and the float64
    reference on the same operands (:func:`subgrid_check`); ``calls`` are
    :func:`b2_per_call`'s records. Returns a record per epoch."""
    from raider_tpu_torch.delay import engine

    out = []
    for _, args, kwargs, (ds, _) in calls:
        when, wm_file, _, los = args[:4]
        wm = engine.WeatherCube(wm_file, DEVICE)
        toa = float(wm.zs.max() - 1)
        zref = kwargs.get('zref')
        zref = toa if zref is None or zref > toa else zref
        mode, twin_err, ref_err, _, _ = subgrid_check(torch, wm, ds, los, zref, height=0.0)
        out.append(dict(epoch=when.isoformat(), mode=mode, twin_err_m=twin_err,
                        f64_err_m=ref_err))
        check(twin_err is not None and twin_err <= SUBGRID_TOL,
              f'11a {when}: the 0 m slice vs the brick twin {twin_err} m > {SUBGRID_TOL} m '
              f'(mode {mode})')
        check(ref_err <= SUBGRID_TOL,
              f'11a {when}: the 0 m slice vs the float64 reference {ref_err} m > {SUBGRID_TOL} m')
    return out


def phase_gunw(torch, kernels, tmp, card_s, conus_raw, eofs):
    """Phase 11a: the GUNW compute path (``workflows.gunw.run_gunw``) from a
    metadata record on the card, cubes as netCDF-3, HRRR cut from 8a's
    CONUS raw file at each epoch; then its packaging layout; then, where
    h5py is importable, the whole ``calcDelaysGUNW --file``."""
    import importlib.util

    from raider_tpu_torch.workflows import calc_delays, gunw
    from raider_tpu_torch.wx.base import WeatherModel

    root = tempfile.mkdtemp(prefix='phase11a_', dir=tmp)
    meta = gunw_metadata(root)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    kernels.reset_launch_counts()
    with local_hrrr_fetcher(conus_raw) as cuts, local_s1_lookups(eofs), \
            plots_where_possible() as plot_calls, recorded_loads() as loads, \
            b2_per_call(kernels, calc_delays, 'tropo_delay') as calls, \
            timed_calls(torch, calc_delays, ('prepareWeatherModel', 'combine_weather_files',
                                             'tropo_delay')) as cd, \
            timed_calls(torch, WeatherModel, ('fetch', 'load')) as wm, \
            timed_calls(torch, gunw, ('prep_from_gunw', 'compute_delays_slc')) as gw, \
            contextlib.chdir(root):
        t0 = time.perf_counter()
        run = gunw.run_gunw(meta, 'HRRR', os.path.join(root, 'out'),
                            interpolate_time='azimuth_time_grid', device=DEVICE,
                            nc_format='NETCDF3_64BIT_OFFSET')
        torch.cuda.synchronize()
        total = time.perf_counter() - t0
    launches = dict(kernels.LAUNCHES)
    peak = torch.cuda.max_memory_allocated() / 1e9
    t0 = time.perf_counter()
    layout = gunw.troposphere_layout(run.model, run.arrays, run.coords, run.crs_attrs, run.attrs)
    t_layout = time.perf_counter() - t0
    rec = gunw_layout_gates(run, layout)
    rec['slices_0m'] = gunw_slice_checks(torch, calls)
    b2 = [n for n, *_ in calls]
    fresh = sum(f for f, _ in loads)
    rec.update(seconds={'run_gunw': total, 'run_config': gw['prep_from_gunw']['seconds'],
                        'prepareWeatherModel_each': cd['prepareWeatherModel']['each'],
                        'fetch_cut_each': wm['fetch']['each'], 'load_each': wm['load']['each'],
                        'combine_each': cd['combine_weather_files']['each'],
                        'tropo_delay_each': cd['tropo_delay']['each'],
                        'phases': gw['compute_delays_slc']['seconds'], 'layout': t_layout},
               launches=launches, b2_per_date=b2, fresh_loads=fresh, peak_gb=peak,
               epochs=[(d.isoformat(), [round(v, 4) for v in s]) for d, s in cuts],
               plots='ran' if plot_calls is None else f'replaced ({plot_calls[0]} calls)')
    check(launches['ztd_totals'] >= fresh >= 1,
          f'11a: B1 launched {launches["ztd_totals"]} times for {fresh} fresh loads')
    check(len(b2) == 2 and min(b2) >= 1, f'11a: B2 launches per date {b2}')
    if plot_calls is not None:
        say(f'phase 11a [{card_s}] matplotlib cannot be imported here: the plots of each fresh '
            f'model (verbose is on in a GUNW run config) were replaced by a counter '
            f'({plot_calls[0]} calls); the CPU tests hold the plots')

    if importlib.util.find_spec('h5py') is None:
        rec['hdf5'] = 'not run: h5py cannot be imported on this machine'
        say(f'phase 11a [{card_s}] the HDF5 step (calcDelaysGUNW --file on a GUNW written with '
            'h5py, its troposphere group read back) was NOT run: h5py cannot be imported on '
            'this machine; run_gunw and the packaging layout above were')
    else:
        from raider_tpu_torch.io import read_nc
        from raider_tpu_torch.scripts import gunw_inputs
        from raider_tpu_torch.wx import hrrr

        product = os.path.join(root, 'h5', GUNW_NAME)
        os.makedirs(os.path.dirname(product))
        gunw_inputs.write_gunw(product, meta)
        own = hrrr.check_hrrr_dataset_availability
        hrrr.check_hrrr_dataset_availability = lambda t, model='hrrr': True   # no network here
        try:
            with local_hrrr_fetcher(conus_raw), local_s1_lookups(eofs), plots_where_possible(), \
                    contextlib.chdir(os.path.dirname(product)):
                t0 = time.perf_counter()
                cubes = gunw.calcDelaysGUNW(['--file', product, '-o', os.path.dirname(product)],
                                            device=DEVICE, nc_format='NETCDF3_64BIT_OFFSET')
                t_file = time.perf_counter() - t0
        finally:
            hrrr.check_hrrr_dataset_availability = own
        model, arrays, *_ = gunw.compute_delays_slc(cubes, GUNW_WAVELENGTH)
        same = read_nc(product).attrs.get('version') == '1c'
        for rs in ('reference', 'secondary'):
            grp = read_nc(product, group=f'{gunw.TROPO_GROUP}/{model}/{rs}')
            same &= all(np.array_equal(np.asarray(grp[name].data),
                                       arrays[f'{rs}_{name}'].astype(np.float32), equal_nan=True)
                        for name in gunw.TROPO_NAMES)
        rec['hdf5'] = {'calcDelaysGUNW_file_s': t_file, 'group_reads_back_equal': bool(same)}
        check(same, '11a: the troposphere group written with h5py differs from the arrays')
    return launches, rec


def phase_gnss(torch, kernels, tmp, card_s, conus_raw):
    """Phase 11b: GNSS stations through ``++process downloadGNSS`` (the
    archive download replaced by a copy of a local synthetic UNR archive),
    the port's calcDelays at the stations on the same dates, and the
    combination (``gnss_combine``)."""
    import shutil

    from raider_tpu_torch.cli.__main__ import main as cli
    from raider_tpu_torch.scripts import gnss_inputs, point_inputs
    from raider_tpu_torch.utils import table
    from raider_tpu_torch.workflows import gnss, gnss_combine

    root = tempfile.mkdtemp(prefix='phase11b_', dir=tmp)
    rng = np.random.default_rng(SEED + 11)
    s, n, w, e = WX_BOX
    lat, lon = rng.uniform(s + 0.1, n - 0.1, N_GNSS), rng.uniform(w + 0.1, e - 0.1, N_GNSS)
    stations = point_inputs.write_station_csv(os.path.join(root, 'stations.csv'), lat, lon,
                                              rng.uniform(250.0, 800.0, N_GNSS))
    ids = [f'S{i:05d}' for i in range(N_GNSS)]
    doys = [d.timetuple().tm_yday for d in GNSS_DATES]
    archive_dir = os.path.join(root, 'archives')
    os.makedirs(archive_dir)
    t0 = time.perf_counter()
    written = {sid: gnss_inputs.write_trop_zip(
        os.path.join(archive_dir, f'{sid}.{GNSS_DATES[0].year}.trop.zip'), sid,
        GNSS_DATES[0].year, doys + [doys[-1] + 1], seed=SEED + i, n_gaps=GNSS_GAPS)
        for i, sid in enumerate(ids)}
    t_archives = time.perf_counter() - t0

    def local_copy(url, save_path, chunk_size=2048):
        src = os.path.join(archive_dir, os.path.basename(url))
        if not os.path.exists(src):
            return ''
        shutil.copy(src, save_path)
        return save_path

    gnss_dir = os.path.join(root, 'gnss')
    own = gnss.download_url
    gnss.download_url = local_copy
    try:
        t0 = time.perf_counter()
        cli(['++process', 'downloadGNSS', '--station_file', stations, '--bbox',
             ' '.join(str(v) for v in WX_BOX), '--date', *(f'{d:%Y%m%d}' for d in GNSS_DATES),
             '--returntime', '12:00:00', '--download', '--out', gnss_dir], device=DEVICE)
        t_download = time.perf_counter() - t0
    finally:
        gnss.download_url = own
    gnss_file = os.path.join(gnss_dir, 'UNRcombinedGPS_ztd.csv')
    obs = table.read_csv(gnss_file)
    pairs = list(zip(obs['ID'], obs['Date']))
    check(len(pairs) == len(set(pairs)) == N_GNSS * len(GNSS_DATES),
          f'11b: {len(pairs)} GNSS rows ({len(set(pairs))} distinct (ID, Date)) for '
          f'{N_GNSS} stations x {len(GNSS_DATES)} dates')
    ztd_equal = True
    for sid, day, ztd in zip(obs['ID'], obs['Date'], obs['ZTD']):
        doy = dt.date.fromisoformat(day).timetuple().tm_yday
        times, trotot, _, _ = written[sid][doy]
        k = int(np.argmin(np.abs(times - 43200)))
        ztd_equal &= bool(ztd == trotot[k] * 0.001)
    check(ztd_equal, "11b: a GNSS ZTD is not the archive's TROTOT/1000 at the nearest epoch "
          'with data')

    run_dir = os.path.join(root, 'raider')
    cfg = write_config(os.path.join(root, '11b.yaml'), {
        'date_group': {'date_start': int(f'{GNSS_DATES[0]:%Y%m%d}'),
                       'date_end': int(f'{GNSS_DATES[-1]:%Y%m%d}')},
        'time_group': {'time': '12:00:00', 'interpolate_time': 'none'},
        'aoi_group': {'station_file': stations},
        'runtime_group': {'verbose': False, 'output_directory': run_dir,
                          'weather_model_directory': os.path.join(root, 'wm')}})
    rec = run_case(torch, kernels, cfg, conus_raw)
    check(len(rec['paths']) == len(GNSS_DATES) and all(p.endswith('_ztd.csv')
                                                       for p in rec['paths']),
          f'11b: calcDelays wrote {rec["paths"]}')
    check(rec['launches']['ztd_totals'] >= rec['fresh_loads'] >= 1,
          f'11b: B1 launched {rec["launches"]["ztd_totals"]} times for {rec["fresh_loads"]} '
          'fresh loads')
    check(rec['writes']['files'] and all(rec['writes']['equal']),
          f'11b: a netCDF-3 file read back differs from what was written: {rec["writes"]["equal"]}')
    # the delays as calcDelays wrote them, before the combination adds its column
    raider = {}
    for p in rec['paths']:
        when = np.datetime64(dt.datetime.strptime(os.path.basename(p).split('_')[2],
                                                  '%Y%m%dT%H%M%S'), 'ns')
        t = table.read_csv(p)
        raider.update({(sid, when): v for sid, v in zip(t['ID'], t['totalDelay'])})

    combined = os.path.join(root, 'raider_combined.csv')
    t0 = time.perf_counter()
    gnss_combine.combineDelayFiles(combined, loc=run_dir)
    merged = gnss_combine.main(combined, gnss_file)
    t_combine = time.perf_counter() - t0
    # a left merge: every model row, ZTD NaN where the station's epoch
    # nearest 12:00 with data is another (a gap at 12:00)
    keys = list(zip(merged['ID'], merged['Datetime']))
    gnss_ztd = {(sid, np.datetime64(day, 'ns') + np.timedelta64(int(sec), 's')): z
                for sid, day, sec, z in zip(obs['ID'], obs['Date'], obs['times'], obs['ZTD'])}
    matched = {k for k in raider if k in gnss_ztd}
    with_ztd = {k for k, z in zip(keys, merged['ZTD']) if not np.isnan(z)}
    check(len(keys) == len(set(keys)) == len(raider) and with_ztd == matched and matched,
          f'11b: {len(keys)} merged rows ({len(with_ztd)} with a ZTD) for {len(raider)} model '
          f'rows, {len(matched)} matched (ID, Datetime)')
    resid = np.array([gnss_ztd[k] - raider[k] if k in matched else np.nan for k in keys])
    resid_equal = bool(np.array_equal(merged['ZTD_minus_RAiDER'], resid, equal_nan=True))
    check(resid_equal, '11b: ZTD_minus_RAiDER is not ZTD - totalDelay of the two files')
    merged_csv = os.path.join(root, 'UNRcombined_raider.csv')     # raiderStats' input (12b)
    table.to_csv(merged, merged_csv)
    out = dict(seconds={'write_archives': t_archives, 'downloadGNSS': t_download,
                        'calcDelays': rec['seconds']['calcDelays'],
                        'calcDelays_steps': rec['seconds'], 'combine_and_merge': t_combine},
               launches=rec['launches'], fresh_loads=rec['fresh_loads'], peak_gb=rec['peak_gb'],
               gnss_rows=len(pairs), ztd_equal_archive=ztd_equal, merged_rows=len(keys),
               matched_rows=len(matched), residual_bit_for_bit=resid_equal, merged_csv=merged_csv,
               mean_residual_m=float(np.nanmean(resid)))
    return rec['launches'], out


def phase_gacos(tmp):
    """Phase 11c (the GACOS part): ``gacos.main`` on a seeded .ztd + .rsc;
    the port's ENVI reader reads the grid back."""
    from raider_tpu_torch.io import read_envi
    from raider_tpu_torch.workflows import gacos

    path = os.path.join(tempfile.mkdtemp(prefix='phase11c_', dir=tmp), '20210701.ztd')
    rng = np.random.default_rng(SEED + 12)
    grid = rng.uniform(2.2, 2.6, GACOS_SHAPE).astype('<f4')
    grid.tofile(path)
    with open(path + '.rsc', 'w') as f:
        f.write(f'WIDTH {GACOS_SHAPE[1]}\nFILE_LENGTH {GACOS_SHAPE[0]}\nX_FIRST -100.0\n'
                'Y_FIRST 39.0\nX_STEP 0.008333333\nY_STEP -0.008333333\n')
    gacos.main([path])
    data, prof = read_envi(path)
    same = bool(data.shape == (1, *GACOS_SHAPE)
                and np.array_equal(data[0], np.fromfile(path, '<f4').reshape(GACOS_SHAPE)))
    check(same and os.path.exists(path + '.vrt'), '11c: the GACOS grid did not read back')
    return {'shape': list(GACOS_SHAPE), 'reads_back_equal': same}


def phase_gunw_gnss(torch, kernels, tmp, card_s):
    """Phase 11: the GUNW compute path (11a), the GNSS tools (11b) and
    GACOS (11c), inside phase 8's temp dir, on 8a's raw HRRR CONUS file.
    Returns its summed launches and record."""
    from raider_tpu_torch.geometry.orbit import Orbit
    from raider_tpu_torch.scripts import point_inputs
    from raider_tpu_torch.wx.base import make_raw_weather_data_filename

    t_phase = time.perf_counter()
    conus_raw = make_raw_weather_data_filename(tmp, 'HRRR', PT_TIME)
    orbit_dir = tempfile.mkdtemp(prefix='phase11_orbits_', dir=tmp)
    track = track_orbit(*WX_TRACK, step=EOF_STEP)
    eofs = sorted(point_inputs.write_eof(orbit_dir, Orbit(times=track.times, pos=track.pos,
                                                          vel=track.vel, ref_time=t))
                  for t in (GUNW_REF, GUNW_SEC))
    launches_a, gunw = phase_gunw(torch, kernels, tmp, card_s, conus_raw, eofs)
    say(f'phase 11a [{card_s}] GUNW: ' + json.dumps(gunw))
    launches_b, gnss = phase_gnss(torch, kernels, tmp, card_s, conus_raw)
    say(f'phase 11b [{card_s}] GNSS: ' + json.dumps(gnss))
    gacos = phase_gacos(tmp)
    launches = {k: launches_a[k] + launches_b[k] for k in kernels.LAUNCHES}
    check(launches['ztd_totals'] >= 1 and launches['brick_integrate'] >= 1,
          f'phase 11: B1 or B2 not launched: {launches}')
    record = dict(gunw_launches=launches_a, gnss_launches=launches_b, gacos=gacos,
                  merged_csv=gnss['merged_csv'],
                  launches=launches, seconds=time.perf_counter() - t_phase,
                  note="11a/11b: HRRR's download replaced by a cut of the CONUS raw file, "
                       "s1_timing's look-ups by the local EOFs; 11b: the UNR archive download "
                       'by a copy of a local synthetic archive')
    say(json.dumps({'gunw_gnss': record}))
    return launches, record


# ------------------------------------------------------------------ phase 12

@contextlib.contextmanager
def figures_where_possible():
    """raiderStats' figures (``workflows.stats.draw_figure``) need
    matplotlib; where it cannot be imported only the drawing is replaced by
    a counter of what each flag would have drawn. Yields the (kind, file)
    list of the replaced figures (None when they were drawn)."""
    import importlib.util

    from raider_tpu_torch.workflows import stats

    if importlib.util.find_spec('matplotlib') is not None:
        os.environ.setdefault('MPLBACKEND', 'Agg')
        yield None
        return
    drawn, own = [], stats.draw_figure

    def count(st, kind, fname, **data):
        drawn.append((kind, fname))
        return os.path.join(st.workdir, fname)
    stats.draw_figure = count
    try:
        yield drawn
    finally:
        stats.draw_figure = own


def _h(x):
    return x.detach().cpu().numpy() if hasattr(x, 'detach') else np.asarray(x)


def stats_products(rec) -> dict:
    """The numbers of a ``stats_analyses`` record, host numpy, by name."""
    out = {f'grid {k}': _h(v) for k, v in rec['grids'].items()}
    if rec['seasonal'] is not None:
        out.update({f'seasonal {k}': _h(v) for k, v in rec['seasonal'].items() if k != 'ID'})
    if rec['variogram'] is not None:
        vg = rec['variogram']
        out.update({f'variogram {k}': _h(vg[k]) for k in ('centers', 'gamma', 'counts')})
        out['variogram sill'] = np.array([vg['sill'], vg['range']])
    if rec['gridded_variogram'] is not None:
        out['gridded sill'], out['gridded range'] = rec['gridded_variogram']
    if rec['timeslices'] is not None:
        out['timeslice dates'] = np.array([r[0].toordinal() for r in rec['timeslices']])
        for k, name in ((2, 'gamma'), (3, 'counts')):
            out[f'timeslice {name}'] = np.array([r[k] for r in rec['timeslices']])
        out['timeslice sill'] = np.array([r[4:6] for r in rec['timeslices']])
    return out


def stats_rtol(name: str) -> float:
    """Phase 12's tolerance of a product, card against CPU (0: equal)."""
    if ('count' in name or 'heatmap' in name or name in ('grid grid_absolute_median',
                                                         'timeslice dates')):
        return 0.0
    if 'sill' in name or 'range' in name:
        return STATS_RTOL_SILL
    if 'seasonal' in name:
        return STATS_RTOL_FIT
    return STATS_RTOL


def stats_compare(card, cpu) -> dict:
    """Each product's largest relative difference, card against CPU, and
    the ones outside their tolerance (or with other NaN cells)."""
    diffs, bad = {}, []
    check(sorted(card) == sorted(cpu), f'12: the card and the CPU made other products: '
          f'{sorted(set(card) ^ set(cpu))}')
    for name in card:
        a, b = np.asarray(card[name], dtype=np.float64), np.asarray(cpu[name], dtype=np.float64)
        same_nan = a.shape == b.shape and np.array_equal(np.isnan(a), np.isnan(b))
        ok = same_nan & np.isfinite(b)
        rel = float(np.max(np.abs(a[ok] - b[ok]) / np.maximum(np.abs(b[ok]), 1e-300))) \
            if same_nan and ok.any() else 0.0
        diffs[name] = rel
        if not same_nan or rel > stats_rtol(name):
            bad.append(name)
    return dict(max_rel=diffs, outside=bad)


def stats_run(torch, kernels, argv, device):
    """One ``stats_analyses`` run: its record, products and peak memory."""
    from raider_tpu_torch.workflows import stats

    if device != 'cpu':
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    rec = stats.stats_analyses(argv, device=device)
    if device != 'cpu':
        torch.cuda.synchronize()
    rec['seconds']['total'] = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated() / 1e9 if device != 'cpu' else 0.0
    return rec, stats_products(rec), peak


def files_read_back(rec) -> dict:
    """Every non-figure product of a run, read back: {file: ok}."""
    from raider_tpu_torch.io.geotiff import read_gtiff
    from raider_tpu_torch.utils import table

    out = {}
    for path in rec['files']:
        name = os.path.basename(path)
        if name.endswith('.tif'):
            arr, prof = read_gtiff(path)
            want = np.flipud(_h(rec['grids'][name[:-4]])).astype(np.float32)
            out[name] = bool(prof['transform'].to_gdal()[5] < 0
                             and np.array_equal(arr[0], want, equal_nan=True))
        elif name.endswith('.npy'):
            sill, rng_ = rec['gridded_variogram']
            out[name] = bool(np.array_equal(np.load(path), sill if 'sill' in name else rng_,
                                            equal_nan=True))
        elif name.endswith('.csv'):
            got = table.read_csv(path)
            want = {k: _h(v) for k, v in rec['seasonal'].items()}
            out[name] = bool(list(got) == list(want) and all(
                np.array_equal(np.asarray(got[k]), np.asarray(want[k]))
                if got[k].dtype.kind in 'iO' else
                np.array_equal(got[k], want[k], equal_nan=True) for k in want))
    return out


def same_files(dir_a, dir_b, names) -> bool:
    """The non-figure files of two runs hold the same bytes."""
    for name in names:
        with open(os.path.join(dir_a, name), 'rb') as fa, open(os.path.join(dir_b, name),
                                                                  'rb') as fb:
            if fa.read() != fb.read():
                return False
    return True


def seasonal_truth(rec, truth) -> dict:
    """The seasonal table against the seeded harmonics: the stations the span
    filter kept and the largest annual amplitude and phase errors."""
    fits = {k: _h(v) for k, v in rec['seasonal'].items()}
    kept = set(fits['ID'].tolist())
    short = set(truth['ID'][truth['short']].tolist())
    idx = np.searchsorted(truth['ID'], fits['ID'])
    amp_err = np.abs(fits['annual_amplitude'] - truth['annual_amplitude'][idx])
    dphi = np.angle(np.exp(1j * (fits['annual_phase'] - truth['annual_phase'][idx])))
    return dict(stations=len(kept), dropped=len(truth['ID']) - len(kept),
                dropped_exactly_the_short=kept == set(truth['ID'].tolist()) - short,
                max_amplitude_err_m=float(np.max(amp_err)),
                max_phase_err_rad=float(np.max(np.abs(dphi))))


def phase_stats(torch, kernels, tmp, card_s):
    """Phase 12a: raiderStats on a continental network's combined CSV."""
    from raider_tpu_torch.scripts import stats_inputs

    root = tempfile.mkdtemp(prefix='phase12a_', dir=tmp)
    csv = os.path.join(root, 'combined.csv')
    t0 = time.perf_counter()
    truth = stats_inputs.write_combined_csv(csv, n_stations=STATS_STATIONS, n_days=STATS_DAYS,
                                            n_short=STATS_SHORT, box=STATS_BOX, seed=SEED)
    t_write = time.perf_counter() - t0
    say(f'phase 12a [{card_s}] wrote {truth["rows"]:,} rows of {STATS_STATIONS} stations x '
        f'{STATS_DAYS} days ({os.path.getsize(csv) / 1e6:.1f} MB) in {t_write:.2f} s')
    out = {}
    with figures_where_possible() as drawn:
        for label, extra in (('12a', STATS_FLAGS), ('12a filtered', STATS_FILTER_FLAGS)):
            argv = ['-f', csv, *extra]
            kernels.reset_launch_counts()
            runs = {}
            for name, dev in (('card', DEVICE), ('card again', DEVICE), ('cpu', 'cpu')):
                wd = os.path.join(root, f'{label}_{name}'.replace(' ', '_'))
                n_drawn = len(drawn) if drawn is not None else 0
                rec, prod, peak = stats_run(torch, kernels, [*argv, '-w', wd], dev)
                runs[name] = (rec, prod, peak, wd, drawn[n_drawn:] if drawn is not None
                              else [('drawn', f) for f in rec['figures']])
                if name == 'card':
                    launches = dict(kernels.LAUNCHES)
                    sec = {k: round(v, 4) for k, v in rec['seconds'].items()}
                    say(f'phase 12 {label} [{card_s}] seconds (card; synchronized after each '
                        f'step): {json.dumps(sec)}; peak device memory {peak:.3f} GB; '
                        f'{len(rec["stats"]):,} rows, grid {len(rec["stats"].lat_edges) - 1} x '
                        f'{len(rec["stats"].lon_edges) - 1}')
            rec, prod, peak, wd, figs = runs['card']
            read_back = files_read_back(rec)
            check(read_back and all(read_back.values()), f'12 {label}: a product did not read '
                  f'back: {read_back}')
            again = runs['card again']
            bits = (all(np.array_equal(prod[k], again[1][k], equal_nan=True) for k in prod)
                    and same_files(wd, again[3], [os.path.basename(p) for p in rec['files']]))
            check(bits, f'12 {label}: two card runs differ')
            cmp = stats_compare(prod, runs['cpu'][1])
            check(not cmp['outside'], f'12 {label}: card vs CPU outside the tolerances: '
                  f'{ {k: cmp["max_rel"][k] for k in cmp["outside"]} }')
            cpu_sec = round(runs['cpu'][0]['seconds']['total'], 3)
            res = dict(rows=len(rec['stats']), files=sorted(read_back), figures=len(figs),
                       figure_kinds=sorted({f[0] for f in figs}),
                       seconds=rec['seconds'], cpu_seconds=cpu_sec,
                       again_seconds=again[0]['seconds']['total'], peak_gb=peak,
                       card_vs_cpu_max_rel=max(cmp['max_rel'].values()),
                       two_card_runs_same_bits=bits, launches=launches)
            if label == '12a':
                res['truth'] = seasonal_truth(rec, truth)
                tr = res['truth']
                check(tr['dropped'] == STATS_SHORT and tr['dropped_exactly_the_short'],
                      f'12a: the span filter dropped {tr["dropped"]} stations, not the '
                      f'{STATS_SHORT} short ones')
                check(tr['max_amplitude_err_m'] <= 3e-3 and tr['max_phase_err_rad'] <= 0.2,
                      f'12a: seasonal fits off the seeded harmonics: {tr}')
            say(f'phase 12 {label} [{card_s}] gates: {len(read_back)} files read back, two card '
                f'runs equal bit for bit, card vs CPU within the tolerances (largest relative '
                f'difference {res["card_vs_cpu_max_rel"]:.3e}; CPU run {cpu_sec} s); '
                f'figures {"drawn" if drawn is None else "replaced by a counter (no matplotlib)"}: '
                f'{len(figs)} ({", ".join(sorted({os.path.basename(f[1]) for f in figs}))})'
                + (f'; truth {json.dumps(res["truth"])}' if 'truth' in res else ''))
            out[label] = res
            del runs, rec, prod, again
    return out


def phase_stats_gnss(torch, kernels, tmp, card_s, merged_csv):
    """Phase 12b: raiderStats on 11b's merged GNSS/model product."""
    root = tempfile.mkdtemp(prefix='phase12b_', dir=tmp)
    with figures_where_possible():
        argv = ['-f', merged_csv, '-sp', '0.5', '-grid_heatmap', '-grid_delay_mean',
                '-grid_delay_absolute_mean', '-grid_delay_absolute_median',
                '-grid_delay_absolute_stdev', '-grid_seasonal_amplitude', '-grid_to_raster']
        runs = {name: stats_run(torch, kernels, [*argv, '-w', os.path.join(root, name)], dev)
                for name, dev in (('card', DEVICE), ('cpu', 'cpu'))}
        cmp = stats_compare(runs['card'][1], runs['cpu'][1])
        check(not cmp['outside'], f'12b: card vs CPU outside the tolerances: '
              f'{ {k: cmp["max_rel"][k] for k in cmp["outside"]} }')
        rec = runs['card'][0]
        n_seasonal = len(rec['seasonal']['ID'])
        read_back = files_read_back(rec)
        check(all(read_back.values()), f'12b: a product did not read back: {read_back}')
        out = dict(rows=len(rec['stats']), stations=int(rec['stats'].ids.size),
                   seasonal_stations=n_seasonal, seconds=rec['seconds'],
                   card_vs_cpu_max_rel=max(cmp['max_rel'].values()), files=sorted(read_back))
        say(f'phase 12b [{card_s}] raiderStats on 11b\'s merged product '
            f'({out["rows"]} rows, {out["stations"]} stations, -sp 0.5): '
            f'seconds {json.dumps({k: round(v, 4) for k, v in rec["seconds"].items()})}; '
            f'card vs CPU largest relative difference {out["card_vs_cpu_max_rel"]:.3e}; '
            f'{len(read_back)} files read back; the seasonal table holds {n_seasonal} stations '
            '(two days of record: the span filter drops every station, as in JAX)')
        check(n_seasonal == 0, f'12b: {n_seasonal} stations passed the span filter')
    return out


def phase_shard_headline(torch, kernels, card_s, ctx):
    """Phase 12c: phase 3's zenith and raytraced requests on a mesh of 4
    shards of the one card, against phase 3's cubes bit for bit."""
    from raider_tpu_torch.delay import engine
    from raider_tpu_torch.geometry import BoundingBox, Raytracing, Zenith
    from raider_tpu_torch.parallel import get_mesh

    mesh = get_mesh(devices=(torch.device(DEVICE),) * SHARDS)
    sec, cubes = {}, {}
    torch.cuda.synchronize()
    kernels.reset_launch_counts()
    for name, los in (('zenith', Zenith()), ('raytraced', Raytracing(orbit=ctx['orbit'],
                                                                      time=ctx['when']))):
        t0 = time.perf_counter()
        cubes[name], _ = engine.tropo_delay(ctx['when'], ctx['ds_wm'],
                                            BoundingBox(BBOX, cube_spacing_in_m=SPACING_M), los,
                                            height_levels=HEIGHTS, device=DEVICE, mesh=mesh)
        torch.cuda.synchronize()
        sec[name] = time.perf_counter() - t0
    launches = dict(kernels.LAUNCHES)
    same = {name: all(np.array_equal(np.asarray(cubes[name][k].data),
                                     np.asarray(ctx[name][k].data), equal_nan=True)
                      for k in ('wet', 'hydro')) for name in cubes}
    say(f'phase 12c [{card_s}] phase 3\'s requests on {SHARDS} shards of one card: seconds '
        f'{json.dumps({k: round(v, 4) for k, v in sec.items()})} (phase 3, unsharded: zenith '
        f'{ctx["stages"]["zenith_s"]:.4f}, raytraced {ctx["stages"]["raytrace_s"]:.4f}); '
        f'bit for bit equal to phase 3 {same}; B2 launches {launches["brick_integrate"]} '
        f'(expected {len(HEIGHTS)} slices x {SHARDS} shards)')
    check(all(same.values()), f'12c: the sharded cubes differ from phase 3\'s: {same}')
    check(launches['brick_integrate'] == len(HEIGHTS) * SHARDS,
          f'12c: B2 launched {launches["brick_integrate"]} times, not {len(HEIGHTS) * SHARDS}')
    return launches, dict(seconds=sec, phase3_seconds={'zenith': ctx['stages']['zenith_s'],
                                                       'raytraced': ctx['stages']['raytrace_s']},
                          bit_for_bit=same, launches=launches)


def phase_zslabs(torch, kernels, card_s):
    """Phase 12d, kernel level: the bigcube (HRRR CONUS size) in pack16_i16
    and pack4 integrated in z-slabs of 4 shards against the whole table;
    then the midcube's brick_i16 slice ray-sharded (K4 on every shard)."""
    from raider_tpu_torch.delay.raytrace import integrate_rays, pack_cubes
    from raider_tpu_torch.parallel import (get_mesh, integrate_rays_z_sharded,
                                           pack_cube_slabs, shard_rays)
    from raider_tpu_torch.scripts import cuda_ms

    mesh = get_mesh(devices=(torch.device(DEVICE),) * SHARDS)
    sc = large_scene(torch, BIG_GRID, (21.0, 53.0), (-134.0, -60.0), (25.0, 49.0),
                     (-124.0, -70.0), True)
    res = {}
    for mode in ('pack16_i16', 'pack4'):
        table = pack_cubes(sc['wet'], sc['hydro'], mode=mode)[0]
        full = table[0] if mode == 'pack16_i16' else table

        def whole(t=table, m=mode):
            return integrate_rays(sc['wet'], sc['hydro'], sc['ys'], sc['xs'], sc['zs'],
                                  *sc['rays'], sc['plm'], packed2d=t, mode=m)
        slabs = pack_cube_slabs(sc['wet'], sc['hydro'], mode, SHARDS, mesh=mesh)

        def sharded(s=slabs, m=mode):
            return integrate_rays_z_sharded(sc['wet'], sc['hydro'], sc['ys'], sc['xs'],
                                            sc['zs'], *sc['rays'], sc['plm'], mode=m, mesh=mesh,
                                            packed=s)
        (w1, h1), (w2, h2) = whole(), sharded()
        same_nan = bool(torch.equal(torch.isnan(w1), torch.isnan(w2))
                        and torch.equal(torch.isnan(h1), torch.isnan(h2)))
        err = max(max_rel(torch, w2, w1), max_rel(torch, h2, h1))
        slab_bytes = [t.numel() * t.element_size() for t in slabs[0]]
        rec = dict(table_bytes=full.numel() * full.element_size(), slab_bytes=slab_bytes,
                   z_lo=[int(v) for v in slabs[1]], z_hi=[int(v) for v in slabs[2]],
                   max_rel=err, same_nan=same_nan,
                   whole_ms=cuda_ms(whole, reps=3), zslab_ms=cuda_ms(sharded, reps=3),
                   pack_whole_ms=cuda_ms(lambda m=mode: pack_cubes(sc['wet'], sc['hydro'],
                                                                   mode=m), reps=3),
                   pack_slabs_ms=cuda_ms(lambda m=mode: pack_cube_slabs(
                       sc['wet'], sc['hydro'], m, SHARDS, mesh=mesh), reps=3))
        res[mode] = rec
        say(f'phase 12d [{card_s}] bigcube {BIG_GRID} {mode}, {LARGE_RAYS} rays, {SHARDS} '
            f'z-slabs: slab bytes {slab_bytes} of {rec["table_bytes"]} (shares '
            f'{[round(b / rec["table_bytes"], 4) for b in slab_bytes]}); integrate ms: whole '
            f'{rec["whole_ms"]:.3f}, z-slabs {rec["zslab_ms"]:.3f}; pack ms: whole '
            f'{rec["pack_whole_ms"]:.3f}, slabs {rec["pack_slabs_ms"]:.3f}; max rel '
            f'{err:.3e} (bound {ZSHARD_RTOL:g}), same NaN {same_nan}')
        check(same_nan and err <= ZSHARD_RTOL, f'12d {mode}: z-slabs vs the whole table: '
              f'max rel {err}, same NaN {same_nan}')
        del table, full, slabs, w1, h1, w2, h2
        torch.cuda.empty_cache()
    del sc
    torch.cuda.empty_cache()

    # the midcube's brick_i16 slice, rays split over the shards: K4 a shard
    sc = large_scene(torch, MID_GRID, (28.0, 42.0), (-127.0, -113.0), (30.0, 40.0),
                     (-125.0, -115.0), False)
    table, mode = pack_cubes(sc['wet'], sc['hydro'], grouped=True)
    check(mode == 'brick_i16', f'12d: the midcube packs as {mode}')

    def fn(by, bx, bz, d2, rl, re):
        return integrate_rays(sc['wet'], sc['hydro'], sc['ys'], sc['xs'], sc['zs'],
                              by, bx, bz, d2, rl, re, sc['plm'], packed2d=table, mode=mode,
                              heights=sc['zs'].copy(), hstep_max=sc['hstep'])
    w1, h1 = fn(*sc['rays'])
    torch.cuda.synchronize()
    kernels.reset_launch_counts()
    w2, h2 = shard_rays(fn, mesh, ray_axis_argnums={0: 1, 1: 1, 2: 1, 3: 1, 4: 1, 5: 0})(
        *sc['rays'])
    torch.cuda.synchronize()
    launches = dict(kernels.LAUNCHES)
    same = all(np.array_equal(_h(a), _h(b), equal_nan=True) for a, b in ((w1, w2), (h1, h2)))
    res['midcube_ray_sharded'] = dict(mode=mode, bit_for_bit=same, launches=launches)
    say(f'phase 12d [{card_s}] midcube {MID_GRID} {mode} slice, {LARGE_RAYS} rays over {SHARDS} '
        f'shards (shard_rays): bit for bit {same}; K4 launches '
        f'{launches["brick_integrate_i16"]}')
    check(same and launches['brick_integrate_i16'] == SHARDS,
          f'12d: the ray-sharded midcube slice: bit for bit {same}, launches {launches}')
    del sc, table, w1, h1, w2, h2
    torch.cuda.empty_cache()
    return launches, res


def phase_zslab_engine(torch, kernels, tmp, card_s):
    """Phase 12d, engine level: 8b's raytraced request on 8a's LCC cube
    (57 x 1059 x 1799, pack16_i16) with the table in z-slabs over 4 shards
    (``zshard=True``) against the same request unsharded."""
    from raider_tpu_torch.delay import engine
    from raider_tpu_torch.geometry import BoundingBox, Raytracing
    from raider_tpu_torch.parallel import get_mesh
    from raider_tpu_torch.wx.registry import get_wm_by_name

    mesh = get_mesh(devices=(torch.device(DEVICE),) * SHARDS)
    when = dt.datetime(2021, 7, 1, 12, 0, 0)
    torch.cuda.synchronize()
    kernels.reset_launch_counts()
    model = get_wm_by_name('HRRR')[1]()
    model.setTime(when)
    model.set_wmLoc(tmp)
    model.load(device=DEVICE)
    ds_wm = model.to_dataset()
    del model
    los = Raytracing(orbit=track_orbit(*WX_TRACK), time=when)
    sec, cubes = {}, {}
    for name, kw in (('whole', {}), ('zslabs', dict(mesh=mesh, zshard=True))):
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        cubes[name], _ = engine.tropo_delay(when, ds_wm,
                                            BoundingBox(WX_BOX, cube_spacing_in_m=SPACING_M),
                                            los, height_levels=WX_HEIGHTS, device=DEVICE, **kw)
        torch.cuda.synchronize()
        sec[name] = dict(seconds=time.perf_counter() - t0,
                         peak_gb=torch.cuda.max_memory_allocated() / 1e9)
    launches = dict(kernels.LAUNCHES)
    err, same_nan = 0.0, True
    for k in ('wet', 'hydro'):
        a, b = np.asarray(cubes['zslabs'][k].data), np.asarray(cubes['whole'][k].data)
        same_nan &= bool(np.array_equal(np.isnan(a), np.isnan(b)))
        ok = np.isfinite(b) & (b != 0)
        err = max(err, float(np.max(np.abs(a[ok] - b[ok]) / np.abs(b[ok]))))
    say(f'phase 12d [{card_s}] 8b\'s raytraced request on the LCC cube '
        f'{tuple(np.shape(ds_wm["wet"].data))} with the table in {SHARDS} z-slabs: '
        f'{json.dumps(sec)}; max rel vs the whole table {err:.3e} (bound {ZSHARD_RTOL:g}), '
        f'same NaN {same_nan}; launches {launches}')
    check(same_nan and err <= ZSHARD_RTOL, f'12d engine: z-slabs vs whole: max rel {err}, '
          f'same NaN {same_nan}')
    check(launches['ztd_totals'] >= 1, f'12d engine: B1 not launched by the load: {launches}')
    del ds_wm, cubes
    torch.cuda.empty_cache()
    return launches, dict(requests=sec, max_rel=err, same_nan=same_nan, launches=launches)


def phase_stats_parallel(torch, kernels, tmp, card_s, main_ctx, merged_csv):
    """Phase 12: raiderStats (12a, 12b), ray sharding (12c) and z-slab
    tables (12d). Returns its summed launches and record."""
    t_phase = time.perf_counter()
    record, failed = {}, []
    launches = dict.fromkeys(kernels.LAUNCHES, 0)
    # every part runs, and a failed gate fails the phase once all have run
    for name, part in (('12a', lambda: ({}, phase_stats(torch, kernels, tmp, card_s))),
                       ('12b', lambda: ({}, phase_stats_gnss(torch, kernels, tmp, card_s,
                                                             merged_csv))),
                       ('12c', lambda: phase_shard_headline(torch, kernels, card_s, main_ctx)),
                       ('12d', lambda: phase_zslabs(torch, kernels, card_s)),
                       ('12d engine', lambda: phase_zslab_engine(torch, kernels, tmp, card_s))):
        try:
            got, record[name] = part()
        except Exception as exc:          # noqa: BLE001 (reported, then raised below)
            failed.append(f'{name}: {type(exc).__name__}: {exc}')
            say(f'phase {name} FAILED: {type(exc).__name__}: {exc}')
            continue
        for k, v in got.items():
            launches[k] += v
    record.update(launches=launches, seconds=time.perf_counter() - t_phase)
    say(json.dumps({'stats_parallel': record}, default=str))
    check(not failed, f'phase 12: {failed}')
    return launches, record


def phase_weather_models(torch, kernels, main_ctx):
    """Phase 8: weather models from raw files (8a-8c) and the CRSs (8d),
    then phase 9 (point requests), phase 10 (the workflow), phase 11 (the
    GUNW and GNSS tools) and phase 12 (raiderStats, sharding; ``main_ctx``
    is phase 3's requests) in the same directory. Returns the summed
    launches of phase 8's paths, and of phases 9, 10, 11 and 12."""
    import shutil

    from raider_tpu_torch.scripts import card

    card_s = card()
    tmp = tempfile.mkdtemp(prefix='chip_smoke_wx_')
    try:
        launches, hrrr = phase_hrrr(torch, kernels, tmp, card_s)
        fam_launches, families = phase_families(torch, kernels, tmp, card_s)
        for k, v in fam_launches.items():
            launches[k] = launches.get(k, 0) + v
        crs = phase_crs(torch, card_s)
        record = dict(card=card_s, hrrr_conus=hrrr, families=families, crs=crs, launches=launches)
        say(json.dumps({'weather_models': record}))
        # phase 9 reuses 8a's raw HRRR CONUS file; phase 10 that file and
        # phase 9's inputs
        launches_pt, _ = phase_points(torch, kernels, tmp, card_s)
        launches_wf, _ = phase_workflow(torch, kernels, tmp, card_s)
        launches_gg, gg = phase_gunw_gnss(torch, kernels, tmp, card_s)
        launches_12, _ = phase_stats_parallel(torch, kernels, tmp, card_s, main_ctx,
                                              gg['merged_csv'])
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    return launches, launches_pt, launches_wf, launches_gg, launches_12


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print('chip_smoke: torch.cuda.is_available() is false; this run needs a CUDA GPU',
              file=sys.stderr)
        return 1
    try:
        from raider_tpu_torch import kernels
        from raider_tpu_torch.scripts import card
    except ImportError as exc:
        print(f'chip_smoke: cannot import raider_tpu_torch ({exc}); run from the repo root',
              file=sys.stderr)
        return 2

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.set_float32_matmul_precision('highest')
    say(card())
    say(f'device: {torch.cuda.get_device_name(0)} x{torch.cuda.device_count()}; '
        f'torch {torch.__version__}, CUDA {torch.version.cuda}; '
        f'matmul.allow_tf32={torch.backends.cuda.matmul.allow_tf32}, '
        f'cudnn.allow_tf32={torch.backends.cudnn.allow_tf32}')

    t0 = time.perf_counter()
    so = kernels.build()
    kernels.lib()
    say(f'build: {so.name} in {time.perf_counter() - t0:.2f} s (nvcc '
        f'{"ran" if kernels.build_seconds is not None else "skipped: cached"})')
    ptxas = brick_resources(kernels)
    say(f'ptxas, B2/K4 instances: {json.dumps(ptxas)}')

    measured = phase_kernels(torch, kernels)
    launches, main_ms, ztd, main_ctx = phase_main_path(torch, kernels,
                                                       measured['brick_integrate']['ms'])
    measured['brick_integrate']['main_path_ms'] = main_ms
    measured['ztd_totals']['get_ztd'] = ztd
    measured['ztd_totals']['ptxas'] = kernels.ptxas_resources('ztd_totals.cu')
    launches_w, b3 = phase_window(torch, kernels)
    launches_p, s4, s5 = phase_probes(torch, kernels)
    launches_k, prof = phase_profile(torch, kernels)
    launches_l, large = phase_large(torch, kernels)
    say(json.dumps({'large_cubes': large}))
    launches_wx, launches_pt, launches_wf, launches_gg, launches_12 = phase_weather_models(
        torch, kernels, main_ctx)

    record = {'kernels': [
        {'name': 'ztd_totals', 'route': 'cuda', 'source': 'raider_tpu_torch/csrc/ztd_totals.cu',
         'replaces': 'raider_tpu/ops/pallas_ztd.py:31',
         'launches': (launches['ztd_totals'] + launches_wx['ztd_totals']
                      + launches_pt['ztd_totals'] + launches_wf['ztd_totals']
                      + launches_gg['ztd_totals'] + launches_12['ztd_totals']),
         'launches_phase_8': launches_wx['ztd_totals'],
         'launches_phase_9': launches_pt['ztd_totals'],
         'launches_phase_10': launches_wf['ztd_totals'],
         'launches_phase_11': launches_gg['ztd_totals'],
         'launches_phase_12': launches_12['ztd_totals'], **measured['ztd_totals']},
        {'name': 'brick_integrate', 'route': 'cuda',
         'source': 'raider_tpu_torch/csrc/brick_integrate.cu',
         'replaces': 'raider_tpu/delay/raytrace.py:704',
         'launches': (launches['brick_integrate'] + launches_wx['brick_integrate']
                      + launches_pt['brick_integrate'] + launches_wf['brick_integrate']
                      + launches_gg['brick_integrate'] + launches_12['brick_integrate']),
         'launches_phase_8': launches_wx['brick_integrate'],
         'launches_phase_9': launches_pt['brick_integrate'],
         'launches_phase_10': launches_wf['brick_integrate'],
         'launches_phase_11': launches_gg['brick_integrate'],
         'launches_phase_12': launches_12['brick_integrate'],
         **measured['brick_integrate'], 'ptxas': ptxas.get('f32 3x3')},
        {'name': 'window_integrate', 'route': 'cuda',
         'source': 'raider_tpu_torch/csrc/window_integrate.cu',
         'replaces': 'raider_tpu/delay/pallas_window.py:217',
         'launches': launches_w['window_integrate'], **b3},
        {'name': 'probe_load', 'route': 'cuda', 'source': 'raider_tpu_torch/csrc/probe_f16.cu',
         'replaces': 'scripts/probe_f16.py:53', 'launches': launches_p['probe_load'], **s4},
        {'name': 'probe_bitcast_i16_bf16', 'route': 'cuda',
         'source': 'raider_tpu_torch/csrc/probe_f16.cu', 'replaces': 'scripts/probe_f16.py:88',
         'launches': launches_p['probe_bitcast_i16_bf16'], **s5},
        {'name': 'brick_contract', 'route': 'cuda',
         'source': 'raider_tpu_torch/csrc/brick_contract.cu',
         'replaces': 'scripts/kernel_profile.py:179', 'launches': launches_k['brick_contract'],
         **prof['brick_contract']},
        {'name': 'brick_group_rows', 'route': 'cuda', 'source': 'raider_tpu_torch/csrc/brick_group.cu',
         'replaces': 'scripts/kernel_profile.py:304', 'launches': launches_k['brick_group_rows'],
         **prof['brick_group_rows']},
        {'name': 'brick_group_merged', 'route': 'cuda',
         'source': 'raider_tpu_torch/csrc/brick_group.cu',
         'replaces': 'scripts/kernel_profile.py:475',
         'launches': launches_k['brick_group_merged'], **prof['brick_group_merged']},
        {'name': 'brick_integrate_i16', 'route': 'cuda',
         'source': 'raider_tpu_torch/csrc/brick_integrate.cu',
         'replaces': 'raider_tpu/delay/raytrace.py:704',
         'launches': launches_k['brick_integrate_i16'],
         'launches_midcube': launches_l['brick_integrate_i16'],
         'launches_phase_12': launches_12['brick_integrate_i16'], **prof['brick_integrate_i16'],
         'ptxas': ptxas.get('i16 3x3')},
    ]}
    say(json.dumps(record))
    say(json.dumps({'ok': True, 'device': {'platform': 'gpu',
                                           'kind': torch.cuda.get_device_name(0),
                                           'count': torch.cuda.device_count()}}))
    return 0


if __name__ == '__main__':
    sys.exit(main())
