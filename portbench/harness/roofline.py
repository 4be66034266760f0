"""Roofline arithmetic: published H100 peaks and the work a kernel must do.

``bound`` is a frozen copy of the port's smoke run (``chip_smoke.py::bound``):
the least time is the larger of the bytes at the memory rate and the float32
operations at the peak rate (NVIDIA's H100 SXM data sheet). Each input byte
is counted once and each output byte once; work that depends on the data is
counted from what these inputs need, by the reference's own geometry.
"""

import numpy as np
import torch

from portbench.harness import fields
from portbench.reference import hrrr as ref

HBM_BYTES_PER_S = 3.35e12
F32_FLOP_PER_S = 67e12
# a sample's two trilinear blends (7 lerps of 3 operations each, wet and hydro)
FLOP_PER_SAMPLE = 42


def bound(n_bytes: float, flops: float) -> float:
    """Seconds: the larger of the bytes at the memory rate and the
    operations at the float32 rate."""
    return max(n_bytes / HBM_BYTES_PER_S, flops / F32_FLOP_PER_S)


def touched_nodes(grid: ref.Grid, xyz, look, chain) -> int:
    """Distinct nodes of ``grid`` at the eight corners of the cells that
    hold the rays' level-boundary points (the points every integrate of the
    ray must sample). Fewer rays can only find fewer nodes."""
    nz, ny, nx = grid.zs.size, grid.ys.size, grid.xs.size
    mark = torch.zeros(nz * ny * nx, dtype=torch.bool, device=xyz.device)
    zt = torch.as_tensor(grid.zs, device=xyz.device)
    for h in chain:
        s = ref.crossing(xyz, look, float(h), iters=4)
        lat, lon, z = ref.ecef_to_geodetic(xyz + s[:, None] * look)
        x, y = grid.proj.forward(lat, lon)
        fy, fx = (y - grid.ys[0]) / grid.dy, (x - grid.xs[0]) / grid.dx
        ok = torch.isfinite(fy) & torch.isfinite(fx) & (fy >= 0) & (fy <= ny - 1) \
            & (fx >= 0) & (fx <= nx - 1)
        iz = (torch.searchsorted(zt, z[ok].contiguous(), right=True) - 1).clamp(0, nz - 2)
        iy = torch.floor(fy[ok]).long().clamp(0, ny - 2)
        ix = torch.floor(fx[ok]).long().clamp(0, nx - 2)
        for dz in (0, 1):
            for dy in (0, 1):
                for dx in (0, 1):
                    mark[((iz + dz) * ny + iy + dy) * nx + ix + dx] = True
    return int(mark.sum())


def b2_least_seconds(scene, k: int) -> float:
    """The least time of kernel B2 over the slices of request ``k``: per
    slice of N rays and L level segments, its operands (the float32 boundary
    y, x, z (L+1, N), d2 and lengths (L, N), the local radius (N,)) read
    once, two (N,) outputs written, the table's (wet, hydro) pairs at the
    touched nodes read once, and one sample a boundary point."""
    f, _ = scene.inputs(k)
    ypts, xpts = scene.pixels[f]
    y0, y1, x0, x1 = scene.window
    _, xs, ys, _, _ = fields.grid_axes(scene.grid, 'cpu')
    grid = ref.Grid(xs[x0:x1], ys[y0:y1], scene.ladder, ref.LambertConformal(scene.grid['crs_cf']))
    yy, xx = np.meshgrid(ypts, xpts, indexing='ij')
    lat = torch.as_tensor(yy.ravel(), device=scene.device)
    lon = torch.as_tensor(xx.ravel(), device=scene.device)
    zref = float(scene.ladder[-1]) - 1.0
    n = lat.numel()
    total = 0.0
    for ht in scene.heights:
        chain = ref.level_chain(scene.ladder, ht, zref)
        if chain is None:
            continue
        xyz, look, _, _ = ref.ray_geometry(lat, lon, ht, scene.orbits[f],
                                           scene.ladder, zref)
        segs = len(chain) - 1
        n_bytes = 4 * n * (3 * (segs + 1) + 2 * segs + 1 + 2) \
            + 2 * 4 * touched_nodes(grid, xyz, look, chain)
        total += bound(n_bytes, FLOP_PER_SAMPLE * n * (segs + 1))
    return total
