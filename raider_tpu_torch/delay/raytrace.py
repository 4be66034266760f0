"""Raytrace integration: grouped sampling plans, the brick table, kernel B2.

Counterpart of ``raider_tpu/delay/raytrace.py`` for the f32 'brick' mode.

  * Host plan builders (numpy, copied): :func:`_brick_spec_for`,
    :func:`_dedup_point_walk`, :func:`build_group_plan`, :class:`GroupPlan`,
    :func:`_pad_group_plan`. They define the quadrature: the reference's
    nParts rule per level, deduplicated shared boundaries, greedy groups of
    samples whose cells fit one brick row.
  * :func:`pack_cubes`: the brick table, row (z, y, x) = [planes z][wy y]
    [wx x][wet, hydro] corner values, built on the device in z-chunks.
  * :func:`integrate_bricks`: kernel B2 (``csrc/brick_integrate.cu``) for
    CUDA tensors, :func:`integrate_bricks_ref` (a port of the JAX
    ``_integrate_bricks``, the plan as tensors) for CPU tensors.
  * :func:`integrate_rays`: one output-height slice, mode 'brick' only. The
    pack16 / pack16_i16 / pack4 / brick_i16 modes of the JAX package are
    not ported yet (ROADMAP A3).

Sample heights are the lerp between exact level-boundary points plus the
analytic chord sagitta h(f) = lerp(h0, h1, f) - f (1-f) D^2 / (2 (Re + h)).
"""

import numpy as np
import torch

from raider_tpu_torch import kernels
from raider_tpu_torch.constants import MAX_SEGMENT_LENGTH
from raider_tpu_torch.ops.interp import _locate, axis_uniform_step

# (planes, wy, wx, group_max, byte_limit): the one production brick spec
_BRICK_SPECS = (
    (7, 3, 3, 6, 6 * 1024**3),
)
_NOT_PORTED = 'is not ported to raider_tpu_torch yet (ROADMAP A3)'

# Plan lengths are padded to a multiple of this (as in the JAX package);
# padded groups integrate to exactly zero and the kernel skips them.
_PLAN_BUCKET = 4

# most samples per group the CUDA kernel holds in registers (kMaxG)
_KERNEL_MAX_G = 8


def _padded_row_width(width: int) -> int:
    """The JAX package sizes tables with rows padded to 128-lane TPU tiles;
    kept so the spec choice (and so the plan) is the same in both packages."""
    return int(np.ceil(width / 128)) * 128


def _brick_spec_for(cube_shape, dtype):
    """The brick spec (planes, wy, wx, group_max) for this cube, or None."""
    n_cells = int(np.prod(cube_shape))
    itemsize = np.dtype(dtype).itemsize
    for planes, wy, wx, gmax, limit in _BRICK_SPECS:
        if n_cells * _padded_row_width(planes * wy * wx * 2) * itemsize <= limit:
            return planes, wy, wx, gmax
    return None


def _dedup_point_walk(n_parts, gap_bounds=None):
    """The deduplicated sample-point walk that defines the quadrature:
    bottom boundary, interior samples, shared/top boundary per level, with
    trapezoid end-weights 0.5.

    Yields (lvl, frac, wa_lvl, wa, wb_lvl, wb, gap) tuples; ``gap`` is the
    per-point horizontal-motion bound from ``gap_bounds`` (per-level max
    motion), np.inf for the bottom boundary, 0.0 when no bounds are given.
    """
    L = len(n_parts)
    for zz, nparts in enumerate(n_parts):
        inv = 1.0 / (nparts - 1.0)
        if gap_bounds is None:
            gap = 0.0
        else:
            g = gap_bounds[zz]
            gap = 0.0 if not np.isfinite(g) else float(g) * inv
        if zz == 0:
            yield (0, 0.0, 0, 0.5 * inv, 0, 0.0, np.inf)   # bottom boundary
        for j in range(1, nparts - 1):                      # interior samples
            yield (zz, j * inv, zz, inv, zz, 0.0, gap)
        if zz + 1 < L:                                      # shared boundary
            inv_next = 1.0 / (n_parts[zz + 1] - 1.0)
            yield (zz + 1, 0.0, zz, 0.5 * inv, zz + 1, 0.5 * inv_next, gap)
        else:                                               # top boundary
            yield (zz, 1.0, zz, 0.5 * inv, zz, 0.0, gap)


class GroupPlan:
    """Grouped sampling plan for the brick integrate.

    Arrays of shape (n_groups, G): ``lvl`` (coordinate level), ``frac``,
    ``wa_lvl``/``wa``/``wb_lvl``/``wb`` (weight terms), ``dzoff`` (z-plane
    offset inside the brick row), ``zlo``/``zinv`` (cell-bottom height and
    inverse thickness), ``pad`` (slot is padding); ``anchor`` is
    (n_groups,), the z-cell row of each group's brick.
    """

    def __init__(self, **kw):
        self.__dict__.update(kw)


def build_group_plan(ray_lengths_max, heights, hstep_max, ys, xs, zs,
                     max_segment_length: float = MAX_SEGMENT_LENGTH,
                     group_max: int = None, planes: int = None,
                     wy: int = None, wx: int = None):
    """Group the deduplicated sampling plan for one-row-per-group bricks.

    Greedy walk: a group absorbs the next sample while (a) its size stays
    <= group_max, (b) its samples' z-cells span <= planes-2 planes, and
    (c) the summed per-gap horizontal motion bound stays <= (min(wy, wx) - 2)
    grid cells, so every ray's group stays inside a (wy-1) x (wx-1) window.

    heights: (L+1,) level-boundary chain (``level_heights``); hstep_max:
    (L,) per-level max horizontal motion over all rays, in model units.
    """
    if planes is None or wy is None or wx is None or group_max is None:
        spec = _brick_spec_for((len(zs), len(ys), len(xs)), np.float32)
        d_planes, d_wy, d_wx, d_gmax = spec if spec else _BRICK_SPECS[-1][:4]
        planes = d_planes if planes is None else planes
        wy = d_wy if wy is None else wy
        wx = d_wx if wx is None else wx
        group_max = d_gmax if group_max is None else group_max
    # clamp to >= 2: a zero-length level gives ceil(0) + 1 = 1
    n_parts = np.maximum(
        np.ceil(np.asarray(ray_lengths_max) / max_segment_length).astype(int) + 1, 2)
    heights = np.asarray(heights, dtype=np.float64)
    hstep_max = np.asarray(hstep_max, dtype=np.float64)
    zs_np = np.asarray(zs, dtype=np.float64)
    nz = zs_np.size
    cell_sizes = np.concatenate([np.diff(np.asarray(ys)), np.diff(np.asarray(xs))])
    min_cell = float(cell_sizes.min()) if cell_sizes.size else np.inf

    pts = list(_dedup_point_walk(n_parts, gap_bounds=hstep_max))

    def hint_of(lvl, frac):
        pz = heights[lvl] + frac * (heights[lvl + 1] - heights[lvl])
        return int(np.clip(np.searchsorted(zs_np, pz, side='right') - 1, 0, nz - 2))

    hints = [hint_of(p[0], p[1]) for p in pts]
    motion_budget = (min(wy, wx) - 2) * min_cell
    groups, cur, cur_hints, cur_span = [], [], [], 0.0
    for p, h in zip(pts, hints):
        if cur:
            nspan = cur_span + p[6]
            zmin = min(cur_hints + [h])
            zmax = max(cur_hints + [h])
            if (len(cur) < group_max and zmax - zmin <= planes - 2
                    and nspan <= motion_budget):
                cur.append(p)
                cur_hints.append(h)
                cur_span = nspan
                continue
            groups.append((cur, cur_hints))
        cur, cur_hints, cur_span = [p], [h], 0.0
    groups.append((cur, cur_hints))

    G = group_max
    n_g = len(groups)
    arr = {k: np.zeros((n_g, G)) for k in ('frac', 'wa', 'wb', 'zlo', 'zinv')}
    iarr = {k: np.zeros((n_g, G), dtype=np.int32) for k in ('lvl', 'wa_lvl', 'wb_lvl', 'dzoff')}
    pad = np.ones((n_g, G), dtype=bool)
    anchor = np.zeros(n_g, dtype=np.int32)
    for gi, (grp, gh) in enumerate(groups):
        za = min(gh)
        anchor[gi] = za
        for sj in range(G):
            p, h = (grp[sj], gh[sj]) if sj < len(grp) else (grp[-1], gh[-1])
            lvl, frac, wal, wa, wbl, wb, _ = p
            iarr['lvl'][gi, sj] = lvl
            arr['frac'][gi, sj] = frac
            iarr['wa_lvl'][gi, sj] = wal
            iarr['wb_lvl'][gi, sj] = wbl
            if sj < len(grp):
                arr['wa'][gi, sj] = wa
                arr['wb'][gi, sj] = wb
                pad[gi, sj] = False
            iarr['dzoff'][gi, sj] = h - za
            arr['zlo'][gi, sj] = zs_np[h]
            arr['zinv'][gi, sj] = 1.0 / (zs_np[h + 1] - zs_np[h])
    return GroupPlan(anchor=anchor, pad=pad, G=G, planes=planes, wy=wy, wx=wx, **arr, **iarr)


def _pad_group_plan(plan: GroupPlan, bucket: int) -> GroupPlan:
    n = plan.anchor.size
    target = int(np.ceil(n / bucket)) * bucket
    if target == n:
        return plan
    e = target - n
    pad_row = dict(
        anchor=np.zeros(e, np.int32),
        pad=np.ones((e, plan.G), bool),
        lvl=np.zeros((e, plan.G), np.int32),
        frac=np.zeros((e, plan.G)),
        wa_lvl=np.zeros((e, plan.G), np.int32),
        wa=np.zeros((e, plan.G)),
        wb_lvl=np.zeros((e, plan.G), np.int32),
        wb=np.zeros((e, plan.G)),
        dzoff=np.zeros((e, plan.G), np.int32),
        zlo=np.full((e, plan.G), plan.zlo.flat[0]),
        zinv=np.full((e, plan.G), plan.zinv.flat[0]),
    )
    kw = {k: np.concatenate([getattr(plan, k), pad_row[k]], axis=0) for k in pad_row}
    return GroupPlan(G=plan.G, planes=plan.planes, wy=plan.wy, wx=plan.wx, **kw)


def pack_mode_for(cube_shape, dtype, grouped: bool = False) -> str:
    """The table layout: 'brick' whenever the brick spec admits the cube."""
    if grouped and _brick_spec_for(cube_shape, dtype) is not None:
        return 'brick'
    raise NotImplementedError(
        f'cube {tuple(cube_shape)} {np.dtype(dtype)} needs a pack16/pack16_i16/pack4/'
        f'brick_i16 table, which {_NOT_PORTED}')


def _pack_bricks(cube_wet, cube_hydro, planes: int, wy: int = 3, wx: int = 3):
    """Brick table (nz*ny*nx, planes*wy*wx*2): row (z, y, x), column
    (dz, dy, dx, field) holds cube[z+dz, y+dy, x+dx], zero beyond the edge.

    Written in z-chunks of ~256 MB of rows straight into the table through
    a strided view: the only transient is the two zero-padded cubes.
    """
    nz, ny, nx = cube_wet.shape
    width = planes * wy * wx * 2
    table = torch.empty((nz * ny * nx, width), dtype=cube_wet.dtype, device=cube_wet.device)
    view = table.view(nz, ny, nx, planes, wy, wx, 2)
    padded = [torch.nn.functional.pad(c, (0, wx, 0, wy, 0, planes)) for c in (cube_wet, cube_hydro)]
    itemsize = cube_wet.element_size()
    chunk = int(max(1, min(nz, 2**28 // max(1, ny * nx * width * itemsize))))
    for z0 in range(0, nz, chunk):
        z1 = min(nz, z0 + chunk)
        for dz in range(planes):
            for dy in range(wy):
                for dx in range(wx):
                    for f, src in enumerate(padded):
                        view[z0:z1, :, :, dz, dy, dx, f] = \
                            src[z0 + dz:z1 + dz, dy:dy + ny, dx:dx + nx]
    return table


def pack_cubes(cube_wet, cube_hydro, mode=None, grouped: bool = False):
    """Build the packed table on the cubes' device; returns (table, mode)."""
    if mode is None:
        mode = pack_mode_for(cube_wet.shape, _np_dtype(cube_wet), grouped=grouped)
    if mode != 'brick':
        raise NotImplementedError(f'mode {mode!r} {_NOT_PORTED}')
    planes, wy, wx, _ = _brick_spec_for(cube_wet.shape, _np_dtype(cube_wet)) or _BRICK_SPECS[-1][:4]
    return _pack_bricks(cube_wet, cube_hydro, planes, wy, wx), mode


def _np_dtype(t: torch.Tensor):
    return np.dtype(str(t.dtype).removeprefix('torch.'))


def _plan_tensors(plan: GroupPlan, device, dtype) -> dict:
    """The plan's arrays as tensors: float fields in ``dtype``, indices int64."""
    out = {k: torch.as_tensor(getattr(plan, k), dtype=dtype, device=device)
           for k in ('frac', 'wa', 'wb', 'zlo', 'zinv')}
    out.update({k: torch.as_tensor(getattr(plan, k), dtype=torch.int64, device=device)
                for k in ('anchor', 'lvl', 'wa_lvl', 'wb_lvl', 'dzoff')})
    out['pad'] = torch.as_tensor(plan.pad, device=device)
    return out


def _row(a, i):
    """Row ``i`` (a 0-d index tensor) of a 2-D tensor, without a host sync."""
    return a.index_select(0, i.reshape(1))[0]


def integrate_bricks_ref(table2d, bnd_y, bnd_x, bnd_z, d2, ray_len, re_local,
                         plan: GroupPlan, ys, xs, zs, z_clip: bool = True):
    """Plain-torch twin of kernel B2: a port of the JAX ``_integrate_bricks``.

    The plan enters as tensors, one group at a time: each group gathers one
    brick row per ray and mixes it per sample with a one-hot over the z
    planes and hat weights in y and x. Returns (wet (N,), hydro (N,)).
    NaN anywhere in a group's brick row poisons the ray here (the kernel,
    like the TPU kernel, reads only the two planes a sample uses); the
    processed weather cubes on the delay path hold no NaN.
    """
    cdt, dev = table2d.dtype, table2d.device
    ys_np, xs_np, zs_np = (np.asarray(a) for a in (ys, xs, zs))
    ny, nx = ys_np.size, xs_np.size
    z_lo, z_hi = float(zs_np[0]), float(zs_np[-1])
    G, planes, wy, wx = plan.G, plan.planes, plan.wy, plan.wx
    P = _plan_tensors(plan, dev, cdt)
    n = bnd_y.shape[1]
    nan = torch.tensor(float('nan'), dtype=cdt, device=dev)
    zero = torch.zeros((), dtype=cdt, device=dev)
    jj = torch.arange(planes, device=dev)
    kk = torch.arange(wy, device=dev, dtype=cdt)
    ll = torch.arange(wx, device=dev, dtype=cdt)
    acc_w = torch.zeros(n, dtype=cdt, device=dev)
    acc_h = torch.zeros(n, dtype=cdt, device=dev)
    for g in range(plan.anchor.shape[0]):
        samples, iy_all, ix_all = [], [], []
        for s in range(G):
            lv = P['lvl'][g, s]
            f = P['frac'][g, s]
            ly, hy = _row(bnd_y, lv), _row(bnd_y, lv + 1)
            lx, hx = _row(bnd_x, lv), _row(bnd_x, lv + 1)
            lz, hz = _row(bnd_z, lv), _row(bnd_z, lv + 1)
            py = ly + f * (hy - ly)
            px = lx + f * (hx - lx)
            pz = lz + f * (hz - lz)
            hbar = 0.5 * (lz + hz)
            pz = pz - f * (1.0 - f) * _row(d2, lv) / (2.0 * (re_local + hbar))
            if z_clip:
                pz = pz.clamp(z_lo, z_hi)
            bz = (pz >= z_lo) & (pz <= z_hi)
            iy, fy, by = _locate(ys_np, py)
            ix, fx, bx = _locate(xs_np, px)
            fz = (pz - P['zlo'][g, s]) * P['zinv'][g, s]
            rl = (P['wa'][g, s] * _row(ray_len, P['wa_lvl'][g, s])
                  + P['wb'][g, s] * _row(ray_len, P['wb_lvl'][g, s]))
            samples.append((fy, fx, fz, by & bx & bz, rl))
            iy_all.append(iy)
            ix_all.append(ix)
        ay = torch.stack(iy_all).amin(0)
        ax = torch.stack(ix_all).amin(0)
        brick = table2d[(P['anchor'][g] * ny + ay) * nx + ax].reshape(n, planes, wy, wx, 2)
        for s in range(G):
            fy, fx, fz, ok, rl = samples[s]
            dy = iy_all[s] - ay
            dx = ix_all[s] - ax
            ok = ok & (dy <= wy - 2) & (dx <= wx - 2)
            dzo = P['dzoff'][g, s]
            wj = (torch.where(jj == dzo, 1.0 - fz[:, None], zero)
                  + torch.where(jj == dzo + 1, fz[:, None], zero))          # (N, planes)
            vz = (brick * wj[:, :, None, None, None]).sum(1)                   # (N, wy, wx, 2)
            gy = dy.to(cdt) + fy
            gx = dx.to(cdt) + fx
            wk = (1.0 - (gy[:, None] - kk).abs()).clamp_min(0.0)              # (N, wy)
            wl = (1.0 - (gx[:, None] - ll).abs()).clamp_min(0.0)              # (N, wx)
            vy = (vz * wk[:, :, None, None]).sum(1)                            # (N, wx, 2)
            v = (vy * wl[:, :, None]).sum(1)                                   # (N, 2)
            v = torch.where(ok[:, None], v, nan)
            contrib = torch.where(P['pad'][g, s], zero, (1.0e-6 * rl)[:, None] * v)
            acc_w = acc_w + contrib[:, 0]
            acc_h = acc_h + contrib[:, 1]
    return acc_w, acc_h


def integrate_bricks(table2d, bnd_y, bnd_x, bnd_z, d2, ray_len, re_local,
                     plan: GroupPlan, ys, xs, zs, z_clip: bool = True):
    """Brick integrate for one slice: (wet (N,), hydro (N,)).

    table2d (nz*ny*nx, planes*wy*wx*2); bnd_y/x/z (L+1, N) level-boundary
    points in the model CRS; d2 and ray_len (L, N); re_local (N,); the axes
    are host arrays. CPU tensors run :func:`integrate_bricks_ref`; CUDA
    tensors launch kernel B2, which takes contiguous float32 operands.
    """
    ys_np, xs_np, zs_np = (np.asarray(a, dtype=np.float64) for a in (ys, xs, zs))
    ny, nx, nz = ys_np.size, xs_np.size, zs_np.size
    L1, n = bnd_y.shape
    L = L1 - 1
    width = plan.planes * plan.wy * plan.wx * 2
    ops = (bnd_y, bnd_x, bnd_z, d2, ray_len, re_local)
    shapes = ((L1, n), (L1, n), (L1, n), (L, n), (L, n), (n,))
    if table2d.shape != (nz * ny * nx, width):
        raise ValueError(f'brick table {tuple(table2d.shape)} does not match the cube '
                         f'{(nz, ny, nx)} and plan width {width}')
    for a, shp in zip(ops, shapes):
        if tuple(a.shape) != shp or a.device != table2d.device or a.dtype != table2d.dtype:
            raise ValueError(f'integrate_bricks: operand {tuple(a.shape)} {a.dtype} {a.device} '
                             f'does not match {shp} {table2d.dtype} {table2d.device}')
    if table2d.device.type == 'cpu':
        return integrate_bricks_ref(table2d, *ops, plan, ys, xs, zs, z_clip)
    if table2d.device.type != 'cuda':
        raise ValueError(f'integrate_bricks: unsupported device {table2d.device}')
    if table2d.dtype != torch.float32 or not all(a.is_contiguous() for a in (table2d, *ops)):
        raise ValueError('integrate_bricks: the CUDA kernel takes contiguous float32 operands')
    if not 1 <= plan.G <= _KERNEL_MAX_G or ny < 2 or nx < 2:
        raise ValueError(f'integrate_bricks: G={plan.G} (max {_KERNEL_MAX_G}) on a '
                         f'{ny}x{nx} grid is outside what the kernel takes')
    # the kernel indexes with these: check them on the host
    idx_ok = ((plan.lvl >= 0).all() and (plan.lvl + 1 <= L).all()
              and (plan.wa_lvl >= 0).all() and (plan.wa_lvl < L).all()
              and (plan.wb_lvl >= 0).all() and (plan.wb_lvl < L).all()
              and (plan.dzoff >= 0).all() and (plan.dzoff <= plan.planes - 2).all()
              and (plan.anchor >= 0).all() and (plan.anchor < nz).all())
    if not idx_ok:
        raise ValueError('integrate_bricks: plan indices fall outside the operands')
    dev = table2d.device
    plan_i = torch.as_tensor(np.stack([plan.lvl, plan.wa_lvl, plan.wb_lvl, plan.dzoff,
                                       plan.pad.astype(np.int32)], -1).astype(np.int32),
                             device=dev).contiguous()
    plan_f = torch.as_tensor(np.stack([plan.frac, plan.wa, plan.wb, plan.zlo, plan.zinv],
                                      -1).astype(np.float32), device=dev).contiguous()
    anchor = torch.as_tensor(plan.anchor.astype(np.int32), device=dev)
    y_axis = torch.as_tensor(ys_np.astype(np.float32), device=dev)
    x_axis = torch.as_tensor(xs_np.astype(np.float32), device=dev)
    y_step = axis_uniform_step(ys_np)
    x_step = axis_uniform_step(xs_np)
    out = torch.empty((2, n), dtype=torch.float32, device=dev)
    kernels.launch_brick_integrate(
        table2d, *ops, plan_i, plan_f, anchor, y_axis, x_axis, out,
        G=plan.G, planes=plan.planes, wy=plan.wy, wx=plan.wx,
        y_lo=float(ys_np[0]), y_hi=float(ys_np[-1]), y_step=y_step or 0.0,
        y_uniform=y_step is not None,
        x_lo=float(xs_np[0]), x_hi=float(xs_np[-1]), x_step=x_step or 0.0,
        x_uniform=x_step is not None,
        z_lo=float(zs_np[0]), z_hi=float(zs_np[-1]), z_clip=z_clip)
    return out[0], out[1]


def slice_plan(cube_shape, table_dtype, ys, xs, zs, ray_lengths_max, heights, hstep_max,
               max_segment_length: float = MAX_SEGMENT_LENGTH) -> GroupPlan:
    """The padded grouped plan :func:`integrate_rays` integrates one slice
    with, for a brick table of ``table_dtype`` over a ``cube_shape`` cube."""
    planes, wy, wx, gmax = (_brick_spec_for(tuple(cube_shape), table_dtype)
                            or _BRICK_SPECS[-1][:4])
    plan = build_group_plan(ray_lengths_max, heights, hstep_max, ys, xs, zs,
                            max_segment_length, group_max=gmax, planes=planes, wy=wy, wx=wx)
    return _pad_group_plan(plan, _PLAN_BUCKET)


def integrate_rays(cube_wet, cube_hydro, ys, xs, zs,
                   bnd_y, bnd_x, bnd_z, d2, ray_len, re_local,
                   ray_lengths_max,
                   max_segment_length: float = MAX_SEGMENT_LENGTH,
                   z_clip: bool = True,
                   packed2d=None, mode=None, *, heights, hstep_max):
    """Integrate wet/hydro delay along all rays of one output-height slice.

    Segments are contiguous along each ray: level k runs from boundary k to
    boundary k+1 of the (L+1, N) ``bnd_*`` arrays (model CRS, y/x/z). The
    grouped plan is built from ``ray_lengths_max`` (L,), ``heights`` (L+1,)
    and ``hstep_max`` (L,); ``packed2d``/``mode`` pass a table built once by
    :func:`pack_cubes`. Returns (wet (N,), hydro (N,)) in meters.
    """
    if packed2d is None:
        packed2d, mode = pack_cubes(cube_wet, cube_hydro, grouped=True)
    if mode != 'brick':
        raise NotImplementedError(f'mode {mode!r} {_NOT_PORTED}')
    plan = slice_plan(cube_wet.shape, _np_dtype(packed2d), ys, xs, zs, ray_lengths_max,
                      heights, hstep_max, max_segment_length)
    dt = packed2d.dtype
    rays = [a.to(dt) for a in (bnd_y, bnd_x, bnd_z, d2, ray_len, re_local)]
    return integrate_bricks(packed2d, *rays, plan, ys, xs, zs, z_clip)
