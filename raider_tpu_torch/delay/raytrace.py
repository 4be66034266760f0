"""Raytrace integration: sampling plans, the packed tables, kernels B2 and K4.

Counterpart of ``raider_tpu/delay/raytrace.py``, every table mode:

  * Host plan builders (numpy, copied): :func:`_brick_spec_for`,
    :func:`_dedup_point_walk`, :func:`build_sampling_plan`,
    :func:`build_group_plan`, :class:`GroupPlan`, :func:`_pad_group_plan`,
    :func:`_pad_point_plan`, :func:`static_plan_from`. They define the
    quadrature: the reference's nParts rule per level, deduplicated shared
    boundaries, greedy groups of samples whose cells fit one brick row.
  * :func:`pack_mode_for`: the JAX package's ladder by table bytes (its
    byte limits, so both packages pick the same mode for a cube):
    'brick', 'brick_i16' (the capacity band), 'pack16', 'pack16_i16',
    'pack4'. f64 cubes never quantize.
  * :func:`pack_cubes`: the table on the cubes' device. Brick rows (z, y, x)
    = [planes z][wy y][wx x][wet, hydro] corner values; pack16 rows the 8
    cell corners x {wet, hydro}; pack4 rows {wet, hydro} x {x, x+1}. The
    int16 modes quantize each field first (:func:`_quantize_i16`) and
    return a ``(table, deq)`` pair, deq = [sw, ow, sh, oh].
  * :func:`integrate_bricks`: kernel B2 (``csrc/brick_integrate.cu``) for
    a float32 brick table on CUDA, kernel K4 (its int16 branch, decoding
    each corner it reads) for an int16 one; :func:`integrate_bricks_ref`
    (a port of the JAX ``_integrate_bricks``, the plan as tensors) for CPU
    tensors.
  * :func:`static_brick_ref`: plain torch port of the XLA
    ``_static_brick_fn`` (the static plan baked in, one U contraction per
    group), the reference of ``scripts/kernel_profile.py``.
  * :func:`_integrate_packed`: the pack16 / pack16_i16 / pack4 integrate,
    plain torch (XLA in the JAX package, no Pallas kernel).
  * :func:`integrate_rays`: one output-height slice, any mode.

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

# the JAX package's table byte limits (sized for a 16 GB TPU v5e; kept so
# that both packages pick the same mode for the same cube)
_PACK16_BYTE_LIMIT = 3 * 1024**3
_PACK16_I16_BYTE_LIMIT = 6 * 1024**3
_I16_NAN = -32768     # int16 sentinel of a non-finite cell

_CORNERS = [(0, 0, 0), (0, 0, 1), (0, 1, 0), (0, 1, 1),
            (1, 0, 0), (1, 0, 1), (1, 1, 0), (1, 1, 1)]

# Plan lengths are padded to a multiple of this (as in the JAX package);
# padded groups integrate to exactly zero and the kernel skips them.
_PLAN_BUCKET = 4


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


def build_sampling_plan(ray_lengths_max, max_segment_length: float = MAX_SEGMENT_LENGTH):
    """The deduplicated point plan of the packed (non-brick) modes.

    Returns (coord_lvl, fracs, wa_lvl, wa, wb_lvl, wb), all (P,): point p is
    at fraction fracs[p] along level coord_lvl[p]'s segment, with weight
    1e-6 * (wa[p] * ray_len[wa_lvl[p]] + wb[p] * ray_len[wb_lvl[p]]).
    """
    # clamp to >= 2: a zero-length level gives ceil(0) + 1 = 1
    n_parts = np.maximum(
        np.ceil(np.asarray(ray_lengths_max) / max_segment_length).astype(int) + 1, 2)
    coord_lvl, fracs, wa_lvl, wa, wb_lvl, wb, _ = map(list, zip(*_dedup_point_walk(n_parts)))
    return (np.asarray(coord_lvl, dtype=np.int32), np.asarray(fracs),
            np.asarray(wa_lvl, dtype=np.int32), np.asarray(wa),
            np.asarray(wb_lvl, dtype=np.int32), np.asarray(wb))


def _pad_point_plan(plan, bucket: int):
    """Zero-weight padding of the point plan to a multiple of ``bucket``."""
    coord_lvl, fracs, wa_lvl, wa, wb_lvl, wb = plan
    n = coord_lvl.size
    target = int(np.ceil(n / bucket)) * bucket
    if target == n:
        return plan
    z32 = np.zeros(target - n, np.int32)
    zf = np.zeros(target - n)
    return (np.concatenate([coord_lvl, z32]), np.concatenate([fracs, zf]),
            np.concatenate([wa_lvl, z32]), np.concatenate([wa, zf]),
            np.concatenate([wb_lvl, z32]), np.concatenate([wb, zf]))


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

    @property
    def n_points(self):
        return int((~self.pad).sum())


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
    """The table layout by table bytes, the JAX package's ladder.

    ``grouped`` (the caller has the heights chain and motion bounds) prefers
    the brick layout: 'brick' where the f32 (or f64) brick table fits,
    'brick_i16' in the capacity band where only the half-size int16 one
    does. Otherwise 'pack16' under ``_PACK16_BYTE_LIMIT``, 'pack16_i16'
    under ``_PACK16_I16_BYTE_LIMIT``, else 'pack4'. f64 cubes are the exact
    path and never quantize. A mode is forced through ``pack_cubes(mode=)``.
    """
    f32 = np.dtype(dtype) == np.float32
    if grouped:
        if _brick_spec_for(cube_shape, dtype) is not None:
            return 'brick'
        if f32 and _brick_spec_for(cube_shape, np.int16) is not None:
            return 'brick_i16'
    n_cells = int(np.prod(cube_shape))
    if n_cells * 16 * np.dtype(dtype).itemsize <= _PACK16_BYTE_LIMIT:
        return 'pack16'
    if f32 and n_cells * 16 * 2 <= _PACK16_I16_BYTE_LIMIT:
        return 'pack16_i16'
    return 'pack4'


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


def _pack_cubes(cube_wet, cube_hydro, mode: str):
    """pack16 rows [w(c0), h(c0), w(c1), h(c1), ...] over the 8 corners of
    ``_CORNERS`` of the cell anchored at each node; pack4 rows [w, h,
    w(x+1), h(x+1)]. Shifts past the edge are zero, written into the table
    through a strided view (no stacked copies)."""
    nz, ny, nx = cube_wet.shape
    shifts = _CORNERS if mode == 'pack16' else [(0, 0, 0), (0, 0, 1)]
    table = torch.zeros((nz * ny * nx, 2 * len(shifts)), dtype=cube_wet.dtype,
                        device=cube_wet.device)
    view = table.view(nz, ny, nx, len(shifts), 2)
    for c, (dz, dy, dx) in enumerate(shifts):
        for f, src in enumerate((cube_wet, cube_hydro)):
            view[:nz - dz, :ny - dy, :nx - dx, c, f] = src[dz:, dy:, dx:]
    return table


def _quantize_i16(cube):
    """Affine int16 quantization of one field: (raw int16 cube, scale f32,
    offset f32) with v ~ raw * scale + offset; non-finite cells take the
    ``_I16_NAN`` sentinel.

    As the JAX function compiles (read from the CPU backend's optimized
    HLO): the span's ``/ 65534.0`` is a multiply by float32(1 / 65534), the
    per-cell ``(cube - off) / scale`` a true division; ``torch.round``
    rounds half to even like ``jnp.round``.
    """
    dev = cube.device
    finite = torch.isfinite(cube)
    inf = torch.tensor(float('inf'), dtype=cube.dtype, device=dev)
    vmin = torch.where(finite, cube, inf).amin()
    vmax = torch.where(finite, cube, -inf).amax()
    nan = torch.tensor(float('nan'), dtype=cube.dtype, device=dev)
    any_finite = finite.any()
    vmin = torch.where(any_finite, vmin, nan)
    vmax = torch.where(any_finite, vmax, nan)
    inv_span = torch.tensor(np.float32(1.0 / 65534.0), dtype=cube.dtype, device=dev)
    scale = (vmax - vmin).clamp_min(1e-12) * inv_span
    off = (vmin + vmax) * 0.5
    raw = torch.round((cube - off) / scale).clamp(-32767, 32767)
    raw = torch.where(finite, raw, torch.tensor(float(_I16_NAN), dtype=cube.dtype, device=dev))
    return raw.to(torch.int16), scale.to(torch.float32), off.to(torch.float32)


def _i16_column_deq(n_cols: int, deq, dtype):
    """Per-column (scale, offset) vectors of a packed int16 row: columns
    alternate {wet, hydro}, deq = [sw, ow, sh, oh]."""
    wet = torch.arange(n_cols, device=deq.device) % 2 == 0
    sc = torch.where(wet, deq[0], deq[2]).to(dtype)
    of = torch.where(wet, deq[1], deq[3]).to(dtype)
    return sc, of


def _deq_brick(brick, deq, cdt):
    """int16 brick (..., 2 fields last) -> ``cdt``: per-field affine, the
    sentinel to NaN (a multiply, then an add)."""
    sc2 = torch.stack([deq[0], deq[2]]).to(cdt)
    of2 = torch.stack([deq[1], deq[3]]).to(cdt)
    nan = torch.tensor(float('nan'), dtype=cdt, device=brick.device)
    return torch.where(brick == _I16_NAN, nan, brick.to(cdt) * sc2 + of2)


def _quantized_pair(cube_wet, cube_hydro):
    """Both fields quantized: (qw, qh, deq) with deq = [sw, ow, sh, oh]."""
    qw, sw, ow = _quantize_i16(cube_wet)
    qh, sh, oh = _quantize_i16(cube_hydro)
    return qw, qh, torch.stack([sw, ow, sh, oh])


def pack_cubes(cube_wet, cube_hydro, mode=None, grouped: bool = False):
    """Build the packed table on the cubes' device; returns (table, mode),
    where the table of an int16 mode is the pair (int16 table, deq)."""
    if mode is None:
        mode = pack_mode_for(cube_wet.shape, _np_dtype(cube_wet), grouped=grouped)
    if mode in ('brick', 'brick_i16'):
        # the spec follows the TABLE dtype: int16 for the quantized mode
        tdt = np.int16 if mode == 'brick_i16' else _np_dtype(cube_wet)
        planes, wy, wx, _ = _brick_spec_for(cube_wet.shape, tdt) or _BRICK_SPECS[-1][:4]
        if mode == 'brick':
            return _pack_bricks(cube_wet, cube_hydro, planes, wy, wx), mode
        qw, qh, deq = _quantized_pair(cube_wet, cube_hydro)
        return (_pack_bricks(qw, qh, planes, wy, wx), deq), mode
    if mode == 'pack16_i16':
        qw, qh, deq = _quantized_pair(cube_wet, cube_hydro)
        return (_pack_cubes(qw, qh, 'pack16'), deq), mode
    if mode in ('pack16', 'pack4'):
        return _pack_cubes(cube_wet, cube_hydro, mode), mode
    raise ValueError(f'unknown table mode {mode!r}')


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
                         plan: GroupPlan, ys, xs, zs, z_clip: bool = True, deq=None):
    """Plain-torch twin of kernels B2 and K4: a port of the JAX
    ``_integrate_bricks``.

    The plan enters as tensors, one group at a time: each group gathers one
    brick row per ray and mixes it per sample with a one-hot over the z
    planes and hat weights in y and x. An int16 table (brick_i16) is
    decoded after the gather with ``deq`` = [sw, ow, sh, oh], whose dtype is
    the compute dtype. Returns (wet (N,), hydro (N,)).
    NaN anywhere in a group's brick row poisons the ray here (the kernels,
    like the TPU kernel, read only the two planes a sample uses); the
    processed weather cubes on the delay path hold no NaN.
    """
    cdt = deq.dtype if deq is not None else table2d.dtype
    dev = table2d.device
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
        if deq is not None:
            brick = _deq_brick(brick, deq, cdt)
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
                     plan: GroupPlan, ys, xs, zs, z_clip: bool = True, deq=None):
    """Brick integrate for one slice: (wet (N,), hydro (N,)).

    table2d (nz*ny*nx, planes*wy*wx*2), float, or int16 with ``deq`` =
    [sw, ow, sh, oh] (its dtype is the compute dtype); bnd_y/x/z (L+1, N)
    level-boundary points in the model CRS; d2 and ray_len (L, N); re_local
    (N,); the axes are host arrays. CPU tensors run
    :func:`integrate_bricks_ref`; CUDA tensors launch kernel B2 (a float32
    table) or K4 (an int16 table), which take contiguous float32 operands
    and a plan whose launch shape ``kernels.brick_launch_shape`` can size
    (it raises for one it cannot).
    """
    ys_np, xs_np, zs_np = (np.asarray(a, dtype=np.float64) for a in (ys, xs, zs))
    ny, nx, nz = ys_np.size, xs_np.size, zs_np.size
    L1, n = bnd_y.shape
    L = L1 - 1
    width = plan.planes * plan.wy * plan.wx * 2
    ops = (bnd_y, bnd_x, bnd_z, d2, ray_len, re_local)
    shapes = ((L1, n), (L1, n), (L1, n), (L, n), (L, n), (n,))
    cdt = table2d.dtype if deq is None else deq.dtype
    if table2d.shape != (nz * ny * nx, width):
        raise ValueError(f'brick table {tuple(table2d.shape)} does not match the cube '
                         f'{(nz, ny, nx)} and plan width {width}')
    if deq is not None and (table2d.dtype != torch.int16 or tuple(deq.shape) != (4,)
                            or deq.device != table2d.device):
        raise ValueError('integrate_bricks: deq (4,) goes with an int16 table on its device')
    for a, shp in zip(ops, shapes):
        if tuple(a.shape) != shp or a.device != table2d.device or a.dtype != cdt:
            raise ValueError(f'integrate_bricks: operand {tuple(a.shape)} {a.dtype} {a.device} '
                             f'does not match {shp} {cdt} {table2d.device}')
    if table2d.device.type == 'cpu':
        return integrate_bricks_ref(table2d, *ops, plan, ys, xs, zs, z_clip, deq=deq)
    if table2d.device.type != 'cuda':
        raise ValueError(f'integrate_bricks: unsupported device {table2d.device}')
    i16 = deq is not None
    if (cdt != torch.float32 or (not i16 and table2d.dtype != torch.float32)
            or not all(a.is_contiguous() for a in (table2d, *ops))):
        raise ValueError('integrate_bricks: the CUDA kernels take a contiguous float32 or int16 '
                         'table and contiguous float32 operands')
    if (plan.G < 1 or ny < 2 or nx < 2 or plan.wy < 2 or plan.wx < 2
            or not 2 <= plan.planes <= kernels.BRICK_MAX_PLANES):
        raise ValueError(f'integrate_bricks: G={plan.G}, a {plan.planes}x{plan.wy}x{plan.wx} '
                         f'brick on a {ny}x{nx} grid is outside what the kernels take')
    # the kernels index rows in 32 bits and copy (wet, hydro) pairs
    if table2d.shape[0] >= 2**31 or table2d.data_ptr() % (2 * table2d.element_size()):
        raise ValueError('integrate_bricks: the kernels take fewer than 2^31 table rows, '
                         'aligned to a (wet, hydro) pair')
    threads, smem = kernels.brick_launch_shape(plan.wy, plan.wx, table2d.element_size(), plan.G,
                                               plan.anchor.size)
    # the kernels index with these: check them on the host
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
        deq.contiguous() if i16 else None,
        G=plan.G, planes=plan.planes, wy=plan.wy, wx=plan.wx,
        y_lo=float(ys_np[0]), y_hi=float(ys_np[-1]), y_step=y_step or 0.0,
        y_uniform=y_step is not None,
        x_lo=float(xs_np[0]), x_hi=float(xs_np[-1]), x_step=x_step or 0.0,
        x_uniform=x_step is not None,
        z_lo=float(zs_np[0]), z_hi=float(zs_np[-1]), z_clip=z_clip, threads=threads, smem=smem)
    return out[0], out[1]


def static_plan_from(plan: GroupPlan):
    """Hashable (structure + constants) form of a GroupPlan.

    Returns ``(groups, planes, wy, wx)``: ``groups`` is a tuple of
    ``(anchor, samples)``, each sample the 9-tuple ``(lvl, frac, wa_lvl, wa,
    wb_lvl, wb, zlo, zinv, dzoff)`` of plain Python numbers; padding slots
    and all-padding groups are dropped.
    """
    groups = []
    for gi in range(plan.anchor.size):
        cnt = int((~plan.pad[gi]).sum())
        if cnt == 0:
            continue
        samples = tuple(
            (int(plan.lvl[gi, s]), float(plan.frac[gi, s]),
             int(plan.wa_lvl[gi, s]), float(plan.wa[gi, s]),
             int(plan.wb_lvl[gi, s]), float(plan.wb[gi, s]),
             float(plan.zlo[gi, s]), float(plan.zinv[gi, s]),
             int(plan.dzoff[gi, s]))
            for s in range(cnt))
        groups.append((int(plan.anchor[gi]), samples))
    return (tuple(groups), int(plan.planes), int(getattr(plan, 'wy', 3)),
            int(getattr(plan, 'wx', 3)))


def static_samples(rays, samples, ys_np, xs_np, zs_np, cdt, z_clip: bool = True):
    """The per-sample coordinate math of the XLA static-plan functions, for
    one group: returns (per-sample tuples (iy, ix, fy, fx, fz, ok, wt, dzo),
    anchor y cell, anchor x cell).

    As the JAX functions compute it: the plan constants are Python floats
    (f32 in f32 ops; ``f * (1 - f)`` is one Python constant), the z clip
    bounds are float64 numpy scalars, so the clipped height and the z
    fraction are float64 before the cast to ``cdt``.
    """
    bnd_y, bnd_x, bnd_z, d2, ray_len, re_local = rays
    z_lo, z_hi = float(zs_np[0]), float(zs_np[-1])
    persample, ay, ax = [], None, None
    for (lv, f, wal, wav, wbl, wbv, zlo, zinv, dzo) in samples:
        py = bnd_y[lv] + f * (bnd_y[lv + 1] - bnd_y[lv])
        px = bnd_x[lv] + f * (bnd_x[lv + 1] - bnd_x[lv])
        pz = bnd_z[lv] + f * (bnd_z[lv + 1] - bnd_z[lv])
        hbar = 0.5 * (bnd_z[lv] + bnd_z[lv + 1])
        pz = pz - (f * (1.0 - f)) * d2[lv] / (2.0 * (re_local + hbar))
        if z_clip:
            pz = pz.double().clamp(z_lo, z_hi)
        pzd = pz.double()
        bz = (pzd >= z_lo) & (pzd <= z_hi)
        iy, fy, by = _locate(ys_np, py)
        ix, fx, bx = _locate(xs_np, px)
        fz = (pz - zlo) * zinv
        rl = wav * ray_len[wal]
        if wbv:
            rl = rl + wbv * ray_len[wbl]
        persample.append((iy, ix, fy.to(cdt), fx.to(cdt), fz.to(cdt), bz & by & bx,
                          (1.0e-6 * rl).to(cdt), dzo))
        ay = iy if ay is None else torch.minimum(ay, iy)
        ax = ix if ax is None else torch.minimum(ax, ix)
    return persample, ay, ax


def static_brick_ref(table2d, bnd_y, bnd_x, bnd_z, d2, ray_len, re_local, groups,
                     planes: int, wy: int, wx: int, ys, xs, zs, z_clip: bool = True, deq=None):
    """Plain-torch port of the XLA ``_static_brick_fn`` (``groups`` from
    :func:`static_plan_from`): per group, the samples' math, one gathered
    brick row per ray (decoded with ``deq`` for an int16 table), the
    combined trilinear weights U[plane][y][x], then one multiply-add per
    used brick cell. Returns (wet (N,), hydro (N,))."""
    ys_np, xs_np, zs_np = (np.asarray(a) for a in (ys, xs, zs))
    ny, nx = ys_np.size, xs_np.size
    cdt = deq.dtype if deq is not None else table2d.dtype
    dev = table2d.device
    rays = (bnd_y, bnd_x, bnd_z, d2, ray_len, re_local)
    n = bnd_y.shape[1]
    nan = torch.tensor(float('nan'), dtype=cdt, device=dev)
    acc_w = torch.zeros(n, dtype=cdt, device=dev)
    acc_h = torch.zeros(n, dtype=cdt, device=dev)
    for za, samples in groups:
        persample, ay, ax = static_samples(rays, samples, ys_np, xs_np, zs_np, cdt, z_clip)
        brick = table2d.index_select(0, (za * ny + ay) * nx + ax).reshape(n, planes, wy, wx, 2)
        if deq is not None:
            brick = _deq_brick(brick, deq, cdt)
        U = {}
        for (iy, ix, fy, fx, fz, ok, wt, dzo) in persample:
            dyi = iy - ay
            dxi = ix - ax
            ok = ok & (dyi <= wy - 2) & (dxi <= wx - 2)
            gy = dyi.to(cdt) + fy
            gx = dxi.to(cdt) + fx
            wte = torch.where(ok, wt, nan)
            wys = [(1.0 - (gy - k).abs()).clamp_min(0.0) for k in range(wy)]
            wxs = [(1.0 - (gx - k).abs()).clamp_min(0.0) for k in range(wx)]
            w0 = wte * (1.0 - fz)
            w1 = wte * fz
            for k in range(wy):
                for l in range(wx):
                    wkl = wys[k] * wxs[l]
                    for dj, wj in ((dzo, w0), (dzo + 1, w1)):
                        t = wj * wkl
                        U[dj, k, l] = t if (dj, k, l) not in U else U[dj, k, l] + t
        for j in range(planes):
            for k in range(wy):
                for l in range(wx):
                    if (j, k, l) in U:
                        acc_w = acc_w + brick[:, j, k, l, 0] * U[j, k, l]
                        acc_h = acc_h + brick[:, j, k, l, 1] * U[j, k, l]
    return acc_w, acc_h


def _integrate_packed(packed2d, bnd_y, bnd_x, bnd_z, d2, ray_len, re_local,
                      coord_lvl, fracs, wa_lvl, wa, wb_lvl, wb, ys, xs, zs,
                      z_clip: bool = True, mode: str = 'pack16', deq=None, slab=None):
    """The pack16 / pack16_i16 / pack4 integrate (the JAX ``_integrate_packed``,
    plain torch): per point of the plan, the segment lerp and sagitta,
    locate in y, x and z, one pack16 row gather (decoded with ``deq`` for
    pack16_i16) or four pack4 row gathers, the trilinear mix and the
    trapezoid weight. The plan's numbers are tensors of the compute dtype,
    as the JAX scan carries them. Returns (wet (N,), hydro (N,)).

    ``slab`` = (z_lo, z_hi) integrates against one z-slab table of
    ``parallel.zshard`` (the rows of z anchors [z_lo, z_hi), plus one halo
    plane for pack4): row indices shift by the slab's first anchor and clip
    to the table, and a sample adds its contribution, after the NaN rule,
    only where its z cell lies in the slab (0 elsewhere)."""
    cdt = deq.dtype if deq is not None else packed2d.dtype
    dev = packed2d.device
    ys_np, xs_np, zs_np = (np.asarray(a) for a in (ys, xs, zs))
    ny, nx = ys_np.size, xs_np.size
    z_lo, z_hi = float(zs_np[0]), float(zs_np[-1])
    lvl, la, lb = (np.asarray(a, dtype=np.int64) for a in (coord_lvl, wa_lvl, wb_lvl))
    ff_t, ca_t, cb_t = (torch.as_tensor(np.asarray(a), dtype=cdt, device=dev)
                        for a in (fracs, wa, wb))
    n = bnd_y.shape[1]
    n_rows = packed2d.shape[0]
    nan = torch.tensor(float('nan'), dtype=cdt, device=dev)
    zero = torch.zeros((), dtype=cdt, device=dev)
    if mode == 'pack16_i16':
        sc, of = _i16_column_deq(16, deq, cdt)
    acc_w = torch.zeros(n, dtype=cdt, device=dev)
    acc_h = torch.zeros(n, dtype=cdt, device=dev)
    for p in range(lvl.size):
        lv, ff = int(lvl[p]), ff_t[p]
        ly, hy = bnd_y[lv], bnd_y[lv + 1]
        lx, hx = bnd_x[lv], bnd_x[lv + 1]
        lz, hz = bnd_z[lv], bnd_z[lv + 1]
        rl = ca_t[p] * ray_len[int(la[p])] + cb_t[p] * ray_len[int(lb[p])]
        py = ly + ff * (hy - ly)
        px = lx + ff * (hx - lx)
        pz = lz + ff * (hz - lz)
        hbar = 0.5 * (lz + hz)
        pz = pz - ff * (1.0 - ff) * d2[lv] / (2.0 * (re_local + hbar))
        if z_clip:
            pz = pz.double().clamp(z_lo, z_hi)
        iy, fy, by = _locate(ys_np, py)
        ix, fx, bx = _locate(xs_np, px)
        iz, fz, bz = _locate(zs_np, pz)
        lin = (iz * ny + iy) * nx + ix
        if slab is not None:
            own = (iz >= slab[0]) & (iz < slab[1])
            lin = lin - slab[0] * ny * nx
        fy, fx, fz = fy.to(cdt), fx.to(cdt), fz.to(cdt)
        if mode in ('pack16', 'pack16_i16'):
            g = packed2d.index_select(0, _rows(lin, slab, n_rows))
            if mode == 'pack16_i16':
                g = torch.where(g == _I16_NAN, nan, g.to(cdt) * sc + of)
            w00 = (1 - fy) * (1 - fx)
            w01 = (1 - fy) * fx
            w10 = fy * (1 - fx)
            w11 = fy * fx
            wlo = g[:, 0] * w00 + g[:, 2] * w01 + g[:, 4] * w10 + g[:, 6] * w11
            hlo = g[:, 1] * w00 + g[:, 3] * w01 + g[:, 5] * w10 + g[:, 7] * w11
            whi = g[:, 8] * w00 + g[:, 10] * w01 + g[:, 12] * w10 + g[:, 14] * w11
            hhi = g[:, 9] * w00 + g[:, 11] * w01 + g[:, 13] * w10 + g[:, 15] * w11
        elif mode == 'pack4':
            def xl(rows):
                g = packed2d.index_select(0, _rows(rows, slab, n_rows))
                return g[:, 0] * (1 - fx) + g[:, 2] * fx, g[:, 1] * (1 - fx) + g[:, 3] * fx

            w00v, h00v = xl(lin)
            w01v, h01v = xl(lin + nx)
            w10v, h10v = xl(lin + ny * nx)
            w11v, h11v = xl(lin + ny * nx + nx)
            wlo = w00v * (1 - fy) + w01v * fy
            hlo = h00v * (1 - fy) + h01v * fy
            whi = w10v * (1 - fy) + w11v * fy
            hhi = h10v * (1 - fy) + h11v * fy
        else:
            raise ValueError(f'_integrate_packed: unknown mode {mode!r}')
        ok = by & bx & bz
        vw = torch.where(ok, wlo * (1 - fz) + whi * fz, nan)
        vh = torch.where(ok, hlo * (1 - fz) + hhi * fz, nan)
        wt = 1.0e-6 * rl
        dw, dh = wt * vw, wt * vh
        if slab is not None:
            dw, dh = torch.where(own, dw, zero), torch.where(own, dh, zero)
        acc_w = acc_w + dw.to(cdt)
        acc_h = acc_h + dh.to(cdt)
    return acc_w, acc_h


def _rows(lin, slab, n_rows: int):
    """Row indices into a table; a slab's are clipped to its rows (those of
    a sample outside the slab are read and then masked)."""
    return lin if slab is None else lin.clamp(0, n_rows - 1)


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
                   packed2d=None, mode=None, heights=None, hstep_max=None):
    """Integrate wet/hydro delay along all rays of one output-height slice.

    Segments are contiguous along each ray: level k runs from boundary k to
    boundary k+1 of the (L+1, N) ``bnd_*`` arrays (model CRS, y/x/z).
    ``packed2d``/``mode`` pass a table built once by :func:`pack_cubes` (an
    int16 mode's table is the ``(table, deq)`` pair). The brick modes
    integrate a grouped plan built from ``ray_lengths_max`` (L,),
    ``heights`` (L+1,) and ``hstep_max`` (L,); the packed modes the point
    plan of ``ray_lengths_max``. Returns (wet (N,), hydro (N,)) in meters.
    """
    grouped_ok = heights is not None and hstep_max is not None
    if packed2d is None:
        packed2d, mode = pack_cubes(cube_wet, cube_hydro, grouped=grouped_ok)
    deq = None
    if mode in ('pack16_i16', 'brick_i16'):
        packed2d, deq = packed2d
    dt = packed2d.dtype if deq is None else deq.dtype
    rays = [a.to(dt) for a in (bnd_y, bnd_x, bnd_z, d2, ray_len, re_local)]
    if mode in ('brick', 'brick_i16'):
        if not grouped_ok:
            raise ValueError(f'mode {mode!r} needs heights and hstep_max')
        plan = slice_plan(cube_wet.shape, _np_dtype(packed2d), ys, xs, zs, ray_lengths_max,
                          heights, hstep_max, max_segment_length)
        if packed2d.shape[1] != plan.planes * plan.wy * plan.wx * 2:
            raise ValueError(f'packed table width {packed2d.shape[1]} does not match the brick '
                             f'spec of a {tuple(cube_wet.shape)} {packed2d.dtype} table')
        return integrate_bricks(packed2d, *rays, plan, ys, xs, zs, z_clip, deq=deq)
    plan = _pad_point_plan(build_sampling_plan(ray_lengths_max, max_segment_length), _PLAN_BUCKET)
    return _integrate_packed(packed2d, *rays, *plan, ys, xs, zs, z_clip=z_clip, mode=mode, deq=deq)
