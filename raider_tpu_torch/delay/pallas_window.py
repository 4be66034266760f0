"""Windowed raytrace integrate: kernel B3, its twin and the entry point.

Counterpart of ``raider_tpu/delay/pallas_window.py``. The rays are the
pixels of an output grid, taken in tiles of TILE_Y x TILE_X pixels. A
pre-pass (:func:`_window_anchors`) finds, for each tile and plan group, the
lowest cell the tile's samples use and their spread; a tile whose spread
does not fit the largest window makes the whole call decline
(``used=False``: the caller integrates with the brick table instead). The
integrate then reads every sample's corners straight from the two weather
cubes: no brick table is built.

  * :func:`integrate_rays_windowed`: the entry point, with the JAX signature
    and return value ``(wet, hydro, used)``.
  * :func:`window_integrate`: kernel B3 (``csrc/window_integrate.cu``) for
    CUDA tensors, :func:`window_integrate_ref` (the plain-torch twin of the
    Pallas ``_kernel``, in its order of operations) for CPU tensors.

The 256-wide window and the 8/128 quantization of the anchors exist for the
TPU's (8, 128) HBM tiling. They stay here as the admission rule and as the
anchors of the window test, so that results and ``used`` match the JAX
package. The kernel's operand ring is planned here, on the host:
:func:`ring_schedule` gives each operand row the plan's samples read a slot
of the kernel's shared-memory ring.

Two rules differ from the brick integrate (``delay/raytrace.py``): a cell is
located by a multiply with ``yinv = float32(1 / ystep)``, not by a division,
and a sample is in bounds when ``py >= ylo`` and ``posy <= ny - 1``.
"""

import numpy as np
import torch

from raider_tpu_torch import kernels
from raider_tpu_torch.utils import require_device

WX = 256          # window width in cube x cells (two 128-lane TPU tiles)
TILE_Y = 8        # ray tile = TILE_Y x TILE_X output pixels
TILE_X = 64
TILE = TILE_Y * TILE_X
WY_BUCKETS = (8, 16, 32, 40)


def _uniform_params(axis_np):
    axis_np = np.asarray(axis_np, dtype=np.float64)
    n = axis_np.size
    if n < 2:
        return None
    diffs = np.diff(axis_np)
    if not np.allclose(diffs, diffs[0], rtol=1e-6, atol=0.0):
        return None
    step = (float(axis_np[-1]) - float(axis_np[0])) / (n - 1)
    return float(axis_np[0]), float(axis_np[-1]), step, n


def _f32(x: float) -> float:
    """``x`` rounded to float32, as a Python float (exact in any f32 op)."""
    return float(np.float32(x))


def _tile_order(nyo: int, nxo: int, device):
    """(perm, sel) of a (nyo, nxo) pixel grid in tiles of TILE_Y x TILE_X:
    ``perm[p]`` is the pixel at tile-order slot p, the ragged edge padded
    with copies of the edge pixels; ``sel[k]`` is pixel k's first slot (its
    padded copies all lie later in tile order)."""
    nty, ntx = -(-nyo // TILE_Y), -(-nxo // TILE_X)
    p = torch.arange(nty * ntx * TILE, device=device)
    tile, inner = p // TILE, p % TILE
    y = ((tile // ntx) * TILE_Y + inner // TILE_X).clamp(max=nyo - 1)
    x = ((tile % ntx) * TILE_X + inner % TILE_X).clamp(max=nxo - 1)
    yy = torch.arange(nyo, device=device)[:, None]
    xx = torch.arange(nxo, device=device)[None, :]
    sel = ((yy // TILE_Y) * ntx + xx // TILE_X) * TILE + (yy % TILE_Y) * TILE_X + xx % TILE_X
    return y * nxo + x, sel.reshape(-1)


def _window_anchors(low_y, low_x, high_y, high_x, lvl, frac, pad, n_tiles: int,
                    yparams, xparams):
    """Per-(tile, group) lowest cells and highest cells of the tile's samples.

    Returns (ay, ax, my, mx), host int64 arrays of shape (n_tiles, n_groups).
    Samples that are NaN, padding or out of the grid count for neither: a
    tile-group without a valid sample has ay = ax = 2**30 and my = mx = -1.

    The arithmetic is the JAX pre-pass as XLA compiles it on the CPU: the
    lerp ``ly + f (hy - ly)`` is one fused multiply-add, and the division by
    the constant step becomes a multiply by ``1 / float32(step)`` rounded
    in float32 (read from the optimized HLO). Taking it the same way keeps
    the anchors, and so ``used``, identical to the JAX package's.
    """
    ylo, _, ystep, ny = yparams
    xlo, _, xstep, nx = xparams
    big = 1 << 30
    ylo, xlo = _f32(ylo), _f32(xlo)
    yrec = float(np.float32(1.0) / np.float32(ystep))
    xrec = float(np.float32(1.0) / np.float32(xstep))
    dev = low_y.device
    out = []
    for g in range(lvl.shape[0]):
        lv = torch.as_tensor(lvl[g], dtype=torch.int64, device=dev)
        f = torch.as_tensor(np.asarray(frac[g], np.float32), device=dev).double()[:, None]
        pd = torch.as_tensor(np.asarray(pad[g], bool), device=dev)[:, None]
        ly, hy = low_y.index_select(0, lv), high_y.index_select(0, lv)
        lx, hx = low_x.index_select(0, lv), high_x.index_select(0, lv)
        # one rounding of f * (hy - ly) + ly: the product is exact in f64
        py = (ly.double() + f * (hy - ly).double()).float()
        px = (lx.double() + f * (hx - lx).double()).float()
        posy = (py - ylo) * yrec
        posx = (px - xlo) * xrec
        invalid = (torch.isnan(py) | torch.isnan(px) | pd
                   | (py < ylo) | (posy > ny - 1) | (px < xlo) | (posx > nx - 1))
        iy = torch.where(invalid, big, torch.floor(posy).nan_to_num(0.0).clamp(0, ny - 2).long())
        ix = torch.where(invalid, big, torch.floor(posx).nan_to_num(0.0).clamp(0, nx - 2).long())
        iy_t = iy.reshape(-1, n_tiles, TILE).transpose(0, 1).reshape(n_tiles, -1)
        ix_t = ix.reshape(-1, n_tiles, TILE).transpose(0, 1).reshape(n_tiles, -1)
        out.append(torch.stack([iy_t.amin(1), ix_t.amin(1),
                                torch.where(iy_t >= big, -1, iy_t).amax(1),
                                torch.where(ix_t >= big, -1, ix_t).amax(1)]))
    ay, ax, my, mx = torch.stack(out, -1).cpu().numpy()
    return ay, ax, my, mx


# A sample of kernel B3 reads 9 operand rows: y, x, z at the segment's low
# end, y, x, z at its high end, d^2 (all at the sample's level), and the ray
# length at its two trapezoid levels. A row is (array, row): array 0 lo and
# 1 hi (rows c L + level, c = 0, 1, 2 for y, x, z), 2 d2, 3 ray_len.
SAMPLE_WORDS = 8      # int32 words a sample in the kernel's schedule (two int4)
SAMPLE_FLOATS = 8     # frac, wa, wb, zlo, zinv and 3 spare (two float4)


def sample_rows(lvl: int, wa_lvl: int, wb_lvl: int, L: int) -> list:
    """The 9 (array, row) operand rows of a sample, in the kernel's order."""
    return [(0, lvl), (0, L + lvl), (0, 2 * L + lvl), (1, lvl), (1, L + lvl),
            (1, 2 * L + lvl), (2, lvl), (3, wa_lvl), (3, wb_lvl)]


def ring_schedule(lvl, wa_lvl, wb_lvl, pad, L: int, depth: int) -> dict:
    """Kernel B3's operand ring for a plan, fetching ``depth`` samples ahead.

    The real samples are taken in the plan's order (groups, then slots,
    padding skipped). Sample k's rows that no earlier sample read are copied
    in commit group k, which the kernel issues at iteration k - depth (the
    prologue for k < depth), after the barrier that ends iteration
    k - depth - 1. Each row goes into a slot whose previous row's last
    reader came before that iteration, the lowest such slot first, and stays
    until its own last reader: every row is copied once.

    Returns a dict: ``order`` [(g, s)], ``rows`` [9 (array, row)] and
    ``reads`` (K, 9) the slot each row is read from, per sample;
    ``fetches`` [[(array, row, slot)]] per commit group; ``last`` (K,)
    whether k ends its group; ``n_slots``.
    """
    order = [(g, s) for g in range(pad.shape[0]) for s in range(pad.shape[1]) if not pad[g, s]]
    rows = [sample_rows(int(lvl[g, s]), int(wa_lvl[g, s]), int(wb_lvl[g, s]), L)
            for g, s in order]
    K = len(order)
    last_use = {}
    for k, keys in enumerate(rows):
        for key in keys:
            last_use[key] = k
    slot_of, held, slot_last, fetches = {}, [], [], []   # row -> slot, slot -> row
    reads = np.zeros((K, 9), np.int64)
    for k, keys in enumerate(rows):
        it = k - depth                    # the iteration that issues commit group k
        mine = []
        for key in dict.fromkeys(keys):
            if key in slot_of:
                continue
            free = next((i for i, u in enumerate(slot_last) if u <= it - 1), None)
            if free is None:
                free = len(slot_last)
                held.append(None)
                slot_last.append(0)
            slot_of.pop(held[free], None)
            slot_of[key], held[free], slot_last[free] = free, key, last_use[key]
            mine.append((key[0], key[1], free))
        fetches.append(mine)
        reads[k] = [slot_of[key] for key in keys]
    groups = [g for g, _ in order]
    last = np.array([k == K - 1 or groups[k] != groups[k + 1] for k in range(K)], bool)
    return dict(order=order, rows=rows, reads=reads, fetches=fetches, last=last,
                n_slots=len(slot_last))


def schedule_arrays(b: 'WindowBatch', sch: dict):
    """(int32 words, float32 values) of a :func:`ring_schedule` for kernel
    B3, which reads each sample's as two int4 and two float4. Per sample
    ``SAMPLE_WORDS`` words: the ring slots of its 9 rows a byte each (ly,
    lx, lz, hy | hx, hz, d2, rl[wa] | rl[wb], with the end of its group <<
    16); group | level << 16; cube plane; fetch start | count << 16; 0;
    wa_lvl | wb_lvl << 16. Then the fetches (slot | array << 8 | row << 10).
    Per sample ``SAMPLE_FLOATS`` values: frac, wa, wb, zlo, zinv, 0, 0, 0."""
    K = len(sch['order'])
    words = np.zeros((K, SAMPLE_WORDS), np.int64)
    floats = np.zeros((K, SAMPLE_FLOATS), np.float32)
    fetch, start = [], 0
    rd = sch['reads']
    for k, (g, s) in enumerate(sch['order']):
        fe = sch['fetches'][k]
        words[k] = [rd[k, 0] | rd[k, 1] << 8 | rd[k, 2] << 16 | rd[k, 3] << 24,
                    rd[k, 4] | rd[k, 5] << 8 | rd[k, 6] << 16 | rd[k, 7] << 24,
                    rd[k, 8] | int(sch['last'][k]) << 16,
                    g | int(b.lvl[g, s]) << 16,
                    int(b.za[g] + b.dzo[g, s]),
                    start | len(fe) << 16,
                    0,
                    int(b.wa_lvl[g, s]) | int(b.wb_lvl[g, s]) << 16]
        floats[k, :5] = [b.frac[g, s], b.wa[g, s], b.wb[g, s], b.zlo[g, s], b.zinv[g, s]]
        fetch += [slot | arr << 8 | row << 10 for arr, row, slot in fe]
        start += len(fe)
    out = np.concatenate([words.reshape(-1), np.asarray(fetch, np.int64)])
    return out.astype(np.uint32).view(np.int32), floats.reshape(-1)


def pair_cubes(cube_wet, cube_hydro, device):
    """(nz, ny, nx, 2) float32 on ``device``: the two (nz, ny, nx) cubes
    interleaved as (wet, hydro) pairs, so that kernel B3 reads a corner of
    both with one 8-byte load. Unlike the JAX package's cubes they are not
    zero-padded in x: no sample reads a cell past ``nx - 1``."""
    # a complex64 array holds (real, imaginary) float32 pairs: one pass that
    # writes whole 8-byte pairs
    return torch.view_as_real(torch.complex(
        *(torch.as_tensor(c, dtype=torch.float32, device=device) for c in (cube_wet, cube_hydro))))


class WindowBatch:
    """The operands of one windowed integrate, rays in tile order.

    Tensors: ``lo``/``hi`` (3, L, n) y/x/z at each segment's ends, ``d2`` and
    ``ray_len`` (L, n), ``re`` (n,), ``cube`` (nz, ny, nx, 2) both cubes
    interleaved as (wet, hydro) pairs, ``cube_w`` and ``cube_h`` its
    (nz, ny, nx) views, ``ay``/``ax`` (n_tiles, n_groups)
    quantized window anchors, ``sel`` (n_pixels,) the tile-order position
    of each pixel.
    Host: the plan arrays ``lvl``, ``frac``, ``wa_lvl``, ``wa``, ``wb_lvl``,
    ``wb``, ``zlo``, ``zinv``, ``pad`` and ``dzo`` (n_groups, G), ``za``
    (n_groups,) and the scalars ``wy``, ``ny``, ``nx``, ``ylo``, ``yinv``,
    ``xlo``, ``xinv``, ``zs0``, ``zs1`` (float32 values), ``z_clip``.
    """

    def __init__(self, **kw):
        self.__dict__.update(kw)


def prepare_windowed(cube_wet, cube_hydro, ys, xs, zs, low_yxz, high_yxz, d2, ray_len,
                     re_local, plan, ray_grid_shape, z_clip: bool = True, *, device='cuda'):
    """The :class:`WindowBatch` of :func:`integrate_rays_windowed`, or None
    when the batch is declined (the same rule as the JAX package)."""
    dev = require_device(device)
    ys_np, xs_np, zs_np = (np.asarray(a, np.float64) for a in (ys, xs, zs))
    yparams = _uniform_params(ys_np)
    xparams = _uniform_params(xs_np)
    if yparams is None or xparams is None:
        return None

    nyo, nxo = ray_grid_shape
    L, n_rays = tuple(ray_len.shape)[:2]
    if n_rays != nyo * nxo:
        return None
    nz, ny, nx = tuple(cube_wet.shape)
    planes = int(plan.planes)
    if nz < planes or ny < max(WY_BUCKETS) + 8:
        return None

    perm, sel = _tile_order(nyo, nxo, dev)
    n_tiles = perm.shape[0] // TILE

    def reorder(a, axis):
        return torch.as_tensor(a, dtype=torch.float32, device=dev).index_select(axis, perm)

    lo = reorder(low_yxz, 1).movedim(-1, 0).contiguous()      # (3, L, n)
    hi = reorder(high_yxz, 1).movedim(-1, 0).contiguous()
    d2_t = reorder(d2, 1).contiguous()
    rl_t = reorder(ray_len, 1).contiguous()
    re_t = reorder(re_local, 0).contiguous()

    ay, ax, my, mx = _window_anchors(lo[0], lo[1], hi[0], hi[1], plan.lvl, plan.frac,
                                     plan.pad, n_tiles, yparams, xparams)

    # anchors quantized down to the (8, 128) tiling, then clipped in bounds;
    # the spread must fit the window after the clip (the clip moves anchors
    # down); +2 covers the upper corner; an all-invalid tile-group has
    # my = -1 and drops out
    ay = (ay // 8) * 8
    ax = (ax // 128) * 128
    nxp = max(-(-nx // 128) * 128, WX)
    ax = np.clip(np.minimum(ax, nxp - WX), 0, max(nxp - WX, 0))
    if int(np.maximum(mx - ax, -1).max(initial=-1)) + 2 > WX:
        return None
    wy = None
    for b in WY_BUCKETS:                  # the smallest bucket that fits
        ay_b = np.clip(np.minimum(ay, ((ny - b) // 8) * 8), 0, max(ny - b, 0))
        if int(np.maximum(my - ay_b, -1).max(initial=-1)) + 2 <= b:
            wy, ay = b, ay_b
            break
    if wy is None:
        return None

    # z anchors shifted so [za, za + planes) is in bounds; offsets follow
    za = np.asarray(plan.anchor, np.int64)
    za_s = np.minimum(za, max(nz - planes, 0))
    dzo = np.asarray(plan.dzoff, np.int64) + (za - za_s)[:, None]

    cube = pair_cubes(cube_wet, cube_hydro, dev)
    ylo, _, ystep, _ = yparams
    xlo, _, xstep, _ = xparams
    f32 = lambda a: np.asarray(a, np.float32)
    return WindowBatch(
        lo=lo, hi=hi, d2=d2_t, ray_len=rl_t, re=re_t, cube=cube, cube_w=cube[..., 0],
        cube_h=cube[..., 1],
        ay=torch.as_tensor(ay, dtype=torch.int32, device=dev).contiguous(),
        ax=torch.as_tensor(ax, dtype=torch.int32, device=dev).contiguous(),
        sel=sel,
        lvl=np.asarray(plan.lvl, np.int64), frac=f32(plan.frac),
        wa_lvl=np.asarray(plan.wa_lvl, np.int64), wa=f32(plan.wa),
        wb_lvl=np.asarray(plan.wb_lvl, np.int64), wb=f32(plan.wb),
        zlo=f32(plan.zlo), zinv=f32(plan.zinv), pad=np.asarray(plan.pad, bool),
        dzo=dzo, za=za_s, wy=wy, ny=ny, nx=nx,
        ylo=_f32(ylo), yinv=_f32(1.0 / ystep), xlo=_f32(xlo), xinv=_f32(1.0 / xstep),
        zs0=_f32(zs_np[0]), zs1=_f32(zs_np[-1]), z_clip=bool(z_clip))


def window_integrate_ref(b: WindowBatch):
    """Plain-torch twin of kernel B3 (the Pallas ``_kernel``): (wet, hydro)
    in tile order.

    Per ray, group and sample, in the kernel's order of operations: the
    sample lerp and sagitta, ``posy = (py - ylo) * yinv``, the bounds and
    window tests against the quantized anchors, ``fz = (pz - zlo) * zinv``,
    the x-blend ``(1-fx) v[dx] + fx v[dx+1]`` of the four (plane, y) rows,
    their mix ``((s00 m00 + s01 m01) + s10 m10) + s11 m11`` and the weight
    ``1e-6 (wa rl[wa_lvl] + wb rl[wb_lvl])``, both terms always. A sample
    that fails a test is NaN; padding adds nothing. Each group sums its
    samples from zero and adds the sum to the ray's total.
    """
    dev = b.re.device
    n = b.re.shape[0]
    ny, nxp = b.cube_w.shape[1:]
    plane = ny * nxp
    cubes = (b.cube_w.reshape(-1), b.cube_h.reshape(-1))
    nan = torch.tensor(float('nan'), dtype=torch.float32, device=dev)
    out = [torch.zeros(n, dtype=torch.float32, device=dev) for _ in range(2)]
    for g in range(b.lvl.shape[0]):
        if b.pad[g].all():
            continue
        ay = b.ay[:, g].long().repeat_interleave(TILE)
        ax = b.ax[:, g].long().repeat_interleave(TILE)
        acc = [torch.zeros(n, dtype=torch.float32, device=dev) for _ in range(2)]
        for s in range(b.lvl.shape[1]):
            if b.pad[g, s]:
                continue
            lv = int(b.lvl[g, s])
            f = b.frac[g, s]
            ly, lx, lz = b.lo[0, lv], b.lo[1, lv], b.lo[2, lv]
            hy, hx, hz = b.hi[0, lv], b.hi[1, lv], b.hi[2, lv]
            py = ly + float(f) * (hy - ly)
            px = lx + float(f) * (hx - lx)
            pz = lz + float(f) * (hz - lz)
            hbar = 0.5 * (lz + hz)
            pz = pz - float(f * (np.float32(1.0) - f)) * b.d2[lv] / (2.0 * (b.re + hbar))
            if b.z_clip:
                pz = pz.clamp(b.zs0, b.zs1)
            bz = (pz >= b.zs0) & (pz <= b.zs1)
            posy = (py - b.ylo) * b.yinv
            iy = torch.floor(posy).nan_to_num(0.0).clamp(0, ny - 2)
            fy = posy - iy
            by = (py >= b.ylo) & (posy <= ny - 1)
            posx = (px - b.xlo) * b.xinv
            ix = torch.floor(posx).nan_to_num(0.0).clamp(0, b.nx - 2)
            fx = posx - ix
            bx = (px >= b.xlo) & (posx <= b.nx - 1)
            iy, ix = iy.long(), ix.long()
            dy, dx = iy - ay, ix - ax
            fz = (pz - float(b.zlo[g, s])) * float(b.zinv[g, s])
            ok = by & bx & bz & (dy >= 0) & (dy <= b.wy - 2) & (dx >= 0) & (dx <= WX - 2)
            base = (int(b.za[g] + b.dzo[g, s]) * ny + iy) * nxp + ix
            wz0, wy0, wx0 = 1.0 - fz, 1.0 - fy, 1.0 - fx
            mix = (wz0 * wy0, wz0 * fy, fz * wy0, fz * fy)
            rl = (float(b.wa[g, s]) * b.ray_len[int(b.wa_lvl[g, s])]
                  + float(b.wb[g, s]) * b.ray_len[int(b.wb_lvl[g, s])])
            wt = 1.0e-6 * rl
            for k, cube in enumerate(cubes):
                val = None
                for m, off in zip(mix, (0, nxp, plane, plane + nxp)):
                    sel = wx0 * cube[base + off] + fx * cube[base + off + 1]
                    val = sel * m if val is None else val + sel * m
                acc[k] = acc[k] + wt * torch.where(ok, val, nan)
        out = [o + a for o, a in zip(out, acc)]
    return out[0], out[1]


def _check_batch(b: WindowBatch) -> None:
    """Shapes, dtypes and devices the kernel relies on."""
    _, L, n = b.lo.shape
    nz, ny, nxp = b.cube_w.shape
    n_groups = b.lvl.shape[0]
    shapes = ((b.lo, (3, L, n)), (b.hi, (3, L, n)), (b.d2, (L, n)), (b.ray_len, (L, n)),
              (b.re, (n,)), (b.cube_w, (nz, ny, nxp)), (b.cube_h, (nz, ny, nxp)))
    for a, shp in shapes + ((b.cube, (nz, ny, nxp, 2)),):
        if tuple(a.shape) != shp or a.dtype != torch.float32 or a.device != b.re.device:
            raise ValueError(f'window_integrate: operand {tuple(a.shape)} {a.dtype} {a.device} '
                             f'does not match {shp} float32 {b.re.device}')
    base, step = b.cube.data_ptr(), b.cube.element_size()
    if (b.cube_w.data_ptr(), b.cube_h.data_ptr()) != (base, base + step) or \
            b.cube_w.stride() != b.cube.stride()[:3] or b.cube_h.stride() != b.cube.stride()[:3]:
        raise ValueError('window_integrate: cube_w and cube_h are not the views of cube')
    for a in (b.ay, b.ax):
        if n % TILE or a.shape != (n // TILE, n_groups) or a.dtype != torch.int32:
            raise ValueError(f'window_integrate: {n} rays are not whole tiles of {TILE} with '
                             f'(n_tiles, {n_groups}) int32 anchors')


def _check_plan(b: WindowBatch) -> None:
    """Plan indices inside the operands."""
    L = b.lo.shape[1]
    nz, ny, nxp = b.cube_w.shape
    planes = b.za[:, None] + b.dzo
    if not ((b.lvl >= 0).all() and (b.lvl < L).all()
            and (b.wa_lvl >= 0).all() and (b.wa_lvl < L).all()
            and (b.wb_lvl >= 0).all() and (b.wb_lvl < L).all()
            and (planes >= 0).all() and (planes <= nz - 2).all()
            and b.ny == ny and 2 <= b.nx <= nxp and b.wy >= 2):
        raise ValueError('window_integrate: plan indices fall outside the operands')


_SCHEDULES = {}   # ring schedules by plan, stage count and device (see _schedule)


def _schedule(b: WindowBatch) -> tuple:
    """(ring schedule, its int32 words, its float32 values) of kernel B3 as
    the library is built (its stage count), the arrays on the batch's
    device; kept by the plan's bytes and the operands' shapes, so that the
    plan's checks, the host work and the copies to the device run once per
    plan."""
    _, stages = kernels.window_integrate_config()
    dev = b.re.device
    key = (stages, str(dev), b.lo.shape[1], tuple(b.cube_w.shape), b.ny, b.nx, b.wy,
           *(np.ascontiguousarray(a).tobytes() for a in (
               b.lvl, b.wa_lvl, b.wb_lvl, b.pad, b.za, b.dzo, b.frac, b.wa, b.wb, b.zlo,
               b.zinv)))
    if key not in _SCHEDULES:
        _check_plan(b)
        if len(_SCHEDULES) >= 64:
            _SCHEDULES.clear()
        sch = ring_schedule(b.lvl, b.wa_lvl, b.wb_lvl, b.pad, b.lo.shape[1], stages - 1)
        _SCHEDULES[key] = (sch, *(torch.as_tensor(a, device=dev)
                                  for a in schedule_arrays(b, sch)))
    return _SCHEDULES[key]


def window_launch_shape(b: WindowBatch) -> dict:
    """Kernel B3's launch for a batch, as its C launcher derives it: threads
    a block, dynamic shared bytes, the ring's slots and the stage count.
    ValueError for what the launcher refuses."""
    sch, _, _ = _schedule(b)
    threads, smem = kernels.window_integrate_shape(
        sch['n_slots'], len(sch['order']), sum(map(len, sch['fetches'])), b.lvl.shape[0])
    return dict(threads=threads, smem_bytes=smem, n_slots=sch['n_slots'],
                stages=kernels.window_integrate_config()[1])


def window_integrate(b: WindowBatch):
    """Windowed integrate of a :class:`WindowBatch`: (wet, hydro) in tile
    order. CPU tensors run :func:`window_integrate_ref`; CUDA tensors
    launch kernel B3, which takes contiguous float32 operands, and whose
    launcher refuses (RuntimeError, no launch) operands that are not
    16-byte aligned or a schedule that does not fit a block."""
    _check_batch(b)
    dev = b.re.device
    if dev.type == 'cpu':
        _check_plan(b)
        return window_integrate_ref(b)
    if dev.type != 'cuda':
        raise ValueError(f'window_integrate: unsupported device {dev}')
    ops = (b.lo, b.hi, b.d2, b.ray_len, b.re, b.cube, b.ay, b.ax)
    if not all(a.is_contiguous() for a in ops):
        raise ValueError('window_integrate: the CUDA kernel takes contiguous operands')
    sch, words, floats = _schedule(b)
    out = torch.empty((2, b.re.shape[0]), dtype=torch.float32, device=dev)
    kernels.launch_window_integrate(
        *ops, words, floats, out,
        K=len(sch['order']), n_fetch=sum(map(len, sch['fetches'])), n_slots=sch['n_slots'],
        wy=b.wy, wx=WX, tile=TILE, nx=b.nx,
        y_lo=b.ylo, y_inv=b.yinv, x_lo=b.xlo, x_inv=b.xinv,
        z_lo=b.zs0, z_hi=b.zs1, z_clip=b.z_clip)
    return out[0], out[1]


def integrate_rays_windowed(cube_wet, cube_hydro, ys, xs, zs,
                            low_yxz, high_yxz, d2, ray_len, re_local,
                            plan, ray_grid_shape,
                            z_clip: bool = True, *, device='cuda'):
    """Windowed-tile integration over a (ny_out, nx_out) pixel grid of rays.

    ``low_yxz``/``high_yxz`` (L, N, 3) are each segment's ends in the model
    CRS, ``d2`` and ``ray_len`` (L, N), ``re_local`` (N,), N = ny_out *
    nx_out pixels in row-major order; ``plan`` is a padded grouped plan
    (``delay.raytrace``). Arrays or tensors; the work runs on ``device``, the
    CUDA card unless the caller names another.

    Returns (wet, hydro, used). ``used`` False means an axis is non-uniform
    or a tile's window requirement exceeded the largest bucket (an
    incoherent ray batch): wet and hydro are None and the caller must
    integrate with the brick table (``delay.raytrace.integrate_rays``).
    """
    b = prepare_windowed(cube_wet, cube_hydro, ys, xs, zs, low_yxz, high_yxz, d2, ray_len,
                         re_local, plan, ray_grid_shape, z_clip, device=device)
    if b is None:
        return None, None, False
    wet, hyd = window_integrate(b)
    return wet.index_select(0, b.sel), hyd.index_select(0, b.sel), True
