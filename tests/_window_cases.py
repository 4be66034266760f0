"""A model of kernel B3's operand ring (``csrc/window_integrate.cu``): the
order in which it issues and waits for its copies, and their addresses;
and rays within ulps of cell boundaries. Shared by the CPU tests of its
design and the card tests of the kernel. Plain Python, numpy and torch, no
jax."""

import re
from collections import Counter

import numpy as np
import torch

from raider_tpu_torch import kernels
from raider_tpu_torch.delay import pallas_window as pw

SAMPLE_WORDS, SAMPLE_FLOATS = 8, 8
TILE = 512


def kernel_constants() -> dict:
    """kRays and kStages as the kernel's source sets them."""
    src = (kernels.CSRC / 'window_integrate.cu').read_text()
    get = lambda name: int(re.search(rf'constexpr int {name} = (\d+);', src).group(1))
    return dict(rays=get('kRays'), stages=get('kStages'))


def replay(sch: dict, depth: int) -> Counter:
    """Replay the kernel's copies and reads over a ring schedule; raise
    AssertionError where a read would find a row that is not in its slot or
    has not landed, or a copy would overwrite a row still to be read.
    Returns the copies of each row.

    The kernel: commit groups 0 .. depth - 1 in a prologue; then per sample
    i, a wait that leaves at most depth - 1 groups in flight, a warp
    barrier, commit group i + depth (its fetches), and the math of sample i.
    """
    K = len(sch['order'])
    readers = {}
    for k, keys in enumerate(sch['rows']):
        for key in keys:
            readers.setdefault(key, []).append(k)
    ring, landed_by = {}, {}          # slot -> row, slot -> commit that wrote it
    copies = Counter()
    groups = [g for g, _ in sch['order']]

    def commit(c: int, it: int) -> None:
        # issued at iteration `it`, after the barrier that ends it - 1
        if c < K:
            for arr, row, slot in sch['fetches'][c]:
                old = ring.get(slot)
                if old is not None:
                    assert all(k < it for k in readers[old]), \
                        f'commit {c} overwrites slot {slot} while {old} is still read'
                ring[slot], landed_by[slot] = (arr, row), c
                copies[(arr, row)] += 1

    for c in range(depth):
        commit(c, -1)
    for i in range(K):
        # of the depth + i commit groups issued, all but the last depth - 1
        # have landed
        complete = i
        for key, slot in zip(sch['rows'][i], sch['reads'][i]):
            assert ring.get(slot) == key, f'sample {i} reads {key} from slot {slot}'
            assert landed_by[slot] <= complete, f'sample {i} reads slot {slot} before it lands'
        assert sch['last'][i] == (i == K - 1 or groups[i] != groups[i + 1])
        commit(i + depth, i)
    return copies


def copy_addresses(sch: dict, n: int, rays: int, base: int = 0, block: int = 0) -> list:
    """(source, destination) byte offsets of every 16-byte ring copy of one
    block, each warp into its own ring ([warp][slot][32 rays]): sources from
    a ``base``-aligned operand, destinations from the shared memory's
    aligned base."""
    out = []
    for w in range(rays // 32):
        for fe in sch['fetches']:
            for _, row, slot in fe:
                for c in range(0, 32, 4):
                    out.append((base + 4 * (row * n + block * rays + 32 * w + c),
                                4 * ((w * sch['n_slots'] + slot) * 32 + c)))
    return out


class Plan:
    def __init__(self, **kw):
        self.__dict__.update(kw)


def boundary_points(rng) -> dict:
    """Points within a few ulps of cell boundaries, one per tile, on an axis
    whose step has a float32 reciprocal unlike float32(1/step). Group 0
    takes them at f = 0 (the lerp is exact), chosen where a true division
    and a multiply by the reciprocal pick different cells; group 1 lerps to
    them at f = 0.37 from ends where the fused and the separately rounded
    lerp pick different cells. Returns the y axis, its parameters, the (1,
    n, 3) segment ends, the two-group plan, the tile count and the points of
    group 0."""
    ny = 64
    step = next(float(s) for s in rng.uniform(0.005, 0.05, 4000)
                if np.float32(1.0 / s) != np.float32(1.0) / np.float32(s))
    ys = step * np.arange(ny)
    yparams = pw._uniform_params(ys)
    s32 = np.float32(yparams[2])
    rec32 = np.float32(1.0) / s32
    # float32 neighbours (up to 3 ulps) of the cell boundaries k * step
    k = rng.integers(1, ny - 2, 20000)
    cand = (k * s32).astype(np.float32)
    for _ in range(3):
        cand = np.where(rng.random(k.size) < 0.5, np.nextafter(cand, np.float32(np.inf)),
                        np.nextafter(cand, np.float32(0.0))).astype(np.float32)
    true_cell = np.floor(cand / s32)
    pick0 = cand[true_cell != np.floor(cand * rec32)][:32]
    # the last float32 below each boundary (as the multiply locates it),
    # then lerp ends whose exact lerp lies half an ulp above it
    below = (k * s32).astype(np.float32)
    for _ in range(6):
        below = np.where(np.floor(below * rec32) >= k, np.nextafter(below, np.float32(0.0)),
                         below).astype(np.float32)
        above = np.nextafter(below, np.float32(np.inf))
        below = np.where(np.floor(above * rec32) < k, above, below).astype(np.float32)
    f = np.float32(0.37)
    target = below.astype(np.float64) + 0.5 * (np.nextafter(below, np.float32(np.inf)) - below)
    lo_c = (below * rng.uniform(0.0, 0.5, k.size)).astype(np.float32)
    hi_c = (lo_c + (target - lo_c) / np.float64(f)).astype(np.float32)
    fused = (lo_c.astype(np.float64)
             + np.float64(f) * (hi_c - lo_c).astype(np.float64)).astype(np.float32)
    split = (lo_c + f * (hi_c - lo_c)).astype(np.float32)
    diff = np.floor(fused * rec32) != np.floor(split * rec32)
    lo1, hi1 = lo_c[diff][:32], hi_c[diff][:32]
    assert pick0.size >= 8 and lo1.size >= 8
    ly = np.concatenate([pick0, lo1]).repeat(TILE)
    hy = np.concatenate([pick0, hi1]).repeat(TILE)
    x = np.full(ly.size, -117.9, np.float32)
    low = np.stack([ly, x, np.zeros_like(x)], -1)[None]
    high = np.stack([hy, x, np.full_like(x, 100.0)], -1)[None]
    plan = Plan(lvl=np.zeros((2, 1), np.int32), frac=np.array([[0.0], [f]]),
                pad=np.zeros((2, 1), bool))
    return dict(ys=ys, yparams=yparams, s32=s32, low=low, high=high, plan=plan,
                n_tiles=pick0.size + lo1.size, pick0=pick0,
                xs=-118.0 + 0.01 * np.arange(140))


def phase4_plan(grid=(50, 400, 400), zen_max_deg: float = 40.0):
    """The padded plan of the window ablation's scene
    (``scripts/window_ablation.py``: the level chain, grid and widest zenith
    of its rays), with the z anchors shifted as ``prepare_windowed`` shifts
    them; no cubes or rays."""
    from raider_tpu_torch.delay.raytrace import _PLAN_BUCKET, _pad_group_plan, build_group_plan

    nz, ny, nx = grid
    zs = -500.0 + 26500.0 * np.linspace(0.0, 1.0, nz) ** 1.4
    ys, xs = np.linspace(16.0, 24.0, ny), np.linspace(-4.0, 4.0, nx)
    dzv, zen = np.diff(zs), np.deg2rad(zen_max_deg)
    p = _pad_group_plan(build_group_plan(dzv / np.cos(zen), zs, dzv * np.tan(zen) / 111000.0,
                                         ys, xs, zs), _PLAN_BUCKET)
    za = np.asarray(p.anchor, np.int64)
    za_s = np.minimum(za, max(nz - int(p.planes), 0))
    return Plan(lvl=np.asarray(p.lvl, np.int64), wa_lvl=np.asarray(p.wa_lvl, np.int64),
                wb_lvl=np.asarray(p.wb_lvl, np.int64), pad=np.asarray(p.pad, bool),
                frac=np.asarray(p.frac, np.float32), wa=np.asarray(p.wa, np.float32),
                wb=np.asarray(p.wb, np.float32), zlo=np.asarray(p.zlo, np.float32),
                zinv=np.asarray(p.zinv, np.float32), za=za_s,
                dzo=np.asarray(p.dzoff, np.int64) + (za - za_s)[:, None], L=nz - 1,
                planes=int(p.planes))


def boundary_batch(device='cpu'):
    """The :func:`boundary_points` rays through ``prepare_windowed`` on
    8 x (64 n_tiles) pixels, each tile's pixels on its point, over uniform
    cubes of 2 planes: (batch, the pre-pass's lowest and highest cells)."""
    bp = boundary_points(np.random.default_rng(11))
    n = bp['low'].shape[1]
    nyo, nxo = 8, 64 * bp['n_tiles']
    order = np.argsort(pw._tile_order(nyo, nxo, 'cpu')[0].numpy())
    low, high = bp['low'][:, order], bp['high'][:, order]
    plan = bp['plan']
    full = Plan(lvl=plan.lvl, frac=plan.frac, pad=plan.pad, planes=2, anchor=np.zeros(2, np.int64),
                dzoff=np.zeros((2, 1), np.int64), wa_lvl=np.zeros((2, 1), np.int64),
                wb_lvl=np.zeros((2, 1), np.int64), wa=np.full((2, 1), 0.5, np.float32),
                wb=np.full((2, 1), 0.5, np.float32), zlo=np.zeros((2, 1), np.float32),
                zinv=np.full((2, 1), 0.01, np.float32))
    ys, xs = bp['ys'], bp['xs']
    rng = np.random.default_rng(3)
    cube = lambda: torch.as_tensor(rng.uniform(1.0, 2.0, (2, ys.size, xs.size)),
                                   dtype=torch.float32, device=device)
    t = lambda a: torch.as_tensor(np.asarray(a, np.float32), device=device)
    return pw.prepare_windowed(cube(), cube(), ys, xs, np.array([0.0, 100.0]), t(low), t(high),
                               t(np.zeros((1, n))), t(np.ones((1, n))), t(np.full(n, 6371000.0)),
                               full, (nyo, nxo), device=device)
