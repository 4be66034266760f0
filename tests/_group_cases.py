"""A model of kernel K3's launcher and copies (``csrc/brick_group.cu``,
``csrc/stage.cuh``, ``kernel_profile.brick_group_merged``), shared by the
CPU tests of its design and the card tests of the kernel, and the profile
plan's groups at full size. Plain Python and numpy, no jax."""

import numpy as np

from raider_tpu_torch.delay.raytrace import build_group_plan, static_plan_from
from raider_tpu_torch.scripts import kernel_profile

RAYS = 32                      # kRays
PLAN_WORDS = 4 + 6             # kPlanI + kPlanF
SMEM_BLOCK_MAX = 232_448


def brick_pitch(width: int) -> int:
    return width if (width // 2) % 2 == 1 else width + 2


def _up4(v: int) -> int:
    return -(-v // 4) * 4


def smem_bytes(R: int, width: int, S: int, M: int) -> int:
    """A block's shared bytes: the brick tile, the slab at a pitch of at most
    R + 6, the plan and each ray's (gy, gx, a0, a1) for its samples at an
    odd pitch of float4s; the last three each rounded up to 16 bytes."""
    return 4 * (R * brick_pitch(width) + _up4(M * (R + 6)) + _up4(S * PLAN_WORDS)
                + 4 * R * (S | 1))


def launch_shape(S: int, width: int, nb: int, nl: int) -> tuple:
    """(threads, shared bytes) of a block; None where it does not fit."""
    b = smem_bytes(RAYS, width, S, 3 * nb + 2 * nl + 3)
    return (RAYS, b) if b <= SMEM_BLOCK_MAX else None


def brick_copies(nr: int, cols: int, keep: int, threads: int = RAYS) -> list:
    """stage_rows' 16-byte copies of ``nr`` rows of ``cols`` floats into a
    tile at pitch ``cols``, keeping the first ``keep`` floats of each row:
    (offset, floats) in the order each thread issues them, thread by
    thread."""
    total = nr * cols
    head = total - total % 4
    carry = threads * 4 % cols
    out = []
    for tid in range(threads):
        col = tid * 4 % cols
        for i in range(tid * 4, head, threads * 4):
            if col < keep or col + 4 > cols:
                out.append((i, 4))
            col += carry
            if col >= cols:
                col -= cols
        out += [(i, 1) for i in range(head + tid, total, threads)]
    return out


def slab_pitch(R: int, n: int) -> int:
    """The least pitch >= R + 3 congruent to n modulo 4."""
    return R + 3 + (n - R - 3) % 4


def slab_copies(head: int, n: int, M: int, nr: int, R: int) -> list:
    """stage_slab's copies for a block whose merged rows start ``head``
    floats past a 16-byte boundary: (dst, src, floats) with dst counted in
    floats from the slab's 16-byte aligned base and src in floats from a
    16-byte boundary of global memory (row m of the block's span at
    head + m n)."""
    pitch = slab_pitch(R, n)
    chunks = (nr + 6) // 4
    out = []
    for i in range(M * chunks):
        m, c = divmod(i, chunks)
        j0 = 4 * c - (head + m * pitch) % 4
        d0, s0 = head + m * pitch, head + m * n
        if j0 >= 0 and j0 + 4 <= nr:
            out.append((d0 + j0, s0 + j0, 4))
        else:
            out += [(d0 + j, s0 + j, 1) for j in range(max(j0, 0), min(j0 + 4, nr))]
    return out


def profile_groups(spec) -> list:
    """(S, nb, nl) of each group of ``spec``'s plan over the kernel profile's
    full-size geometry (its level chain and grid at 45 degrees zenith)."""
    nz, ny, nx = kernel_profile.GRID
    zs = -500.0 + 26500.0 * np.linspace(0.0, 1.0, nz) ** 1.4
    ys, xs = np.linspace(30.0, 40.0, ny), np.linspace(-125.0, -115.0, nx)
    dzv = np.diff(zs)
    planes, wy, wx, gmax = spec
    plan = build_group_plan((dzv * np.sqrt(2.0)).astype(np.float32), zs, dzv / 111000.0, ys, xs,
                            zs, group_max=gmax, planes=planes, wy=wy, wx=wx)
    out = []
    for _, samples in static_plan_from(plan)[0]:
        lv0, hi1, hiL = kernel_profile._row_window(samples, dzv.size)
        out.append((len(samples), hi1 + 1 - lv0, hiL + 1 - lv0))
    return out
