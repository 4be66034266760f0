"""Kernel K3 (the merged-row group integrate) on the CPU: its wrapper's twin
against the kernel profile's ``prod`` reference at ragged ray counts, and a
model of the kernel's launch shape and copies. No jax, a few seconds."""

from collections import Counter

import pytest
import torch

from raider_tpu_torch.scripts import kernel_profile as kp
from _group_cases import (RAYS, SMEM_BLOCK_MAX, brick_copies, launch_shape, profile_groups,
                          slab_copies, slab_pitch, smem_bytes)

SPECS = [(7, 3, 3, 6), (8, 4, 4, 24)]


@pytest.mark.parametrize('spec', SPECS)
@pytest.mark.parametrize('n_rays', [37, 4097])
@pytest.mark.parametrize('bad_rays', [False, True])
def test_merged_wrapper_on_cpu_matches_prod(spec, n_rays, bad_rays):
    """The ``prodmerged`` variant through ``brick_group_merged`` on CPU
    tensors (its twin) against ``static_brick_ref`` at the kernel profile's
    tolerance, with equal NaN masks, for ray counts that are multiples of
    neither a block nor 4 (4097) or below one block (37)."""
    sc = kp.build_scene('cpu', n_rays=n_rays, grid=(12, 40, 40), seed=5)
    if bad_rays:
        sc['rays'][0][:, :3] = float('nan')
        sc['rays'][1][:, 7] += 30.0
        sc['rays'][4][:, 11] = float('nan')
    st = kp.spec_setup(sc, spec)
    ys, xs, zs = sc['ys'], sc['xs'], sc['zs']
    fn = kp.make_merged_fn(st['groups'], st['planes'], st['wy'], st['wx'], ys, xs, zs)
    got = fn(st['table'], *sc['rays'])
    want = kp.static_brick_ref(st['table'], *sc['rays'], st['groups'], st['planes'], st['wy'],
                               st['wx'], ys, xs, zs)
    for a, b in zip(got, want):
        assert a.shape == (n_rays,)
        nan = torch.isnan(b)
        assert torch.equal(torch.isnan(a), nan)
        assert float(((a[~nan] - b[~nan]).abs() / b[~nan].abs()).max()) < kp.TOL_REL
        assert bool(nan[:3].all()) == bad_rays and not bool(nan[20:30].any())


@pytest.mark.parametrize('spec, shape', [((7, 3, 3, 6), (32, 26_192)),
                                         ((8, 4, 4, 24), (32, 48_304))])
def test_merged_launch_shape_model(spec, shape):
    """The launcher's shape at the kernel profile's specs for the group with
    the most merged rows (and samples): 32 rays a block and its shared
    bytes. The card test holds ``kernels.brick_group_merged_shape`` to this
    model on every group."""
    planes, wy, wx, _ = spec
    width = planes * wy * wx * 2
    largest = max(profile_groups(spec), key=lambda g: (3 * g[1] + 2 * g[2], g[0]))
    assert launch_shape(largest[0], width, *largest[1:]) == shape
    # the slab's bound on its pitch holds for every ray count
    assert all(slab_pitch(RAYS, n) <= RAYS + 6 for n in range(1, 9))
    assert smem_bytes(64, 126, 6, 41) == 4 * (64 * 126 + 2872 + 60 + 4 * 64 * 7)


@pytest.mark.parametrize('spec', kp.SPECS)
def test_merged_block_fits_every_profile_spec(spec):
    """Every group of every spec of the kernel profile's sweep fits one
    32-ray block in at most a quarter of a block's shared memory, so at
    least four blocks stay resident an SM."""
    planes, wy, wx, _ = spec
    width = planes * wy * wx * 2
    for S, nb, nl in profile_groups(spec):
        threads, smem = launch_shape(S, width, nb, nl)
        assert threads == RAYS and smem <= SMEM_BLOCK_MAX // 4


@pytest.mark.parametrize('planes, kept', [(7, 2), (7, 4), (7, 6), (7, 7), (5, 3)])
@pytest.mark.parametrize('nr', [32, 17, 1])
def test_brick_copies_keep_the_planes_read(planes, kept, nr):
    """stage_rows' 16-byte copies of a block's brick span at a 3x3 window
    (a tile at pitch == width) keeping the first ``kept`` planes of each
    row: every float of those planes copied exactly once, every copy inside
    the span and aligned to its size, and no 16-byte copy wholly past the
    kept planes of its row (only units straddling two rows bring more)."""
    cols, keep = planes * 18, kept * 18
    seen = Counter()
    for off, size in brick_copies(nr, cols, keep):
        assert off % size == 0 and off + size <= nr * cols
        if size == 4:
            assert off % cols < keep or off // cols != (off + 3) // cols
        seen.update(range(off, off + size))
    assert set(seen.values()) == {1}
    assert {r * cols + c for r in range(nr) for c in range(keep)} <= set(seen)
    if kept == planes:
        assert set(seen) == set(range(nr * cols))


@pytest.mark.parametrize('head', [0, 1, 2, 3])
@pytest.mark.parametrize('n', [1_000_000, 1_202_201, 4097, 4098])
@pytest.mark.parametrize('nr', [64, 37, 1])
def test_slab_copies_cover_each_row_once_aligned(head, n, nr):
    """stage_slab's copies for a block of 64 rays: every float of each of the
    M row spans copied exactly once to row m's place at the slab pitch;
    16-byte copies 16-byte aligned at both ends; nothing past the slab."""
    R, M = 64, 41
    copies = slab_copies(head, n, M, nr, R)
    pitch = slab_pitch(R, n)
    seen = {}
    for dst, src, size in copies:
        if size == 4:
            assert dst % 4 == 0 and src % 4 == 0
        for j in range(size):
            m, col = divmod(src + j - head, n)
            assert 0 <= col < nr and dst + j == head + m * pitch + col
            seen[m, col] = seen.get((m, col), 0) + 1
    assert sorted(seen) == [(m, c) for m in range(M) for c in range(nr)]
    assert set(seen.values()) == {1}
    assert max(d + s for d, _, s in copies) <= M * (R + 6)
    if nr == R:
        assert sum(1 for c in copies if c[2] == 4) >= M * (nr // 4 - 1)
