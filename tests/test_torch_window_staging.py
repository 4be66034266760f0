"""Kernel B3's operand ring on the CPU, no jax, a few seconds: the ring's
schedule replayed in the kernel's order of copies, waits and reads (on the
window ablation's plan and on synthetic plans whose trapezoid levels are
not lvl - 1 and lvl), its packing into the kernel's schedule words, and the
16-byte alignment of every copy. The model is ``tests/_window_cases.py``;
the card tests hold the kernel to it."""

import numpy as np
import pytest

from raider_tpu_torch.delay import pallas_window as pw
from _window_cases import (SAMPLE_FLOATS, SAMPLE_WORDS, TILE, Plan, copy_addresses,
                           kernel_constants, phase4_plan, replay)

KC = kernel_constants()
DEPTHS = sorted({1, 3, 7, KC['stages'] - 1})


def _synthetic_plan(seed: int, L: int = 30, n_groups: int = 9, G: int = 7) -> Plan:
    """Levels and trapezoid levels drawn at random (repeats, levels read again
    groups later, wa/wb anywhere in the chain), random padding and one
    all-padding group."""
    rng = np.random.default_rng(seed)
    lvl = rng.integers(0, L, (n_groups, G))
    pad = rng.random((n_groups, G)) < 0.3
    pad[rng.integers(0, n_groups)] = True
    pad[0, 0] = False
    return Plan(lvl=lvl, wa_lvl=rng.integers(0, L, lvl.shape), wb_lvl=rng.integers(0, L, lvl.shape),
                pad=pad, L=L)


def _check_schedule(plan, depth: int) -> dict:
    sch = pw.ring_schedule(plan.lvl, plan.wa_lvl, plan.wb_lvl, plan.pad, plan.L, depth)
    copies = replay(sch, depth)
    read = {key for keys in sch['rows'] for key in keys}
    assert set(copies) == read and set(copies.values()) == {1}
    assert sum(map(len, sch['fetches'])) == len(read)
    assert len(sch['order']) == int((~plan.pad).sum())
    assert sch['n_slots'] <= 255            # a slot index is a byte of the schedule
    return sch


@pytest.mark.parametrize('depth', DEPTHS)
def test_ring_schedule_on_the_window_ablation_plan(depth):
    """Every operand row a sample reads is in its slot, and landed, when the
    sample reads it, and no copy overwrites a row still to be read; each row
    is copied once: 8 rows a level (7 at the level, its ray length) over
    the 49 levels, the top level's rows kept for its second sample."""
    plan = phase4_plan()
    sch = _check_schedule(plan, depth)
    L = plan.L
    assert L == 49 and len(sch['order']) == 50 and sum(map(len, sch['fetches'])) == 8 * L
    assert [len(f) for f in sch['fetches'][:3]] == [8, 8, 8]   # rl[0] shared by wa and wb
    # rows live: the samples in flight and the ray length the next one shares
    assert sch['n_slots'] <= 8 * (depth + 1) + 1


@pytest.mark.parametrize('depth', DEPTHS)
@pytest.mark.parametrize('seed', range(4))
def test_ring_schedule_with_other_trapezoid_levels(depth, seed):
    _check_schedule(_synthetic_plan(seed), depth)


def test_ring_replay_catches_a_bad_schedule():
    """The replay itself: a slot reused one iteration too early, or a read
    from the wrong slot, fails."""
    plan = phase4_plan()
    sch = pw.ring_schedule(plan.lvl, plan.wa_lvl, plan.wb_lvl, plan.pad, plan.L, 3)
    with pytest.raises(AssertionError):
        replay(sch, 4)           # the schedule was made for depth 3
    bad = dict(sch, reads=sch['reads'].copy())
    bad['reads'][10, 0] = bad['reads'][10, 1]
    with pytest.raises(AssertionError):
        replay(bad, 3)


def test_schedule_words_pack_the_schedule():
    """The kernel's words decode to the schedule: slots, end of group, group
    and level, plane, fetch list, trapezoid levels, the sample's values;
    then the fetches."""
    plan = phase4_plan()
    depth = KC['stages'] - 1
    sch = pw.ring_schedule(plan.lvl, plan.wa_lvl, plan.wb_lvl, plan.pad, plan.L, depth)
    words, floats = pw.schedule_arrays(plan, sch)
    K, n_fetch = len(sch['order']), sum(map(len, sch['fetches']))
    assert words.dtype == np.int32 and words.size == K * SAMPLE_WORDS + n_fetch
    assert floats.dtype == np.float32 and floats.size == K * SAMPLE_FLOATS
    w = words.astype(np.int64) & 0xffffffff
    s = w[:K * SAMPLE_WORDS].reshape(K, SAMPLE_WORDS)
    fe = w[K * SAMPLE_WORDS:]
    slots = np.stack([(s[:, 0] >> 8 * j) & 0xff for j in range(4)]
                     + [(s[:, 1] >> 8 * j) & 0xff for j in range(4)] + [s[:, 2] & 0xff], 1)
    np.testing.assert_array_equal(slots, sch['reads'])
    np.testing.assert_array_equal(s[:, 2] >> 16, sch['last'])
    assert (s[:, 2] >> 8 & 0xff == 0).all()
    assert (s[:, 6] == 0).all()
    for k, (g, sl) in enumerate(sch['order']):
        assert s[k, 3] == g | plan.lvl[g, sl] << 16
        assert s[k, 4] == plan.za[g] + plan.dzo[g, sl]
        assert s[k, 7] == plan.wa_lvl[g, sl] | plan.wb_lvl[g, sl] << 16
        start, count = s[k, 5] & 0xffff, s[k, 5] >> 16
        got = [(int(f >> 8) & 3, int(f >> 10), int(f & 0xff)) for f in fe[start:start + count]]
        assert got == sch['fetches'][k]
        np.testing.assert_array_equal(floats.reshape(K, SAMPLE_FLOATS)[k],
                                      [plan.frac[g, sl], plan.wa[g, sl], plan.wb[g, sl],
                                       plan.zlo[g, sl], plan.zinv[g, sl], 0, 0, 0])


@pytest.mark.parametrize('rays', [128, 256])
@pytest.mark.parametrize('n', [TILE, 3 * TILE, 1_024_000])
def test_ring_copies_are_16_byte_aligned(rays, n):
    """Every ring copy of every block reads and writes 16 aligned bytes: n is
    whole tiles, a block whole rays of one tile, a warp's slot its 32 rays."""
    plan = phase4_plan()
    sch = pw.ring_schedule(plan.lvl, plan.wa_lvl, plan.wb_lvl, plan.pad, plan.L,
                           KC['stages'] - 1)
    for block in sorted({0, 1, n // rays - 1}):
        addrs = np.array(copy_addresses(sch, n, rays, base=256, block=block))
        assert (addrs % 16 == 0).all()
        assert addrs[:, 1].max() + 16 <= sch['n_slots'] * rays * 4
