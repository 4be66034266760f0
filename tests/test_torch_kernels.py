"""The CUDA kernels of raider_tpu_torch against their plain-torch twins.

Tests marked ``cuda`` need an NVIDIA GPU and skip elsewhere. This file
imports neither jax nor raider_tpu, so it also runs on a machine with the
card and without jax:

    python -m pytest tests/test_torch_kernels.py --noconftest -p no:cacheprovider -q

The kernels use round-to-nearest arithmetic in their twins' order of
operations, so on NaN-free inputs they must agree with the twins exactly;
the stated tolerances (B2, B3, K2, K4 1e-5 relative; B1, K1, K3, S4 and S5 exact)
are the contract the smoke run holds them to.
"""

import os

import numpy as np
import pytest
import torch

from raider_tpu_torch import kernels
from raider_tpu_torch.delay import pallas_window as pw
from raider_tpu_torch.delay.pallas_window import (integrate_rays_windowed, prepare_windowed,
                                                  window_integrate, window_integrate_ref)
from raider_tpu_torch.delay import raytrace
from raider_tpu_torch.delay.raytrace import (build_group_plan, integrate_bricks,
                                             integrate_bricks_ref, pack_cubes)
from raider_tpu_torch.ops.ztd import ztd_totals, ztd_totals_ref
from raider_tpu_torch.scripts import (brick_ablation, contract_ablation, group_ablation,
                                      kernel_profile, probe_f16, window_ablation,
                                      window_kernel_ablation, ztd_layouts)
from _contract_cases import CASES, SPEC as K1_SPEC, contract_case
from _group_cases import launch_shape as merged_launch_shape, profile_groups
from _window_cases import boundary_batch, kernel_constants as window_kernel_constants

K1, K2, K3 = 0.776, 0.233, 3.75e3


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip('needs an NVIDIA GPU with CUDA (the kernels have no CPU build)')
    return torch.device('cuda')


def _ztd_inputs(shape, device='cpu', seed=3):
    rng = np.random.default_rng(seed)
    arrs = (rng.uniform(220, 300, shape), rng.uniform(1e3, 1e5, shape),
            rng.uniform(1, 1000, shape))
    zs = np.sort(rng.uniform(-500, 25000, shape[0]))
    return [torch.as_tensor(a.astype(np.float32), device=device) for a in arrs] + [
        torch.as_tensor(zs, device=device)]


def contiguous_rays(zs, n_rays, rng, ys, xs, zenith_deg=(20, 40), device='cpu'):
    """Contiguous slant segments through the level chain ``zs``, starting in
    the middle fifth of the grid so that they stay inside it."""
    L = zs.size - 1
    zen = np.deg2rad(rng.uniform(*zenith_deg, n_rays))
    azi = rng.uniform(0, 2 * np.pi, n_rays)
    dh = np.diff(zs)[:, None] * np.tan(zen)[None, :]
    deg_per_m = 1.0 / 111000.0
    y0 = rng.uniform(*np.quantile(ys, [0.4, 0.6]), n_rays)
    x0 = rng.uniform(*np.quantile(xs, [0.4, 0.6]), n_rays)
    bnd_y = y0 + np.vstack([np.zeros((1, n_rays)), np.cumsum(dh * np.cos(azi) * deg_per_m, 0)])
    bnd_x = x0 + np.vstack([np.zeros((1, n_rays)), np.cumsum(dh * np.sin(azi) * deg_per_m, 0)])
    bnd_z = np.broadcast_to(zs[:, None], (L + 1, n_rays))
    ray_len = np.diff(zs)[:, None] / np.cos(zen)[None, :]
    d2 = dh ** 2
    re = np.full(n_rays, 6371000.0)
    hstep = np.nanmax(np.hypot(np.diff(bnd_y, axis=0), np.diff(bnd_x, axis=0)), axis=1)
    rays = [torch.as_tensor(np.ascontiguousarray(a), dtype=torch.float32, device=device)
            for a in (bnd_y, bnd_x, bnd_z, d2, ray_len, re)]
    return rays, np.nanmax(ray_len, axis=1), hstep * (1 + 1e-5) + 1e-7


def _brick_case(device, uniform=True, seed=0, n_rays=3000, mutate=None, mode='brick', spec=None):
    rng = np.random.default_rng(seed)
    zs = -500.0 + 27000.0 * np.linspace(0.0, 1.0, 18) ** 1.6
    ys = np.linspace(33.0, 34.0, 11)
    xs = np.linspace(-118.0, -117.0, 12)
    if not uniform:
        ys = np.sort(np.concatenate([[33.0, 34.0], rng.uniform(33.05, 33.95, 9)]))
    wet = torch.as_tensor(rng.uniform(0.5, 2.0, (zs.size, ys.size, xs.size)),
                          dtype=torch.float32, device=device)
    hyd = torch.as_tensor(rng.uniform(1.0, 4.0, (zs.size, ys.size, xs.size)),
                          dtype=torch.float32, device=device)
    rays, plm, hstep = contiguous_rays(zs, n_rays, rng, ys, xs, device=device)
    if mutate is not None:
        mutate(rays)
    if spec is None:
        table, _ = pack_cubes(wet, hyd, mode=mode)
        plan = build_group_plan(plm, zs, hstep, ys, xs, zs)
    else:
        planes, wy, wx, gmax = spec
        qw, qh, deq = raytrace._quantized_pair(wet, hyd)
        table = raytrace._pack_bricks(*((qw, qh) if mode == 'brick_i16' else (wet, hyd)),
                                      planes, wy, wx)
        table = (table, deq) if mode == 'brick_i16' else table
        plan = build_group_plan(plm, zs, hstep, ys, xs, zs, group_max=gmax, planes=planes,
                                wy=wy, wx=wx)
    return table, rays, plan, ys, xs, zs


def _mutate_fast_rays(rays):
    # a tenth of the rays move 3x faster than the motion bound the plan is
    # built with: their upper groups overflow the brick window
    bnd_y, bnd_x = rays[0], rays[1]
    k = bnd_y.shape[1] // 10
    for b in (bnd_y, bnd_x):
        b[:, :k] = b[0, :k] + 3.0 * (b[:, :k] - b[0, :k])


def _mutate_bad_rays(rays):
    bnd_y, bnd_x, _, _, ray_len, _ = rays
    bnd_y[:, 7] = float('nan')
    bnd_x[:, 11] += 30.0
    ray_len[:, 13] = float('nan')


def test_library_name_tracks_the_sources():
    p = kernels.library_path()
    assert p == kernels.library_path()
    assert p.parent == kernels.BUILD_DIR and p.name.startswith('libraider_kernels_')
    assert {s.name for s in kernels._sources()} >= {'ztd_totals.cu', 'brick_integrate.cu',
                                                     'window_integrate.cu', 'probe_f16.cu',
                                                     'brick_contract.cu', 'brick_group.cu'}


_FAKE_NVCC = """#!/bin/sh
# stands in for nvcc: writes the -o file; fails on probe_f16.cu if asked to
out=""
while [ $# -gt 0 ]; do
  case "$1" in
    -o) out="$2"; shift ;;
    *probe_f16.cu) if [ -n "$FAIL_ON_PROBE" ]; then echo "probe_f16.cu: error" >&2; exit 2; fi ;;
  esac
  shift
done
echo built > "$out"
"""


@pytest.mark.parametrize('fail', [False, True])
def test_build_compiles_each_source_then_links(tmp_path, monkeypatch, fail):
    """One nvcc per source, then a link; a failed source raises with its
    message and leaves no object or partial library behind."""
    fake = tmp_path / 'bin' / 'nvcc'
    fake.parent.mkdir()
    fake.write_text(_FAKE_NVCC)
    fake.chmod(0o755)
    monkeypatch.setenv('PATH', f'{fake.parent}{os.pathsep}{os.environ["PATH"]}')
    monkeypatch.setattr(kernels, 'BUILD_DIR', tmp_path / 'build')
    if fail:
        monkeypatch.setenv('FAIL_ON_PROBE', '1')
        with pytest.raises(RuntimeError, match='probe_f16.cu: error'):
            kernels.build()
        assert list((tmp_path / 'build').iterdir()) == []
    else:
        out = kernels.build()
        assert out == kernels.library_path() and out.read_text() == 'built\n'
        assert [p.name for p in (tmp_path / 'build').iterdir()] == [out.name]


def test_reset_launch_counts():
    kernels.LAUNCHES['ztd_totals'] += 3
    kernels.LAUNCHES['window_integrate'] += 2
    kernels.reset_launch_counts()
    assert kernels.LAUNCHES == {'ztd_totals': 0, 'brick_integrate': 0, 'brick_integrate_i16': 0,
                                'window_integrate': 0, 'probe_load': 0,
                                'probe_bitcast_i16_bf16': 0, 'brick_contract': 0,
                                'brick_group_rows': 0, 'brick_group_merged': 0}


@pytest.mark.parametrize('case', ['plain', 'bad_rays', 'window'])
def test_cpu_wrapper_runs_the_twin(case):
    kw = dict(plain={}, bad_rays=dict(mutate=_mutate_bad_rays),
              window=dict(mutate=_mutate_fast_rays))[case]
    table, rays, plan, ys, xs, zs = _brick_case('cpu', n_rays=400, **kw)
    before = dict(kernels.LAUNCHES)
    w, h = integrate_bricks(table, *rays, plan, ys, xs, zs)
    rw, rh = integrate_bricks_ref(table, *rays, plan, ys, xs, zs)
    torch.testing.assert_close(w, rw, rtol=0, atol=0, equal_nan=True)
    torch.testing.assert_close(h, rh, rtol=0, atol=0, equal_nan=True)
    assert kernels.LAUNCHES == before
    if case == 'plain':
        assert torch.isfinite(w).all()
    else:
        assert torch.isnan(w).any() and not torch.isnan(w).all()


@pytest.mark.parametrize('bad', ['table_width', 'ray_dtype', 're_len'])
def test_brick_wrapper_rejects_bad_inputs(bad):
    table, rays, plan, ys, xs, zs = _brick_case('cpu', n_rays=50)
    rays = list(rays)
    if bad == 'table_width':
        table = table[:, :-2]
    elif bad == 'ray_dtype':
        rays[0] = rays[0].double()
    else:
        rays[5] = rays[5][:-1]
    with pytest.raises(ValueError):
        integrate_bricks(table, *rays, plan, ys, xs, zs)


def _in_layout(a, layout):
    """An (nz, ny, nx) cube as contiguous (z, y, x) rows, or as the (z, y, x)
    view of a contiguous (y, x, z) copy (the weather model's columns)."""
    return a if layout == 'rows' else torch.movedim(torch.movedim(a, 0, -1).contiguous(), -1, 0)


def test_ztd_layouts_script_on_cpu():
    """The B1 measurement script's records on the CPU (the twin, no times),
    the trimmed model's included."""
    recs = ztd_layouts.run('cpu', [(6, 30, 40)], say=lambda s: None)
    assert [r.get('layout') for r in recs] == ['rows', 'columns', None, None]
    assert all(r['equal'] and r['max_abs_err'] == 0.0 and 'ms' not in r for r in recs[:2])
    assert recs[2]['stage'] == '_get_ztd' and recs[2]['shape'] == [30, 40, 6]
    assert recs[3]['stage'] == '_trimExtent + _get_ztd'
    ny, nx, nz = recs[3]['shape']
    assert 22 <= ny < 30 and 30 <= nx < 40 and nz == 6


@pytest.mark.cuda
@pytest.mark.parametrize('layout', ['rows', 'columns'])
@pytest.mark.parametrize('shape', [(51, 40, 130), (137, 9, 31), (8, 8, 128), (16, 1, 1),
                                   (5, 3, 7), (2, 1, 1), (51, 59, 99), (64, 3, 65), (65, 2, 3)])
def test_ztd_kernel_matches_twin(cuda, shape, layout):
    """Bit-identical to the twin on both layouts, including a column count
    that is odd and not a multiple of a block's columns, and level counts
    of one chunk (64) and of two, three chunks (65, 137)."""
    t, p, e, zs = _ztd_inputs(shape, device=cuda)
    t, p, e = (_in_layout(a, layout) for a in (t, p, e))
    before = kernels.LAUNCHES['ztd_totals']
    w, h = ztd_totals(t, p, e, zs, K1, K2, K3)
    torch.cuda.synchronize()
    assert kernels.LAUNCHES['ztd_totals'] == before + 1
    assert w.is_contiguous() and h.is_contiguous() and w.shape == shape
    rw, rh = ztd_totals_ref(t, p, e, zs, K1, K2, K3)
    assert torch.isfinite(rw).all() and torch.equal(w, rw) and torch.equal(h, rh)


@pytest.mark.cuda
@pytest.mark.parametrize('layout', ['rows', 'columns'])
def test_ztd_kernel_poisons_one_column(cuda, layout):
    """A NaN and an inf in one column poison that column as in the twin, and
    no other."""
    nz, ny, nx = 37, 5, 43
    t, p, e, zs = _ztd_inputs((nz, ny, nx), device=cuda)
    t[20, 3, 17] = float('nan')
    p[30, 3, 17] = float('inf')
    t, p, e = (_in_layout(a, layout) for a in (t, p, e))
    w, h = ztd_totals(t, p, e, zs, K1, K2, K3)
    rw, rh = ztd_totals_ref(t, p, e, zs, K1, K2, K3)
    torch.cuda.synchronize()
    for a, b in ((w, rw), (h, rh)):
        torch.testing.assert_close(a, b, rtol=0, atol=0, equal_nan=True)
        bad = ~torch.isfinite(a)
        assert bad[:, 3, 17].any()
        bad[:, 3, 17] = False
        assert not bad.any()
    assert torch.isnan(w[:20, 3, 17]).all() and torch.isinf(h[21:30, 3, 17]).all()


@pytest.mark.cuda
def test_ztd_kernel_rejects_non_contiguous(cuda):
    t, p, e, zs = _ztd_inputs((4, 6, 8), device=cuda)
    before = kernels.LAUNCHES['ztd_totals']
    with pytest.raises(ValueError):
        ztd_totals(t.transpose(1, 2), p.transpose(1, 2), e.transpose(1, 2), zs, K1, K2, K3)
    cols = [_in_layout(a, 'columns') for a in (t, p, e)]
    with pytest.raises(ValueError):
        ztd_totals(*(a[:, 1:5, 2:7] for a in cols), zs, K1, K2, K3)
    assert kernels.LAUNCHES['ztd_totals'] == before


@pytest.mark.cuda
def test_ztd_kernel_refuses_too_many_levels(cuda):
    """A level count whose chunk buffers and steps exceed a block's shared
    memory: the launcher refuses it, the wrapper raises, nothing counts."""
    t, p, e, zs = _ztd_inputs((60_000, 1, 2), device=cuda)
    before = kernels.LAUNCHES['ztd_totals']
    with pytest.raises(RuntimeError, match='ztd_totals'):
        ztd_totals(t, p, e, zs, K1, K2, K3)
    assert kernels.LAUNCHES['ztd_totals'] == before


@pytest.mark.cuda
@pytest.mark.parametrize('case', ['uniform', 'non_uniform', 'bad_rays', 'window'])
def test_brick_kernel_matches_twin(cuda, case):
    kw = dict(uniform={}, non_uniform=dict(uniform=False),
              bad_rays=dict(mutate=_mutate_bad_rays), window=dict(mutate=_mutate_fast_rays))[case]
    table, rays, plan, ys, xs, zs = _brick_case(cuda, **kw)
    before = kernels.LAUNCHES['brick_integrate']
    w, h = integrate_bricks(table, *rays, plan, ys, xs, zs)
    torch.cuda.synchronize()
    assert kernels.LAUNCHES['brick_integrate'] == before + 1
    rw, rh = integrate_bricks_ref(table, *rays, plan, ys, xs, zs)
    for a, b in ((w, rw), (h, rh)):
        assert torch.equal(torch.isnan(a), torch.isnan(b))
        ok = ~torch.isnan(b)
        assert float(((a[ok] - b[ok]).abs() / b[ok].abs()).max()) <= 1e-5
    if case in ('bad_rays', 'window'):
        assert torch.isnan(w).any() and not torch.isnan(w).all()
    else:
        assert torch.isfinite(w).all()


@pytest.mark.cuda
def test_brick_kernel_rejects_float64(cuda):
    table, rays, plan, ys, xs, zs = _brick_case(cuda, n_rays=64)
    with pytest.raises(ValueError):
        integrate_bricks(table.double(), *[r.double() for r in rays], plan, ys, xs, zs)


@pytest.mark.cuda
@pytest.mark.parametrize('spec', [(17, 3, 3, 6), (7, 12, 12, 6)])
def test_brick_kernel_rejects_what_it_cannot_stage(cuda, spec):
    """More planes than the ring's slot map holds, or a window whose rings
    do not fit a block's shared memory: the wrapper raises, nothing runs."""
    table, rays, plan, ys, xs, zs = _brick_case(cuda, n_rays=64, spec=spec)
    before = dict(kernels.LAUNCHES)
    with pytest.raises(ValueError):
        integrate_bricks(table, *rays, plan, ys, xs, zs)
    assert kernels.LAUNCHES == before


def _rel(a, b) -> float:
    ok = ~torch.isnan(b)
    return float(((a[ok] - b[ok]).abs() / b[ok].abs()).max())


def _window_scene(device, bad_rays=False):
    """The window ablation's scene, cut to 96 x 96 rays on a 20x60x60 cube."""
    sc = window_ablation.build_scene(96, grid=(20, 60, 60), device=device, seed=5)
    if bad_rays:
        for k in ('low', 'high'):
            sc[k][:, :7, 0] = float('nan')    # NaN rays
            sc[k][:, 40, 1] += 5.0            # a ray out of the grid
    return sc


@pytest.mark.cuda
@pytest.mark.parametrize('case', ['coherent', 'bad_rays'])
def test_window_kernel_matches_twin(cuda, case):
    sc = _window_scene(cuda, bad_rays=case == 'bad_rays')
    b = prepare_windowed(*window_ablation.windowed_args(sc), device=cuda)
    before = kernels.LAUNCHES['window_integrate']
    w, h = window_integrate(b)
    torch.cuda.synchronize()
    assert kernels.LAUNCHES['window_integrate'] == before + 1
    rw, rh = window_integrate_ref(b)
    for a, r in ((w, rw), (h, rh)):
        _bitwise(a, r)
    assert torch.isnan(w).any() == (case == 'bad_rays')


@pytest.mark.cuda
def test_window_entry_point_defaults_to_the_card(cuda):
    sc = _window_scene(cuda)
    before = kernels.LAUNCHES['window_integrate']
    w, h, used = integrate_rays_windowed(*window_ablation.windowed_args(sc))
    assert used and w.device.type == 'cuda' and torch.isfinite(w).all()
    assert kernels.LAUNCHES['window_integrate'] == before + 1
    table, mode = pack_cubes(sc['wet'], sc['hydro'], grouped=True)
    bw, bh = window_ablation.brick(sc, table, mode)
    assert window_ablation.max_rel(w, bw) < 1e-5 and window_ablation.max_rel(h, bh) < 1e-5


def _window_case(device, case: str):
    """A batch of kernel B3 for ``case``: a cube width that is no multiple
    of 128, the z clip off, a plan with all-padding groups, a tile spread
    admitted at WY = 40, the phase-4 cube's width, the rays within ulps of
    cell boundaries."""
    if case == 'boundary':
        return boundary_batch(device)
    kw = dict(nx_ragged=dict(side=96, grid=(20, 60, 150)),
              no_z_clip=dict(side=96, grid=(20, 60, 60)),
              all_padding=dict(side=96, grid=(50, 60, 60)),
              wy40=dict(side=0, grid=(20, 200, 300), pixels=(16, 64), y_span=(18.5, 20.75)),
              cube400=dict(side=96, grid=(20, 400, 400)))[case]
    sc = window_ablation.build_scene(device=device, seed=5, **kw)
    return prepare_windowed(*window_ablation.windowed_args(sc), z_clip=case != 'no_z_clip',
                            device=device)


@pytest.mark.cuda
@pytest.mark.parametrize('case', ['nx_ragged', 'no_z_clip', 'all_padding', 'wy40', 'cube400',
                                  'boundary'])
def test_window_kernel_edge_cases(cuda, case):
    """B3 bit for bit against its twin, equal NaN masks, at the launch shape
    its launcher derives: the source's rays a block and stage count."""
    b = _window_case(cuda, case)
    assert b is not None
    kc = window_kernel_constants()
    shape = pw.window_launch_shape(b)
    assert (shape['threads'], shape['stages']) == (kc['rays'], kc['stages'])
    assert 0 < shape['smem_bytes'] <= 232_448
    if case == 'all_padding':
        assert b.pad.all(1).any()
    if case == 'wy40':
        assert b.wy == 40
    before = kernels.LAUNCHES['window_integrate']
    w, h = window_integrate(b)
    torch.cuda.synchronize()
    assert kernels.LAUNCHES['window_integrate'] == before + 1
    rw, rh = window_integrate_ref(b)
    _bitwise(w, rw)
    _bitwise(h, rh)
    assert bool(torch.isfinite(w).any()) and b.z_clip == (case != 'no_z_clip')


@pytest.mark.cuda
def test_window_launch_shape_refuses_what_does_not_fit(cuda):
    """B3's shared memory is the warps' rings, the schedule (16 words a
    sample, the fetches) and the tile's anchors; the launcher refuses more
    ring slots than a byte indexes or a block's shared memory holds, an
    empty ring or schedule, and more fetches or groups than the schedule's
    16-bit fields hold."""
    rays = window_kernel_constants()['rays']
    assert kernels.window_integrate_shape(33, 50, 392, 12) == \
        (rays, 4 * (33 * rays + 50 * 16 + 392 + 24))
    for args in ((256, 50, 392, 12), (255, 2000, 392, 12), (0, 50, 392, 12), (33, 0, 392, 12),
                 (33, 50, 1 << 16, 12), (33, 50, 392, 1 << 16)):
        with pytest.raises(ValueError):
            kernels.window_integrate_shape(*args)


@pytest.mark.cuda
@pytest.mark.parametrize('case', ['misaligned', 'huge_ring'])
def test_window_kernel_refuses_what_it_cannot_fit(cuda, case):
    """An operand that is not 16-byte aligned, or a plan whose ring does not
    fit a block (60 levels sampled twice over: every row stays resident from
    its first reader to its second, 480 slots), raises and launches
    nothing."""
    if case == 'misaligned':
        b = _window_case(cuda, 'nx_ragged')
        buf = torch.empty(b.lo.numel() + 1, dtype=torch.float32, device=cuda)
        lo = buf[1:].view(b.lo.shape)
        lo.copy_(b.lo)
        b.lo = lo
    else:
        sc = window_ablation.build_scene(32, grid=(61, 60, 60), device=cuda, seed=5)
        b = prepare_windowed(*window_ablation.windowed_args(sc), device=cuda)
        for k in ('lvl', 'frac', 'wa_lvl', 'wa', 'wb_lvl', 'wb', 'zlo', 'zinv', 'pad', 'dzo'):
            setattr(b, k, np.tile(getattr(b, k), (2, 1)))
        b.za = np.tile(b.za, 2)
        b.ay, b.ax = (a.repeat(1, 2).contiguous() for a in (b.ay, b.ax))
        with pytest.raises(ValueError):
            pw.window_launch_shape(b)
    before = kernels.LAUNCHES['window_integrate']
    with pytest.raises(RuntimeError):
        window_integrate(b)
    torch.cuda.synchronize()
    assert kernels.LAUNCHES['window_integrate'] == before


@pytest.mark.cuda
@pytest.mark.parametrize('dtype', list(kernels.PROBE_DTYPES))
def test_probe_load_kernel_matches_twin(cuda, dtype):
    x = probe_f16.make_block(kernels.PROBE_DTYPES[dtype], n=4096 + 37, device=cuda)
    before = kernels.LAUNCHES['probe_load']
    got = probe_f16.probe_load(x)
    torch.cuda.synchronize()
    assert kernels.LAUNCHES['probe_load'] == before + 1
    assert torch.equal(got, probe_f16.probe_load_ref(x))


@pytest.mark.cuda
def test_probe_bitcast_kernel_matches_twin(cuda):
    x = probe_f16.make_block(torch.bfloat16, n=4096 + 37, device=cuda).view(torch.int16)
    before = kernels.LAUNCHES['probe_bitcast_i16_bf16']
    got = probe_f16.probe_bitcast_i16_bf16(x)
    torch.cuda.synchronize()
    assert kernels.LAUNCHES['probe_bitcast_i16_bf16'] == before + 1
    assert torch.equal(got, probe_f16.probe_bitcast_i16_bf16_ref(x))


@pytest.mark.cuda
def test_probe_kernels_reject_non_contiguous(cuda):
    x = probe_f16.make_block(torch.int16, n=64, device=cuda)
    x = torch.cat([x, x], 1)[:, ::2]
    with pytest.raises(ValueError):
        probe_f16.probe_load(x)
    with pytest.raises(ValueError):
        probe_f16.probe_bitcast_i16_bf16(x)


def _same(a, b, tol=1e-5):
    """Equal NaN masks and max-rel <= tol on the rest."""
    assert torch.equal(torch.isnan(a), torch.isnan(b))
    ok = ~torch.isnan(b)
    if bool(ok.any()):
        assert float(((a[ok] - b[ok]).abs() / b[ok].abs().clamp_min(1e-30)).max()) <= tol


@pytest.mark.cuda
@pytest.mark.parametrize('case', ['uniform', 'bad_rays', 'window', 'g24'])
def test_brick_i16_kernel_matches_twin(cuda, case):
    """Kernel K4 (B2 on an int16 brick table) against the twin with deq."""
    kw = dict(uniform={}, bad_rays=dict(mutate=_mutate_bad_rays),
              window=dict(mutate=_mutate_fast_rays), g24=dict(spec=(8, 4, 4, 24)))[case]
    (table, deq), rays, plan, ys, xs, zs = _brick_case(cuda, mode='brick_i16', **kw)
    assert table.dtype == torch.int16
    before = dict(kernels.LAUNCHES)
    w, h = integrate_bricks(table, *rays, plan, ys, xs, zs, deq=deq)
    torch.cuda.synchronize()
    assert kernels.LAUNCHES['brick_integrate_i16'] == before['brick_integrate_i16'] + 1
    assert kernels.LAUNCHES['brick_integrate'] == before['brick_integrate']
    rw, rh = integrate_bricks_ref(table, *rays, plan, ys, xs, zs, deq=deq)
    _same(w, rw)
    _same(h, rh)
    assert torch.isnan(w).any() == (case in ('bad_rays', 'window'))


@pytest.mark.cuda
def test_brick_kernel_takes_24_samples_a_group(cuda):
    table, rays, plan, ys, xs, zs = _brick_case(cuda, spec=(8, 4, 4, 24))
    assert plan.G == 24 and (~plan.pad).sum(1).max() > 8
    w, h = integrate_bricks(table, *rays, plan, ys, xs, zs)
    rw, rh = integrate_bricks_ref(table, *rays, plan, ys, xs, zs)
    _same(w, rw)
    _same(h, rh)
    assert torch.isfinite(w).all()


def _profile_case(device, spec, bad_rays=False):
    sc = kernel_profile.build_scene(device, n_rays=2000, grid=(12, 40, 40), seed=2)
    if bad_rays:
        sc['rays'][0][:, :5] = float('nan')
        sc['rays'][1][:, 9] += 30.0
    return sc, kernel_profile.spec_setup(sc, spec)


@pytest.mark.cuda
@pytest.mark.parametrize('spec', [(7, 3, 3, 6), (8, 4, 4, 24)])
@pytest.mark.parametrize('bad_rays', [False, True])
def test_contract_kernel_matches_twin(cuda, spec, bad_rays):
    """Kernel K1 against its twin on every group of the profile scene."""
    sc, st = _profile_case(cuda, spec, bad_rays)
    n = 0
    for brick, scal, dzos in kernel_profile.contract_inputs(st['table'], sc['rays'],
                                                           st['groups'], st['wy'], st['wx'],
                                                           sc['ys'], sc['xs'], sc['zs']):
        before = kernels.LAUNCHES['brick_contract']
        got = kernel_profile.brick_contract(brick, scal, dzos, st['planes'], st['wy'], st['wx'])
        torch.cuda.synchronize()
        assert kernels.LAUNCHES['brick_contract'] == before + 1
        want = kernel_profile.contract_ref(brick, scal, dzos, st['planes'], st['wy'], st['wx'])
        for a, b in zip(got, want):
            _bitwise(a, b)
        n += 1
    assert n == len(st['groups'])


def _contract_both(brick, scal, dzos, spec=K1_SPEC):
    before = kernels.LAUNCHES['brick_contract']
    got = kernel_profile.brick_contract(brick, scal, dzos, *spec)
    torch.cuda.synchronize()
    assert kernels.LAUNCHES['brick_contract'] == before + 1
    want = kernel_profile.contract_ref(brick, scal, dzos, *spec)
    for a, b in zip(got, want):
        _bitwise(a, b)
    return got


@pytest.mark.cuda
def test_contract_kernel_poison_cases(cuda):
    """K1 bit for bit against its twin on hand-made poisoned rays: wte NaN,
    fz +inf, gx NaN, gy +-inf (not poisoning), a NaN and an inf on brick
    lanes no sample touches, an inf on a touched wet lane (hydro NaN)."""
    brick, scal, dzos = contract_case(n=40, device=cuda)
    w, h = _contract_both(brick, scal, dzos)
    for ray, (what, want) in CASES.items():
        kinds = tuple('nan' if bool(torch.isnan(v)) else 'inf' if bool(torch.isinf(v))
                      else 'finite' for v in (w[ray], h[ray]))
        assert kinds == want, what


@pytest.mark.cuda
@pytest.mark.parametrize('n', [0, 1, 31, 65, 200])
@pytest.mark.parametrize('dzos', [(3,), (5, 5, 0, 3, 3, 1)], ids=['one_sample', 'unordered'])
@pytest.mark.parametrize('offset', [0, 1, 2], ids=['aligned16', 'aligned4', 'aligned8'])
def test_contract_kernel_edge_shapes(cuda, n, dzos, offset):
    """K1 bit for bit against its twin for S = 1, ray counts that do not
    fill a block (and none), and a brick 4- or 8-byte aligned only (the
    4- and 8-byte copy paths)."""
    brick, scal, dzos = contract_case(n=n, seed=n, device=cuda, dzos=dzos, poison=n > 8)
    buf = torch.empty(brick.numel() + offset, dtype=torch.float32, device=cuda)
    view = buf[offset:].view(brick.shape)
    view.copy_(brick)
    w, h = _contract_both(view, scal, dzos)
    assert w.shape == h.shape == (n,)


@pytest.mark.cuda
def test_contract_launch_shape(cuda):
    """The launcher's shape: 64 rays a block at the production spec, and a
    shape for the profile's (8, 4, 4) spec with 24 samples."""
    assert kernels.brick_contract_shape(6, 7, 3, 3) == (64, 41760)
    threads, smem = kernels.brick_contract_shape(24, 8, 4, 4)
    assert threads in (32, 64, 128) and smem <= kernels.SMEM_BLOCK_MAX


@pytest.mark.cuda
@pytest.mark.parametrize('case', ['too_many_samples', 'too_wide'])
def test_contract_kernel_refuses_what_it_cannot_stage(cuda, case):
    """A group of more than 64 samples, or a row too wide for a block of 32
    rays in shared memory, raises and launches nothing."""
    if case == 'too_many_samples':
        spec, dzos = K1_SPEC, tuple(range(5)) * 13
    else:
        spec, dzos = (40, 16, 16), (0, 1)
    width = spec[0] * spec[1] * spec[2] * 2
    brick = torch.ones((3, width), dtype=torch.float32, device=cuda)
    scal = torch.full((3, 4 * len(dzos)), 0.5, dtype=torch.float32, device=cuda)
    with pytest.raises(ValueError):
        kernels.brick_contract_shape(len(dzos), *spec)
    before = kernels.LAUNCHES['brick_contract']
    with pytest.raises(RuntimeError):
        kernel_profile.brick_contract(brick, scal, dzos, *spec)
    assert kernels.LAUNCHES['brick_contract'] == before


@pytest.mark.cuda
@pytest.mark.parametrize('spec', [(7, 3, 3, 6), (8, 4, 4, 24)])
@pytest.mark.parametrize('bad_rays', [False, True])
def test_group_kernels_match_twins(cuda, spec, bad_rays):
    """Kernels K2 (rows, max-rel 1e-5) and K3 (merged, bit for bit) against
    their twins, group by group."""
    sc, st = _profile_case(cuda, spec, bad_rays)
    consts = kernel_profile.group_consts(sc['ys'], sc['xs'], sc['zs'], st['wy'], st['wx'])
    for ops in kernel_profile.rows_inputs(st['table'], sc['rays'], st['groups'], sc['ys'],
                                          sc['xs']):
        before = kernels.LAUNCHES['brick_group_rows']
        got = kernel_profile.brick_group_rows(*ops, consts)
        torch.cuda.synchronize()
        assert kernels.LAUNCHES['brick_group_rows'] == before + 1
        _same(got, kernel_profile.group_rows_ref(*ops, consts))
    for ops in kernel_profile.merged_inputs(st['table'], sc['rays'], st['groups'], sc['ys'],
                                            sc['xs']):
        before = kernels.LAUNCHES['brick_group_merged']
        got = kernel_profile.brick_group_merged(*ops, consts)
        torch.cuda.synchronize()
        assert kernels.LAUNCHES['brick_group_merged'] == before + 1
        want = kernel_profile.group_merged_ref(*ops, consts)
        for a, b in zip(got, want):
            _bitwise(a, b)


def _merged_both(ops, consts):
    before = kernels.LAUNCHES['brick_group_merged']
    got = kernel_profile.brick_group_merged(*ops, consts)
    torch.cuda.synchronize()
    assert kernels.LAUNCHES['brick_group_merged'] == before + 1
    for a, b in zip(got, kernel_profile.group_merged_ref(*ops, consts)):
        _bitwise(a, b)
    return got


@pytest.mark.cuda
@pytest.mark.parametrize('spec', [(7, 3, 3, 6), (8, 4, 4, 24)])
@pytest.mark.parametrize('n_rays', [37, 4097])
@pytest.mark.parametrize('bad_rays', [False, True])
def test_merged_kernel_ragged_ray_counts(cuda, spec, n_rays, bad_rays):
    """K3 bit for bit against its twin on every group for a ray count that is
    a multiple of neither a block nor 4 (ragged slab rows, a partial last
    block) and one below a block."""
    sc = kernel_profile.build_scene(cuda, n_rays=n_rays, grid=(12, 40, 40), seed=5)
    if bad_rays:
        sc['rays'][0][:, :3] = float('nan')
        sc['rays'][1][:, 7] += 30.0
        sc['rays'][4][:, 11] = float('nan')
    st = kernel_profile.spec_setup(sc, spec)
    consts = kernel_profile.group_consts(sc['ys'], sc['xs'], sc['zs'], st['wy'], st['wx'])
    n = 0
    for ops in kernel_profile.merged_inputs(st['table'], sc['rays'], st['groups'], sc['ys'],
                                            sc['xs']):
        got = _merged_both(ops, consts)
        assert got.shape == (2, n_rays)
        assert bool(torch.isnan(got[:, :3]).all()) == bad_rays
        n += 1
    assert n == len(st['groups'])


@pytest.mark.cuda
@pytest.mark.parametrize('offset', [1, 2, 3])
def test_merged_kernel_reads_operands_at_every_alignment(cuda, offset):
    """K3 bit for bit with its brick and merged rows 4-, 8- or 12-byte past
    a 16-byte boundary (the 4- and 8-byte brick copies, every slab head)."""
    sc, st = _profile_case(cuda, (7, 3, 3, 6), bad_rays=True)
    consts = kernel_profile.group_consts(sc['ys'], sc['xs'], sc['zs'], st['wy'], st['wx'])
    for brick, merged, *rest in kernel_profile.merged_inputs(st['table'], sc['rays'],
                                                             st['groups'], sc['ys'], sc['xs']):
        moved = []
        for t in (brick, merged):
            buf = torch.empty(t.numel() + offset, dtype=torch.float32, device=cuda)
            moved.append(buf[offset:].view(t.shape))
            moved[-1].copy_(t)
        _merged_both((*moved, *rest), consts)


@pytest.mark.cuda
@pytest.mark.parametrize('spec', [(7, 3, 3, 6), (8, 4, 4, 24)])
def test_merged_launch_shape(cuda, spec):
    """The launcher's shape on every group of the kernel profile's plans is
    the model's (tests/_group_cases.py), which the CPU tests pin."""
    planes, wy, wx, _ = spec
    width = planes * wy * wx * 2
    for S, nb, nl in profile_groups(spec):
        assert kernels.brick_group_merged_shape(S, width, nb, nl, wy, wx) == \
            merged_launch_shape(S, width, nb, nl)


@pytest.mark.cuda
@pytest.mark.parametrize('case', ['too_many_samples', 'window_9x9'])
def test_merged_kernel_refuses_what_it_cannot_stage(cuda, case):
    """A group of more than 64 samples, or a window past 8x8, raises and
    launches nothing."""
    wy = 9 if case == 'window_9x9' else 3
    sample = (0, 0.5, 0, 0.5, 1, 0.5, 0.0, 1.0e-3, 0)   # lv, f, wal, wav, wbl, wbv, zlo, zinv, dzo
    samples = [sample] * (65 if case == 'too_many_samples' else 2)
    nb, nl, n = 2, 2, 100
    width = 2 * wy * wy * 2
    brick = torch.ones((n, width), dtype=torch.float32, device=cuda)
    merged = torch.ones((3 * nb + 2 * nl + 3, n), dtype=torch.float32, device=cuda)
    consts = (0.0, 10.0, 0.0, 10.0, 0.0, 10.0, 1.0, 1.0, 11, 11, wy, wy)
    with pytest.raises(ValueError):
        kernels.brick_group_merged_shape(len(samples), width, nb, nl, wy, wy)
    before = kernels.LAUNCHES['brick_group_merged']
    with pytest.raises(RuntimeError):
        kernel_profile.brick_group_merged(brick, merged, samples, 0, nb, nl, consts)
    torch.cuda.synchronize()
    assert kernels.LAUNCHES['brick_group_merged'] == before


@pytest.mark.cuda
def test_profile_variants_pass_their_check_on_the_card(cuda):
    """Every Phase 6 variant through ``run`` on a small scene: each passes
    the 4096-ray check against prod and launches its kernel."""
    kernels.reset_launch_counts()
    variants = ('prod', 'tensor', 'pallas', 'pallas2', 'prodmerged', 'prodpallas', 'prodi16')
    recs = kernel_profile.run(cuda, (7, 3, 3, 6), variants, n_rays=5000, grid=(20, 60, 60),
                              say=lambda s: None)
    assert [r['variant'] for r in recs if 'ms' in r] == list(variants)
    assert all(r['ms'] > 0 for r in recs if 'ms' in r)
    for k in ('brick_contract', 'brick_group_rows', 'brick_group_merged', 'brick_integrate',
              'brick_integrate_i16'):
        assert kernels.LAUNCHES[k] >= 1, k


@pytest.mark.cuda
def test_failed_build_raises_and_never_runs_a_twin(cuda, tmp_path, monkeypatch):
    """A CUDA tensor with a failed build raises; no wrapper gives way to its twin."""
    fake = tmp_path / 'bin' / 'nvcc'
    fake.parent.mkdir()
    fake.write_text(_FAKE_NVCC)
    fake.chmod(0o755)
    monkeypatch.setenv('PATH', f'{fake.parent}{os.pathsep}{os.environ["PATH"]}')
    monkeypatch.setenv('FAIL_ON_PROBE', '1')
    monkeypatch.setattr(kernels, 'BUILD_DIR', tmp_path / 'build')
    monkeypatch.setattr(kernels, '_lib', None)

    def twin_ran(*args, **kwargs):
        raise AssertionError('a twin ran for CUDA tensors')

    for mod, name in ((raytrace, 'integrate_bricks_ref'), (kernel_profile, 'contract_ref'),
                      (kernel_profile, 'group_rows_ref'), (kernel_profile, 'group_merged_ref'),
                      (pw, 'window_integrate_ref')):
        monkeypatch.setattr(mod, name, twin_ran)
    b = _window_case(cuda, 'nx_ragged')
    with pytest.raises(RuntimeError, match='nvcc failed'):
        window_integrate(b)
    (table, deq), rays, plan, ys, xs, zs = _brick_case(cuda, n_rays=64, mode='brick_i16')
    with pytest.raises(RuntimeError, match='nvcc failed'):
        integrate_bricks(table, *rays, plan, ys, xs, zs, deq=deq)
    sc, st = _profile_case(cuda, (7, 3, 3, 6))
    brick, scal, dzos = next(kernel_profile.contract_inputs(
        st['table'], sc['rays'], st['groups'], st['wy'], st['wx'], sc['ys'], sc['xs'], sc['zs']))
    with pytest.raises(RuntimeError, match='nvcc failed'):
        kernel_profile.brick_contract(brick, scal, dzos, st['planes'], st['wy'], st['wx'])
    consts = kernel_profile.group_consts(sc['ys'], sc['xs'], sc['zs'], st['wy'], st['wx'])
    ops = next(kernel_profile.rows_inputs(st['table'], sc['rays'], st['groups'], sc['ys'],
                                          sc['xs']))
    with pytest.raises(RuntimeError, match='nvcc failed'):
        kernel_profile.brick_group_rows(*ops, consts)
    ops = next(kernel_profile.merged_inputs(st['table'], sc['rays'], st['groups'], sc['ys'],
                                            sc['xs']))
    with pytest.raises(RuntimeError, match='nvcc failed'):
        kernel_profile.brick_group_merged(*ops, consts)


# ------------------------------------------------ kernels B2/K4: staged spans
def _profile_plan(spec):
    """The grouped plan of ``spec`` over the kernel profile's full-size
    geometry (its level chain and grid at 45 degrees zenith), without cubes."""
    nz, ny, nx = kernel_profile.GRID
    zs = -500.0 + 26500.0 * np.linspace(0.0, 1.0, nz) ** 1.4
    ys, xs = np.linspace(30.0, 40.0, ny), np.linspace(-125.0, -115.0, nx)
    dzv = np.diff(zs)
    planes, wy, wx, gmax = spec
    return build_group_plan((dzv * np.sqrt(2.0)).astype(np.float32), zs, dzv / 111000.0, ys, xs,
                            zs, group_max=gmax, planes=planes, wy=wy, wx=wx)


@pytest.mark.parametrize('itemsize', [4, 2])
@pytest.mark.parametrize('spec', kernel_profile.SPECS)
def test_brick_launch_shape_sizes_every_profile_spec(spec, itemsize):
    """Whole warps within the kernel's launch bound, and shared memory for the
    plan plus the rings of a warp's 32 rays, inside a block's limit."""
    planes, wy, wx, _ = spec
    plan = raytrace._pad_group_plan(_profile_plan(spec), raytrace._PLAN_BUCKET)
    threads, smem = kernels.brick_launch_shape(wy, wx, itemsize, plan.G, plan.anchor.size)
    assert threads % 32 == 0 and 128 <= threads <= 512
    need = (kernels.brick_plan_bytes(plan.anchor.size, plan.G)
            + threads // 32 * 32 * kernels.brick_slot_bytes(wy, wx, itemsize))
    assert need <= smem <= kernels.SMEM_BLOCK_MAX
    # an odd number of (wet, hydro) pairs a ring: the lanes' reads of one
    # corner fall on distinct banks
    assert (kernels.brick_slot_bytes(wy, wx, itemsize) // (2 * itemsize)) % 2 == 1
    resident = kernels.SMEM_SM // (smem + kernels.SMEM_BLOCK_RESERVED) * threads // 32
    assert resident >= (16 if wy * wx * itemsize <= 36 else 12)


@pytest.mark.parametrize('case', ['wide_window', 'huge_plan'])
def test_brick_launch_shape_raises_for_what_it_cannot_take(case):
    args = dict(wide_window=(12, 12, 4, 6, 12), huge_plan=(3, 3, 4, 400, 200))[case]
    with pytest.raises(ValueError, match='shared memory'):
        kernels.brick_launch_shape(*args)


def _bitwise(a, b):
    """Equal NaN masks and the same bits elsewhere."""
    assert torch.equal(torch.isnan(a), torch.isnan(b))
    ok = ~torch.isnan(b)
    assert torch.equal(a[ok], b[ok])


def _integrate_both(table, rays, plan, ys, xs, zs):
    """The kernel (counted) and the twin on one case; ``table`` may be a
    (table, deq) pair."""
    table, deq = table if isinstance(table, tuple) else (table, None)
    name = 'brick_integrate' if deq is None else 'brick_integrate_i16'
    before = kernels.LAUNCHES[name]
    got = integrate_bricks(table, *rays, plan, ys, xs, zs, deq=deq)
    torch.cuda.synchronize()
    assert kernels.LAUNCHES[name] == before + 1
    return got, integrate_bricks_ref(table, *rays, plan, ys, xs, zs, deq=deq)


def _anchor_rows(plan, rays, ys, xs):
    """(n_groups, N) the brick row each ray reads for each group, as the twin
    locates it (-1 for an all-padding group)."""
    from raider_tpu_torch.ops.interp import _locate

    bnd_y, bnd_x = rays[0], rays[1]
    ny, nx = len(ys), len(xs)
    rows = torch.full((plan.anchor.size, bnd_y.shape[1]), -1, dtype=torch.int64,
                      device=bnd_y.device)
    for g in range(plan.anchor.size):
        if plan.pad[g].all():
            continue
        ay = ax = None
        for s in range(plan.G):
            lv = int(plan.lvl[g, s])
            f = torch.tensor(plan.frac[g, s], dtype=torch.float32, device=bnd_y.device)
            iy = _locate(ys, bnd_y[lv] + f * (bnd_y[lv + 1] - bnd_y[lv]))[0]
            ix = _locate(xs, bnd_x[lv] + f * (bnd_x[lv + 1] - bnd_x[lv]))[0]
            ay = iy if ay is None else torch.minimum(ay, iy)
            ax = ix if ax is None else torch.minimum(ax, ix)
        rows[g] = (int(plan.anchor[g]) * ny + ay) * nx + ax
    return rows


def _spec_tables(sc, st, mode):
    if mode == 'brick':
        return st['table']
    qw, qh, deq = raytrace._quantized_pair(sc['wet_d'], sc['hydro_d'])
    return raytrace._pack_bricks(qw, qh, st['planes'], st['wy'], st['wx']), deq


@pytest.mark.cuda
@pytest.mark.parametrize('mode', ['brick', 'brick_i16'])
@pytest.mark.parametrize('n_rays', [1, 31, 33, 129, 1007])
def test_brick_kernels_take_ragged_ray_counts(cuda, n_rays, mode):
    """Fewer rays than a warp, and a last block and warp cut short."""
    table, rays, plan, ys, xs, zs = _brick_case(cuda, n_rays=n_rays, mode=mode)
    (w, h), (rw, rh) = _integrate_both(table, rays, plan, ys, xs, zs)
    _bitwise(w, rw)
    _bitwise(h, rh)
    assert w.shape == (n_rays,) and torch.isfinite(w).all()


@pytest.mark.cuda
@pytest.mark.parametrize('mode', ['brick', 'brick_i16'])
def test_brick_kernels_read_spans_at_every_alignment(cuda, mode):
    """Spans start at every pair-aligned offset within a 128-byte line that
    504-byte (f32) or 252-byte (int16) rows give; the kernel is exact on all."""
    sc, st = _profile_case(cuda, (7, 3, 3, 6))
    plan = st['plan']
    table = _spec_tables(sc, st, mode)
    tab = table[0] if isinstance(table, tuple) else table
    isz, width, plane = tab.element_size(), tab.shape[1], 3 * 3 * 2
    rows = _anchor_rows(plan, sc['rays'], sc['ys'], sc['xs'])
    starts = set()
    for g in range(plan.anchor.size):
        for s in range(plan.G):
            if not plan.pad[g, s]:
                off = (rows[g] * width + int(plan.dzoff[g, s]) * plane) * isz % 128
                starts.update(off.unique().tolist())
    assert starts == set(range(0, 128, 2 * isz))
    (w, h), (rw, rh) = _integrate_both(table, sc['rays'], plan, sc['ys'], sc['xs'], sc['zs'])
    _bitwise(w, rw)
    _bitwise(h, rh)


@pytest.mark.cuda
@pytest.mark.parametrize('mode', ['brick', 'brick_i16'])
def test_brick_kernels_read_only_the_planes_a_sample_uses(cuda, mode):
    """NaN in a plane of a ray's row that no sample of the group reads leaves
    every ray as it was; NaN in a plane a sample reads makes that ray NaN."""
    sc, st = _profile_case(cuda, (8, 4, 4, 24))
    plan, ys, xs, zs, rays = st['plan'], sc['ys'], sc['xs'], sc['zs'], sc['rays']
    table = _spec_tables(sc, st, mode)
    tab, deq = table if isinstance(table, tuple) else (table, None)
    poison = float('nan') if deq is None else raytrace._I16_NAN
    plane = st['wy'] * st['wx'] * 2
    clean = integrate_bricks(tab, *rays, plan, ys, xs, zs, deq=deq)
    rows = _anchor_rows(plan, rays, ys, xs)
    for g in range(plan.anchor.size):
        used = {int(d) + k for d, p in zip(plan.dzoff[g], plan.pad[g]) if not p for k in (0, 1)}
        unused = sorted(set(range(st['planes'])) - used)
        if used and unused:
            break
    else:
        pytest.fail('no group of the plan leaves a plane unread')
    # a finite ray whose row in group g is no ray's row in another group
    others = torch.cat([rows[:g], rows[g + 1:]])
    i = next(i for i in range(rows.shape[1])
             if torch.isfinite(clean[0][i]) and not (others == rows[g, i]).any())
    row = int(rows[g, i])
    bad = tab.clone()
    bad[row, unused[0] * plane:(unused[0] + 1) * plane] = poison
    got = integrate_bricks(bad, *rays, plan, ys, xs, zs, deq=deq)
    for a, b in zip(got, clean):
        _bitwise(a, b)
    bad = tab.clone()
    bad[row, min(used) * plane:(min(used) + 1) * plane] = poison
    got = integrate_bricks(bad, *rays, plan, ys, xs, zs, deq=deq)
    assert torch.isnan(got[0][i]) and torch.isnan(got[1][i])
    other = rows[g] != row
    for a, b in zip(got, clean):
        _bitwise(a[other], b[other])


@pytest.mark.cuda
@pytest.mark.parametrize('mode', ['brick', 'brick_i16'])
def test_brick_kernels_on_the_last_row_and_column(cuda, mode):
    """Vertical rays on the grid's last row, last column and corner: the
    last cell with fraction 1, in bounds, exact against the twin."""
    def edge(rays):
        bnd_y, bnd_x = rays[0], rays[1]
        ys, xs = np.linspace(33.0, 34.0, 11), np.linspace(-118.0, -117.0, 12)
        for i in range(12):
            bnd_y[:, i], bnd_x[:, i] = ys[-1], xs[i]
        for i in range(11):
            bnd_y[:, 12 + i], bnd_x[:, 12 + i] = ys[i], xs[-1]

    table, rays, plan, ys, xs, zs = _brick_case(cuda, n_rays=200, mutate=edge, mode=mode)
    (w, h), (rw, rh) = _integrate_both(table, rays, plan, ys, xs, zs)
    _bitwise(w, rw)
    _bitwise(h, rh)
    assert torch.isfinite(w[:23]).all() and torch.isfinite(h[:23]).all()


@pytest.mark.cuda
@pytest.mark.parametrize('mode', ['brick', 'brick_i16'])
@pytest.mark.parametrize('spec', kernel_profile.SPECS)
def test_brick_kernels_match_twins_on_every_profile_spec(cuda, spec, mode):
    sc, st = _profile_case(cuda, spec, bad_rays=True)
    table = _spec_tables(sc, st, mode)
    (w, h), (rw, rh) = _integrate_both(table, sc['rays'], st['plan'], sc['ys'], sc['xs'],
                                       sc['zs'])
    _bitwise(w, rw)
    _bitwise(h, rh)
    assert torch.isnan(w).any() and not torch.isnan(w).all()


@pytest.mark.parametrize('name', sorted(brick_ablation.ABLATIONS))
def test_brick_ablations_apply_to_the_kernel_source(name):
    """Each ablation of scripts/brick_ablation.py still finds the one line of
    csrc/brick_integrate.cu it replaces."""
    src = (kernels.CSRC / 'brick_integrate.cu').read_text()
    old, new = brick_ablation.ABLATIONS[name]
    out = brick_ablation.ablated_source(name)
    assert out != src and out.count(new) == 1 and old not in out


def test_brick_ablation_needs_the_card():
    with pytest.raises(ValueError, match='CUDA'):
        brick_ablation.run('cpu')


@pytest.mark.parametrize('name', sorted(contract_ablation.ABLATIONS))
def test_contract_ablations_apply_to_the_kernel_source(name):
    """Each ablation of scripts/contract_ablation.py still finds the one line
    of csrc/brick_contract.cu it replaces."""
    src = (kernels.CSRC / contract_ablation.SOURCE).read_text()
    old, new = contract_ablation.ABLATIONS[name]
    out = brick_ablation.ablated_source(name, contract_ablation.SOURCE,
                                        contract_ablation.ABLATIONS)
    assert src.count(old) == 1 and out == src.replace(old, new) != src


def test_contract_ablation_needs_the_card():
    with pytest.raises(ValueError, match='CUDA'):
        contract_ablation.run('cpu')


def test_contract_timing_on_cpu():
    """``kernel_profile contract`` on the CPU: one record, the twin against
    itself bit for bit, no times, and the kernel layer it ran named."""
    lines = []
    rec = kernel_profile.contract_timing('cpu', n_rays=600, grid=(12, 40, 40), say=lines.append)
    assert len(lines) == 1 and rec['mode'] == 'contract' and rec['spec'] == [7, 3, 3, 6]
    assert rec['bit_identical'] and rec['nan_masks_equal'] and rec['max_abs'] == 0.0
    assert rec['k1_ms'] is None and rec['variant_ms'] is None and rec['n_rays'] == 600
    assert rec['kernels'] == kernels.__file__ and rec['n_groups'] >= 1


@pytest.mark.parametrize('name', sorted(group_ablation.ABLATIONS))
def test_group_ablations_apply_to_the_kernel_source(name):
    """Each ablation of scripts/group_ablation.py still finds the lines of
    csrc/brick_group.cu it replaces, once."""
    src = (kernels.CSRC / group_ablation.SOURCE).read_text()
    old, new = group_ablation.ABLATIONS[name]
    out = brick_ablation.ablated_source(name, group_ablation.SOURCE, group_ablation.ABLATIONS)
    assert src.count(old) == 1 and out == src.replace(old, new) != src


@pytest.mark.parametrize('name', sorted(window_kernel_ablation.ABLATIONS))
def test_window_kernel_ablations_apply_to_the_kernel_source(name):
    """Each ablation of scripts/window_kernel_ablation.py still finds each
    line of csrc/window_integrate.cu it replaces, once."""
    src = (kernels.CSRC / window_kernel_ablation.SOURCE).read_text()
    edits = window_kernel_ablation.ABLATIONS[name]
    want = src
    for old, new in edits if isinstance(edits, list) else [edits]:
        assert src.count(old) == 1
        want = want.replace(old, new)
    out = brick_ablation.ablated_source(name, window_kernel_ablation.SOURCE,
                                        window_kernel_ablation.ABLATIONS)
    assert out == want != src


def test_window_kernel_ablation_needs_the_card():
    with pytest.raises(ValueError, match='CUDA'):
        window_kernel_ablation.run('cpu')


def test_group_ablation_needs_the_card():
    with pytest.raises(ValueError, match='CUDA'):
        group_ablation.run('cpu')


def test_merged_timing_on_cpu():
    """``kernel_profile merged`` on the CPU: one record, the twin against
    itself bit for bit, no times, and the kernel layer it ran named."""
    lines = []
    rec = kernel_profile.merged_timing('cpu', n_rays=600, grid=(12, 40, 40), say=lines.append)
    assert len(lines) == 1 and rec['mode'] == 'merged' and rec['spec'] == [7, 3, 3, 6]
    assert rec['bit_identical'] and rec['nan_masks_equal'] and rec['max_abs'] == 0.0
    assert rec['k3_ms'] is None and rec['variant_ms'] is None and rec['n_rays'] == 600
    assert rec['kernels'] == kernels.__file__ and rec['n_groups'] >= 1


def test_rows_timing_on_cpu():
    """``kernel_profile rows`` on the CPU: one record of K2's twin against
    itself, no times, and the kernel layer it ran named."""
    lines = []
    rec = kernel_profile.rows_timing('cpu', n_rays=600, grid=(12, 40, 40), say=lines.append)
    assert len(lines) == 1 and rec['mode'] == 'rows' and rec['spec'] == [7, 3, 3, 6]
    assert rec['bit_identical'] and rec['nan_masks_equal'] and rec['max_abs'] == 0.0
    assert rec['k2_ms'] is None and rec['variant_ms'] is None and rec['n_rays'] == 600
    assert rec['kernels'] == kernels.__file__ and rec['n_groups'] >= 1
