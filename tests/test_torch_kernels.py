"""The CUDA kernels of raider_tpu_torch against their plain-torch twins.

Tests marked ``cuda`` need an NVIDIA GPU and skip elsewhere. This file
imports neither jax nor raider_tpu, so it also runs on a machine with the
card and without jax:

    python -m pytest tests/test_torch_kernels.py --noconftest -p no:cacheprovider -q

The kernels use round-to-nearest arithmetic in their twins' order of
operations, so on NaN-free inputs they must agree with the twins exactly;
the stated tolerances (B1 2e-6; B2, B3, K1-K4 1e-5 relative; S4 and S5
exact) are the contract the smoke run holds them to.
"""

import os

import numpy as np
import pytest
import torch

from raider_tpu_torch import kernels
from raider_tpu_torch.delay.pallas_window import (integrate_rays_windowed, prepare_windowed,
                                                  window_integrate, window_integrate_ref)
from raider_tpu_torch.delay import raytrace
from raider_tpu_torch.delay.raytrace import (build_group_plan, integrate_bricks,
                                             integrate_bricks_ref, pack_cubes)
from raider_tpu_torch.ops.ztd import ztd_totals, ztd_totals_ref
from raider_tpu_torch.scripts import kernel_profile, probe_f16, window_ablation

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


@pytest.mark.cuda
@pytest.mark.parametrize('shape', [(51, 40, 130), (8, 8, 128), (5, 3, 7), (2, 1, 1)])
def test_ztd_kernel_matches_twin(cuda, shape):
    t, p, e, zs = _ztd_inputs(shape, device=cuda)
    before = kernels.LAUNCHES['ztd_totals']
    w, h = ztd_totals(t, p, e, zs, K1, K2, K3)
    torch.cuda.synchronize()
    assert kernels.LAUNCHES['ztd_totals'] == before + 1
    rw, rh = ztd_totals_ref(t, p, e, zs, K1, K2, K3)
    for a, b in ((w, rw), (h, rh)):
        nz = b != 0
        assert torch.equal(a[~nz], b[~nz])
        assert float(((a[nz] - b[nz]).abs() / b[nz].abs()).max()) <= 2e-6


@pytest.mark.cuda
def test_ztd_kernel_rejects_non_contiguous(cuda):
    t, p, e, zs = _ztd_inputs((4, 6, 8), device=cuda)
    with pytest.raises(ValueError):
        ztd_totals(t.transpose(1, 2), p.transpose(1, 2), e.transpose(1, 2), zs, K1, K2, K3)


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
        assert torch.equal(torch.isnan(a), torch.isnan(r))
        assert _rel(a, r) <= 1e-5
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
            _same(a, b)
        n += 1
    assert n == len(st['groups'])


@pytest.mark.cuda
@pytest.mark.parametrize('spec', [(7, 3, 3, 6), (8, 4, 4, 24)])
@pytest.mark.parametrize('bad_rays', [False, True])
def test_group_kernels_match_twins(cuda, spec, bad_rays):
    """Kernels K2 (rows) and K3 (merged) against their twins, group by group."""
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
        _same(got, kernel_profile.group_merged_ref(*ops, consts))


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
                      (kernel_profile, 'group_rows_ref'), (kernel_profile, 'group_merged_ref')):
        monkeypatch.setattr(mod, name, twin_ran)
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
