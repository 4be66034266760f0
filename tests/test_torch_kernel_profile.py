"""The kernel profile (S1-S3 and their reference): raider_tpu_torch vs scripts/kernel_profile.py (CPU).

On a small seeded scene (the script's scene cut to 8x40x40 cubes, a level
chain up to 8.5 km and 512 rays, built once by the port and fed to both
packages):

  * ``static_brick_ref`` (prod) against ``_static_brick_fn``;
  * ``make_tensor_fn`` against the JAX ``make_tensor_fn``;
  * the S1, S2 and S3 paths, through the wrappers and with the twins named
    explicitly, against the JAX ``make_pallas_fn``, ``make_pallas2_fn`` and
    ``make_merged_fn`` in interpret mode;
  * the split ablations against the JAX script's own (its ``main('split')``
    with the scene swapped in);

at rtol 2e-6 with equal NaN masks. At spec (8,4,4,24), whose groups hold
more than 8 samples, every port path (B2's twin included) is held to the
JAX reference at the script's own 1e-5. ``run('cpu', ...)`` prints its
check and timing lines. Each JAX function is built once per module.
"""

import importlib.util
import json
import pathlib
import sys

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from raider_tpu.delay import raytrace as j_rt
from raider_tpu_torch.scripts import kernel_profile as kp
from _contract_cases import CASES, DZOS, SPEC as K1_SPEC, contract_case

REPO = pathlib.Path(__file__).resolve().parents[1]
GRID = (8, 40, 40)
N_RAYS = 512
RTOL = 2e-6
SPEC = (7, 3, 3, 6)
SPEC_G24 = (8, 4, 4, 24)


def _load_jax_script():
    spec = importlib.util.spec_from_file_location('jax_kernel_profile',
                                                  REPO / 'scripts' / 'kernel_profile.py')
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.fixture(scope='module')
def jkp():
    return _load_jax_script()


@pytest.fixture(scope='module')
def scene():
    """The script's scene with its level chain cut to 8.5 km: fewer samples
    and groups keep the JAX interpret-mode compiles short."""
    sc = kp.make_bench_scene(N_RAYS, 0, GRID)
    zs = -500.0 + 9000.0 * np.linspace(0.0, 1.0, GRID[0]) ** 1.4
    dzv = np.diff(zs)
    sc.update(zs=zs, heights=zs.copy(), dzv=dzv,
              per_level_max=(dzv * float((1.0 / np.cos(sc['zen'])).max())).astype(np.float32),
              hstep_max=dzv * float(np.tan(sc['zen']).max()) * sc['deg_per_m'],
              device=torch.device('cpu'), wet_d=torch.as_tensor(sc['wet']),
              hydro_d=torch.as_tensor(sc['hydro']))
    sc['rays'] = kp.build_rays(sc, 'cpu')
    return sc


class JaxSide:
    """The JAX functions of one spec, each built and run once."""

    def __init__(self, jkp, sc, spec):
        self.jkp, self.sc = jkp, sc
        planes, wy, wx, gmax = spec
        plan = j_rt.build_group_plan(sc['per_level_max'], sc['heights'], sc['hstep_max'],
                                     sc['ys'], sc['xs'], sc['zs'], group_max=gmax,
                                     planes=planes, wy=wy, wx=wx)
        self.static = j_rt.static_plan_from(plan)
        self.table = j_rt._pack_bricks(jnp.asarray(sc['wet']), jnp.asarray(sc['hydro']),
                                       planes, wy, wx)
        self.rays = [jnp.asarray(a.numpy()) for a in sc['rays']]
        self._out = {}

    def __call__(self, variant):
        if variant not in self._out:
            groups, planes, wy, wx = self.static
            ys, xs, zs = self.sc['ys'], self.sc['xs'], self.sc['zs']
            if variant == 'prod':
                fn = j_rt._static_brick_fn(groups, planes, wy, wx, tuple(ys.tolist()),
                                           tuple(xs.tolist()), tuple(zs.tolist()), True, False)
            elif variant == 'tensor':
                fn = self.jkp.make_tensor_fn(groups, planes, wy, wx, ys, xs, zs)
            else:
                make = dict(pallas=self.jkp.make_pallas_fn, pallas2=self.jkp.make_pallas2_fn,
                            prodmerged=self.jkp.make_merged_fn)[variant]
                fn = make(groups, planes, wy, wx, ys, xs, zs, interpret=True)
            self._out[variant] = [np.asarray(a) for a in fn(self.table, *self.rays)]
        return self._out[variant]


@pytest.fixture(scope='module')
def jax_side(jkp, scene):
    return JaxSide(jkp, scene, SPEC)


@pytest.fixture(scope='module')
def jax_g24(jkp, scene):
    return JaxSide(jkp, scene, SPEC_G24)


@pytest.fixture(scope='module')
def setups(scene):
    return {s: kp.spec_setup(scene, s) for s in (SPEC, SPEC_G24)}


def _assert_close(got, want, rtol):
    for a, b in zip(got, want):
        a = a.numpy()
        np.testing.assert_array_equal(np.isnan(a), np.isnan(b))
        np.testing.assert_allclose(a, b, rtol=rtol, equal_nan=True)


def _port_fn(variant, sc, st, twin=False):
    g, planes, wy, wx = st['groups'], st['planes'], st['wy'], st['wx']
    ys, xs, zs = sc['ys'], sc['xs'], sc['zs']
    if variant == 'pallas':
        return kp.make_pallas_fn(g, planes, wy, wx, ys, xs, zs,
                                 contract=kp.contract_ref if twin else None)
    if variant == 'pallas2':
        return kp.make_pallas2_fn(g, planes, wy, wx, ys, xs, zs,
                                  group=kp.group_rows_ref if twin else None)
    if variant == 'prodmerged':
        return kp.make_merged_fn(g, planes, wy, wx, ys, xs, zs,
                                 group=kp.group_merged_ref if twin else None)
    return kp.variant_fn(variant, sc, st)[0]


def test_tables_and_plans_are_the_jax_ones(scene, setups, jax_side, jax_g24):
    for s, side in ((SPEC, jax_side), (SPEC_G24, jax_g24)):
        assert setups[s]['groups'] == side.static[0]
        np.testing.assert_array_equal(setups[s]['table'].numpy(), np.asarray(side.table))
    assert max(len(smp) for _, smp in setups[SPEC_G24]['groups']) > 8


@pytest.mark.parametrize('variant', ['prod', 'tensor'])
def test_xla_variants_match_jax(scene, setups, jax_side, variant):
    st = setups[SPEC]
    _assert_close(_port_fn(variant, scene, st)(st['table'], *scene['rays']), jax_side(variant),
                  RTOL)


@pytest.mark.parametrize('variant', ['pallas', 'pallas2', 'prodmerged'])
@pytest.mark.parametrize('twin', [False, True], ids=['wrapper', 'twin'])
def test_pallas_variants_match_jax_interpret(scene, setups, jax_side, variant, twin):
    st = setups[SPEC]
    got = _port_fn(variant, scene, st, twin=twin)(st['table'], *scene['rays'])
    _assert_close(got, jax_side(variant), RTOL)
    assert np.isfinite(got[0].numpy()).all()


@pytest.mark.parametrize('variant', ['prod', 'tensor', 'pallas', 'pallas2', 'prodmerged',
                                     'prodpallas'])
def test_g24_paths_match_jax(scene, setups, jax_g24, variant):
    """Groups of up to 24 samples: every port path against the JAX reference."""
    st = setups[SPEC_G24]
    got = _port_fn(variant, scene, st)(st['table'], *scene['rays'])
    _assert_close(got, jax_g24('prod'), RTOL if variant == 'prod' else kp.TOL_REL)


@pytest.fixture(scope='module')
def jax_split(jkp, scene, jax_side):
    """The JAX script's split ablations, run by its own main() on this scene."""
    outs = []
    saved = (jkp.make_bench_scene, jkp.build_rays_np, jkp.time_fn, sys.argv)
    jkp.make_bench_scene = lambda: {k: scene[k] for k in (
        'wet', 'hydro', 'ys', 'xs', 'zs', 'zen', 'azi', 'y0', 'x0', 'dzv', 'per_level_max',
        'heights', 'hstep_max', 'deg_per_m')}
    jkp.build_rays_np = lambda sc: tuple(jax_side.rays)
    jkp.time_fn = lambda fn: (outs.append(fn(0.0)), 0.0)[1]
    sys.argv = ['kernel_profile.py', 'split']
    try:
        jkp.main()
    finally:
        jkp.make_bench_scene, jkp.build_rays_np, jkp.time_fn, sys.argv = saved
    return dict(zip(('gather_only', 'gather_materialized', 'arith_only'), outs))


@pytest.mark.parametrize('name', ['gather_only', 'gather_materialized', 'arith_only'])
def test_split_ablations_match_jax(scene, setups, jax_split, name):
    st = setups[SPEC]
    g, ys, xs, zs = st['groups'], scene['ys'], scene['xs'], scene['zs']
    fn = dict(gather_only=lambda: kp.make_gather_only(g, ys, xs),
              gather_materialized=lambda: kp.make_gather_materialized(g, ys, xs),
              arith_only=lambda: kp.make_arith_only(g, st['planes'], ys, xs, zs))[name]()
    got = fn(st['table'], *scene['rays'])
    want = jax_split[name]
    got, want = ((got,), (want,)) if name.startswith('gather') else (got, want)
    _assert_close(got, [np.asarray(w) for w in want], RTOL)


def test_run_prints_a_line_per_check_and_per_variant():
    lines = []
    variants = ('prod', 'tensor', 'pallas', 'pallas2', 'prodmerged', 'prodpallaskt1',
                'prodi16', 'pallas2d3', 'pallas2t2048', 'pallas3')
    recs = kp.run('cpu', SPEC, variants, n_rays=300, grid=(12, 40, 40), say=lines.append)
    assert [json.loads(s) for s in lines] == recs
    timed = [r for r in recs if 'ms' in r]
    checks = [r for r in recs if r.get('equiv_ok')]
    assert [r['variant'] for r in timed] == list(variants)
    assert [r['variant'] for r in checks] == list(variants[1:])
    assert all(r['ms'] is None and r['device'] == 'cpu' and r['card'] is None for r in timed)
    by = {r['variant']: r for r in timed}
    assert by['prodpallaskt1']['maps_to'] == 'brick_integrate'
    assert by['prodpallaskt1']['ignored'] == 'kt1'
    assert by['pallas2t2048']['ignored'] == '2048'
    assert by['pallas2d3']['barrier_depth'] == 3
    assert by['prodi16']['maps_to'] == 'brick_integrate_i16'
    assert by['prodi16']['table_gb'] == by['prod']['table_gb'] / 2
    split = kp.run('cpu', 'split', n_rays=300, grid=(12, 40, 40), say=lambda s: None)
    assert [r['variant'] for r in split] == ['gather_only', 'gather_materialized', 'arith_only']


def test_wrappers_reject_bad_operands(scene, setups):
    st = setups[SPEC]
    brick, scal, dzos = next(kp.contract_inputs(st['table'], scene['rays'], st['groups'],
                                                st['wy'], st['wx'], scene['ys'], scene['xs'],
                                                scene['zs']))
    with pytest.raises(ValueError):
        kp.brick_contract(brick[:, :-2], scal, dzos, st['planes'], st['wy'], st['wx'])
    with pytest.raises(ValueError):
        kp.brick_contract(brick, scal[:, :-1], dzos, st['planes'], st['wy'], st['wx'])
    consts = kp.group_consts(scene['ys'], scene['xs'], scene['zs'], st['wy'], st['wx'])
    ops = next(kp.rows_inputs(st['table'], scene['rays'], st['groups'], scene['ys'],
                              scene['xs']))
    with pytest.raises(ValueError):
        kp.brick_group_rows(ops[0], ops[1][:1], *ops[2:], consts)
    ops = next(kp.merged_inputs(st['table'], scene['rays'], st['groups'], scene['ys'],
                                scene['xs']))
    with pytest.raises(ValueError):
        kp.brick_group_merged(ops[0], ops[1][1:], *ops[2:], consts)
    with pytest.raises(ValueError, match='uniform'):
        kp.group_consts(np.array([0.0, 1.0, 3.0]), scene['xs'], scene['zs'], 3, 3)


def test_cpu_wrappers_run_the_twins(scene, setups):
    st = setups[SPEC]
    brick, scal, dzos = next(kp.contract_inputs(st['table'], scene['rays'], st['groups'],
                                                st['wy'], st['wx'], scene['ys'], scene['xs'],
                                                scene['zs']))
    got = kp.brick_contract(brick, scal, dzos, st['planes'], st['wy'], st['wx'])
    want = kp.contract_ref(brick, scal, dzos, st['planes'], st['wy'], st['wx'])
    for a, b in zip(got, want):
        assert torch.equal(a, b)


# ------------------------- kernel K1: the twin semantics its design relies on
def _kind(v) -> str:
    return 'nan' if bool(torch.isnan(v)) else ('inf' if bool(torch.isinf(v)) else 'finite')


@pytest.mark.parametrize('ray', sorted(CASES))
def test_contract_twin_poison_cases(ray):
    """A non-finite wte or fz, or a NaN gy or gx, makes both of the twin's
    sums NaN; gy at +-inf only zeroes a hat weight; a NaN or inf brick lane
    poisons both sums even where no sample touches it; an inf on a touched
    wet lane gives wet inf and hydro NaN (inf x 0)."""
    brick, scal, dzos = contract_case()
    w, h = kp.contract_ref(brick, scal, dzos, *K1_SPEC)
    what, want = CASES[ray]
    assert (_kind(w[ray]), _kind(h[ray])) == want, what
    clean = [r for r in range(brick.shape[0]) if r not in CASES]
    assert torch.isfinite(w[clean]).all() and torch.isfinite(h[clean]).all()


def _touched_planes_only(brick, scal, dzos, planes, wy, wx):
    """Kernel K1's scheme in torch: U(c) sums, in sample order, only the
    samples whose planes dzo, dzo + 1 hold lane c (+0 where none does), and
    a ray with a non-finite wte or fz, or a NaN gy or gx, is NaN."""
    width = planes * wy * wx * 2
    c = lambda v: torch.tensor(v, dtype=torch.float32)  # noqa: E731
    lane = torch.arange(width, dtype=torch.float32)[None, :]
    dzc = torch.floor(lane / c(wy * wx * 2.0))
    r1 = lane - dzc * (wy * wx * 2.0)
    dyc = torch.floor(r1 / c(wx * 2.0))
    r2 = r1 - dyc * (wx * 2.0)
    dxc = torch.floor(r2 / c(2.0))
    fhyd = (r2 - 2.0 * dxc)[0]
    U = torch.zeros_like(brick)
    started = torch.zeros_like(lane, dtype=torch.bool)
    poison = torch.zeros(brick.shape[0], dtype=torch.bool)
    for s, dzo in enumerate(dzos):
        gy, gx, fz, wte = (scal[:, 4 * s + i:4 * s + i + 1] for i in range(4))
        poison |= (~torch.isfinite(wte) | ~torch.isfinite(fz) | gy.isnan() | gx.isnan())[:, 0]
        on0, on1 = dzc == float(dzo), dzc == float(dzo + 1)
        wz = torch.where(on0, 1.0 * (1.0 - fz) + 0.0 * fz, 0.0 * (1.0 - fz) + 1.0 * fz)
        w = wte * wz * (1.0 - (gy - dyc).abs()).clamp_min(0.0) * (1.0 - (gx - dxc).abs()).clamp_min(0.0)
        on = on0 | on1
        U = torch.where(on & started, U + w, torch.where(on, w, U))
        started = started | on
    prod = brick * U
    acc_w = torch.zeros(brick.shape[0])
    acc_h = torch.zeros_like(acc_w)
    for k in range(width):
        acc_w = acc_w + prod[:, k] * (1.0 - fhyd[k])
        acc_h = acc_h + prod[:, k] * fhyd[k]
    nan = torch.tensor(float('nan'))
    return torch.where(poison, nan, acc_w), torch.where(poison, nan, acc_h)


@pytest.mark.parametrize('dzos', [DZOS, (5, 5, 0, 3, 3, 1), (2,)],
                         ids=['production', 'unordered', 'one_sample'])
@pytest.mark.parametrize('poison', [False, True])
def test_contract_twin_needs_only_touched_planes(dzos, poison):
    """Dropping every sample's terms outside its two planes (and writing NaN
    for a poisoned ray) leaves the twin's outputs unchanged, bit for bit,
    with equal NaN masks: what lets kernel K1 build U on the touched planes
    only."""
    brick, scal, dzos = contract_case(dzos=dzos, poison=poison)
    got = _touched_planes_only(brick, scal, dzos, *K1_SPEC)
    want = kp.contract_ref(brick, scal, dzos, *K1_SPEC)
    for a, b in zip(got, want):
        nan = torch.isnan(b)
        assert torch.equal(torch.isnan(a), nan)
        assert torch.equal(a[~nan], b[~nan])
    assert bool(torch.isfinite(want[0]).any())
