"""The port's z-slab tables (``raider_tpu_torch.parallel.zshard``) on the CPU.

Mirrors tests/test_zshard.py on the same seeded scenes. The table's rows
split into 8 contiguous z-slabs (a mesh of one CPU device named 8 times),
each slab walks the whole ray batch, the partials are summed in slab order.
Held to the unsharded port in the same packed mode (equal NaN masks, rtol
2e-6: only the order of the sum differs) and to the JAX package's
``integrate_rays_z_sharded`` on the conftest's 8 virtual devices (rtol 2e-6,
the port-vs-JAX tolerance of the packed modes in tests/test_torch_table_modes.py).
"""

import datetime as dt

import numpy as np
import pytest
import torch

from raider_tpu.parallel.zshard import integrate_rays_z_sharded as j_zsharded
from raider_tpu.parallel.zshard import pack_cube_slabs as j_pack_slabs
from raider_tpu_torch.delay import raytrace as rt
from raider_tpu_torch.delay.raytrace import integrate_rays, pack_cubes
from raider_tpu_torch.parallel import get_mesh, integrate_rays_z_sharded, pack_cube_slabs
from raider_tpu_torch.parallel.zshard import zshard_auto

from tests.test_zshard import _scene

MESH = get_mesh(devices=('cpu',) * 8)
RTOL = 2e-6


def _t(scene):
    wet, hydro, ys, xs, zs, rays, plm = scene
    return (torch.as_tensor(wet), torch.as_tensor(hydro), ys, xs, zs,
            [torch.as_tensor(np.ascontiguousarray(a)) for a in rays], plm)


def _unsharded(wet, hydro, ys, xs, zs, rays, plm, mode):
    packed, _ = pack_cubes(wet, hydro, mode=mode)
    return integrate_rays(wet, hydro, ys, xs, zs, *rays, plm, packed2d=packed, mode=mode)


def _sharded(wet, hydro, ys, xs, zs, rays, plm, mode):
    return integrate_rays_z_sharded(wet, hydro, ys, xs, zs, *rays, plm, mode=mode, mesh=MESH)


@pytest.mark.parametrize('mode', ['pack16', 'pack4', 'pack16_i16'])
def test_matches_replicated_integrate_and_jax(mode):
    scene = _scene(np.random.default_rng(42), nan_cells=4)
    wet, hydro, ys, xs, zs, rays, plm = _t(scene)
    w_ref, h_ref = _unsharded(wet, hydro, ys, xs, zs, rays, plm, mode)
    w_z, h_z = _sharded(wet, hydro, ys, xs, zs, rays, plm, mode)
    for a, b in ((w_z, w_ref), (h_z, h_ref)):
        a, b = a.numpy(), b.numpy()
        np.testing.assert_array_equal(np.isnan(a), np.isnan(b))
        assert np.isfinite(b).any()
        np.testing.assert_allclose(a, b, rtol=RTOL, equal_nan=True)
    j_w, j_h = (np.asarray(v) for v in j_zsharded(*scene[:5], *scene[5], scene[6], mode=mode))
    for a, b in ((w_z.numpy(), j_w), (h_z.numpy(), j_h)):
        np.testing.assert_array_equal(np.isnan(a), np.isnan(b))
        np.testing.assert_allclose(a, b, rtol=RTOL, equal_nan=True)


def test_pack16_i16_within_quantization_bound():
    wet, hydro, ys, xs, zs, rays, plm = _t(_scene(np.random.default_rng(43)))
    w_ref, h_ref = _unsharded(wet, hydro, ys, xs, zs, rays, plm, 'pack16')
    w_z, h_z = _sharded(wet, hydro, ys, xs, zs, rays, plm, 'pack16_i16')
    assert float((w_z - w_ref).abs().max()) < 1e-4
    assert float((h_z - h_ref).abs().max()) < 1e-4


def test_deterministic_across_runs():
    args = _t(_scene(np.random.default_rng(44), n_rays=128))
    a = _sharded(*args, 'pack16')[0]
    b = _sharded(*args, 'pack16')[0]
    assert torch.equal(a, b)


def test_uneven_slabs():
    """nz - 1 = 10 anchor cells over 8 slabs: slabs of two and of one."""
    args = _t(_scene(np.random.default_rng(45), nz=11))
    w_ref, _ = _unsharded(*args, 'pack16')
    w_z, _ = _sharded(*args, 'pack16')
    np.testing.assert_allclose(w_z.numpy(), w_ref.numpy(), rtol=RTOL)


@pytest.mark.parametrize('mode', ['pack16', 'pack4', 'pack16_i16'])
def test_slab_tables_shrink_per_device(mode):
    """Each slab holds about 1/8 of the rows (pack4 one halo plane more),
    the slabs partition the anchor cells as the JAX package's do, and
    their rows are the unsharded table's."""
    nz, ny, nx = 17, 16, 20
    r = np.random.default_rng(46)
    wet = r.uniform(1, 2, (nz, ny, nx)).astype(np.float32)
    hydro = wet + 1
    tables, z_lo, z_hi, deq = pack_cube_slabs(torch.as_tensor(wet), torch.as_tensor(hydro),
                                              mode, 8, mesh=MESH)
    assert len(tables) == 8 and (deq is None) == (mode != 'pack16_i16')
    assert z_lo[0] == 0 and z_hi[-1] == nz - 1 and (z_lo[1:] == z_hi[:-1]).all()
    _, j_lo, j_hi, _ = j_pack_slabs(wet, hydro, mode, 8)
    np.testing.assert_array_equal(z_lo, np.asarray(j_lo))
    np.testing.assert_array_equal(z_hi, np.asarray(j_hi))
    halo = 1 if mode == 'pack4' else 0
    full = pack_cubes(torch.as_tensor(wet), torch.as_tensor(hydro), mode=mode)[0]
    full = full[0] if mode == 'pack16_i16' else full
    plane = ny * nx
    for t, lo, hi in zip(tables, z_lo, z_hi):
        assert t.shape[0] == (hi - lo + halo) * plane <= (int(np.ceil((nz - 1) / 8)) + halo) * plane
        assert torch.equal(t, full[lo * plane:(hi + halo) * plane])
    assert sum(t.shape[0] for t in tables) == (nz - 1 + 8 * halo) * plane


def test_engine_zshard_matches_replicated(monkeypatch):
    """The engine's ``_build_cube_ray`` on the z-slab path (``zshard=True``,
    a packed mode forced by taking the brick spec's budget away) against
    the replicated table: equal NaN masks, rtol 2e-6."""
    from raider_tpu_torch.convert import dataset_from_reference, orbit_from_reference
    from raider_tpu_torch.delay.engine import WeatherCube, _build_cube_ray
    from raider_tpu_torch.geodesy import Geographic
    from raider_tpu_torch.geometry import Raytracing

    from tests.test_raytrace import synthetic_orbit, synthetic_wm_dataset

    r = np.random.default_rng(5)
    shape = (49, 13, 17)
    t = dt.datetime(2020, 1, 30, 13, 52, 45)
    wm = WeatherCube(dataset_from_reference(synthetic_wm_dataset(
        wet_cube=r.uniform(0.1, 100.0, shape), hydro_cube=r.uniform(50.0, 300.0, shape))),
        'cpu')
    los = Raytracing(orbit=orbit_from_reference(synthetic_orbit(t)), time=t)
    monkeypatch.setattr(rt, '_BRICK_SPECS', ((7, 3, 3, 6, 0),))
    slabs = []
    monkeypatch.setattr('raider_tpu_torch.delay.engine.pack_cube_slabs',
                        lambda *a, **k: slabs.append(a[2]) or pack_cube_slabs(*a, **k))

    def run(zshard):
        return _build_cube_ray(wm, np.linspace(-118.4, -117.2, 8), np.linspace(33.2, 33.8, 6),
                               np.array([0.0, 4000.0]), los, Geographic(), zref=25000.0,
                               compute_dtype=torch.float32, mesh=MESH, zshard=zshard)

    w_rep, h_rep = run(False)
    assert not slabs
    w_z, h_z = run(True)
    assert slabs == ['pack16']
    np.testing.assert_array_equal(np.isnan(w_z), np.isnan(w_rep))
    assert np.isfinite(w_rep).any()
    np.testing.assert_allclose(w_z, w_rep, rtol=RTOL, equal_nan=True)
    np.testing.assert_allclose(h_z, h_rep, rtol=RTOL, equal_nan=True)


def test_zshard_auto_gate():
    from raider_tpu.parallel.zshard import zshard_auto as j_auto

    small = (50, 400, 400)          # pack16 f32 table 0.5 GB: replicate
    giant = (137, 1801, 3600)       # ~888M cells: 28 GB even as pack4
    for shape, mode, n in ((small, 'pack16', 8), (giant, 'pack4', 8), (giant, 'pack16_i16', 8),
                           (giant, 'brick', 8), (giant, 'pack4', 1)):
        assert zshard_auto(shape, np.float32, mode, n) == j_auto(shape, np.float32, mode, n)
        assert zshard_auto(shape, torch.float32, mode, n) == j_auto(shape, np.float32, mode, n)
    assert zshard_auto(giant, np.float32, 'pack4', 8)
    assert not zshard_auto(small, np.float32, 'pack16', 8)
    assert not zshard_auto(giant, np.float32, 'pack4', 8, force=False)
    assert zshard_auto(small, np.float32, 'pack16', 8, force=True)
    assert not zshard_auto(small, np.float32, 'pack16', 1, force=True)
    assert zshard_auto(small, np.float32, 'pack16', 8, budget_gb=0.1)
