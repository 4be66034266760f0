"""The port's device meshes and ray sharding (``raider_tpu_torch.parallel.mesh``)
on the CPU, against the unsharded port and the JAX package.

A mesh of one device named 8 times runs the 8 shards one after another:
padding, placement and the joins are the multi-device ones. Sharded cubes
equal the unsharded port's bit for bit (the slice's plan is built before
the split and every ray is integrated alone); against the JAX package, whose
engine shards the same requests over the conftest's 8 virtual CPU devices,
the tolerances are those of the unsharded comparison
(``tests/test_torch_slice.py``: float64 1e-9 m, float32 1e-5 m).
"""

import os
import socket
import subprocess
import sys

import jax
import numpy as np
import pytest
import torch

from raider_tpu.delay import engine as j_engine
from raider_tpu.geometry.aoi import BoundingBox as JBox
from raider_tpu.geometry.los import Raytracing as JRay
from raider_tpu.geometry.los import Zenith as JZen
from raider_tpu_torch.convert import dataset_from_reference, orbit_from_reference
from raider_tpu_torch.delay import engine as t_engine
from raider_tpu_torch.geometry import BoundingBox, Raytracing, Zenith
from raider_tpu_torch.ops import contract_yx
from raider_tpu_torch.parallel import default_mesh, get_mesh, mesh as t_mesh, shard_rays
from raider_tpu_torch.parallel.mesh import (Mesh, device_get_global, gather_rays,
                                            pad_to_multiple, place_ray_arrays, replicate)

from tests.test_orbit import synthetic_orbit
from tests.test_torch_slice import BBOX, HEIGHTS, REPO, T0, TOL, wm_dataset  # noqa: F401

CPU8 = ('cpu',) * 8


def test_mesh_of_repeated_devices():
    mesh = get_mesh(devices=CPU8)
    assert mesh.size == 8 and mesh.axis_names == ('rays',)
    assert mesh.distinct == (torch.device('cpu'),)
    assert get_mesh(4, devices=CPU8).size == 4
    with pytest.raises(ValueError):
        get_mesh(9, devices=CPU8)
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match='CUDA'):
            get_mesh()


def test_default_mesh(monkeypatch):
    """A device with an index, or the CPU, is a mesh of itself alone; a bare
    'cuda' is every CUDA device."""
    assert default_mesh('cpu').devices == (torch.device('cpu'),)
    assert default_mesh('cuda:1').devices == (torch.device('cuda', 1),)
    monkeypatch.setattr(torch.cuda, 'is_available', lambda: True)
    monkeypatch.setattr(torch.cuda, 'device_count', lambda: 2)
    assert default_mesh('cuda').devices == (torch.device('cuda', 0), torch.device('cuda', 1))


def test_shard_rays_collects_on_the_first_shard(rng, monkeypatch):
    """The chunks follow the mesh's devices in order, repeats included; the
    joined output lies on the mesh's first device; a table passed again is
    not replicated again."""
    (chunks,), n = place_ray_arrays([torch.arange(10.0)], 0, Mesh(('meta', 'cpu', 'meta', 'cpu')))
    assert n == 10 and [c.device.type for c in chunks] == ['meta', 'cpu', 'meta', 'cpu']
    copies = []
    monkeypatch.setattr(t_mesh, 'replicate', lambda v, m=None: copies.append(1) or replicate(v, m))
    mesh = Mesh(('cpu',) * 3)
    sharded = shard_rays(lambda x, t: x * t.sum(), mesh, ray_axis_argnums=(0,))
    x, table = torch.as_tensor(rng.normal(size=7)), torch.arange(4.0)
    for _ in range(3):
        got = sharded(x, table)
        assert got.device == mesh.devices[0] and torch.equal(got, x * 6.0)
    assert len(copies) == 1


def test_pad_to_multiple():
    p, n = pad_to_multiple(np.arange(10), 8)
    assert p.shape[0] == 16 and n == 10 and (p[10:] == 9).all()
    p2, n2 = pad_to_multiple(np.arange(16), 8)
    assert p2.shape[0] == 16 and n2 == 16
    t, n3 = pad_to_multiple(torch.arange(12.0).reshape(2, 6), 4, axis=1)
    assert n3 == 6 and tuple(t.shape) == (2, 8)
    assert torch.equal(t[:, 6:], torch.tensor([[5.0, 5.0], [11.0, 11.0]]))


def test_place_ray_arrays_splits_contiguous_chunks():
    mesh = get_mesh(devices=CPU8)
    a = torch.arange(3 * 21.0).reshape(3, 21)
    (chunks,), n = place_ray_arrays([a], 1, mesh)
    assert n == 21 and len(chunks) == 8
    assert all(tuple(c.shape) == (3, 3) and c.is_contiguous() for c in chunks)
    joined = torch.cat(chunks, dim=1)
    assert torch.equal(joined[:, :21], a) and (joined[:, 21:] == a[:, -1:]).all()
    np.testing.assert_array_equal(gather_rays(chunks, 21, mesh, dim=1), a.numpy())
    reps = replicate((a, a[0]), mesh)
    assert len(reps) == 8 and all(r[0] is reps[0][0] for r in reps)


def test_shard_rays_matches_single_device(rng):
    cube = torch.as_tensor(rng.normal(size=(5, 6, 7)))
    pts = torch.as_tensor(rng.uniform(0, 4, size=(1003, 3)))

    def fn(pts, cube):
        iy = pts[:, 0].long().clamp(0, 4)
        return cube.reshape(-1)[iy * 42 + 3] * pts[:, 1] + pts[:, 2], pts[:, 0] * 2

    a, b = shard_rays(fn, get_mesh(devices=CPU8), ray_axis_argnums=(0,))(pts, cube)
    ea, eb = fn(pts, cube)
    assert a.shape[0] == 1003 and torch.equal(a, ea) and torch.equal(b, eb)


def test_sharded_raytrace_integration(rng):
    """The packed integrate sharded over rays equals the unsharded one bit
    for bit (each ray's sum is its own)."""
    from raider_tpu_torch.delay.raytrace import integrate_rays

    nz, ny, nx = 8, 16, 16
    zs = np.linspace(0.0, 8000.0, nz)
    ys = np.linspace(30, 36, ny)
    xs = np.linspace(-120, -114, nx)
    cube_w = torch.as_tensor(rng.uniform(1, 100, (nz, ny, nx)))
    cube_h = torch.as_tensor(rng.uniform(100, 300, (nz, ny, nx)))
    n_rays, n_lev = 200, 4
    bnd_y = rng.uniform(31, 35, (1, n_rays)) + 0.01 * np.arange(n_lev + 1)[:, None]
    bnd_x = rng.uniform(-119, -115, (1, n_rays)) + 0.01 * np.arange(n_lev + 1)[:, None]
    bnd_z = np.broadcast_to(zs[:n_lev + 1, None], (n_lev + 1, n_rays)) + 1.0
    ray_len = np.full((n_lev, n_rays), 1200.0)
    d2 = np.full((n_lev, n_rays), 500.0**2)
    re = np.full(n_rays, 6371000.0)
    args = [torch.as_tensor(np.ascontiguousarray(a)) for a in (bnd_y, bnd_x, bnd_z, d2,
                                                               ray_len)]
    plm = ray_len.max(axis=1)
    w1, h1 = integrate_rays(cube_w, cube_h, ys, xs, zs, *args, torch.as_tensor(re), plm)

    def fn(by_t, bx_t, bz_t, d2_t, rl_t, re_s, cw, ch):
        return integrate_rays(cw, ch, ys, xs, zs, by_t.T, bx_t.T, bz_t.T, d2_t.T, rl_t.T,
                              re_s, plm)

    sharded = shard_rays(fn, get_mesh(devices=CPU8), ray_axis_argnums=(0, 1, 2, 3, 4, 5))
    w2, h2 = sharded(*(a.T for a in args), torch.as_tensor(re), cube_w, cube_h)
    assert torch.equal(w1, w2) and torch.equal(h1, h2)


def _port(ds, los, dtype, mesh, out_proj=4326):
    out, _ = t_engine.tropo_delay(T0, ds, BoundingBox(BBOX, cube_spacing_in_m=5000.0), los,
                                  height_levels=HEIGHTS, compute_dtype=dtype, device='cpu',
                                  mesh=mesh, out_proj=out_proj)
    return out


def _los(kind):
    return Zenith() if kind == 'zenith' else Raytracing(
        orbit=orbit_from_reference(synthetic_orbit(T0)), time=T0)


@pytest.mark.parametrize('los, out_proj', [('zenith', 4326), ('zenith', 32611),
                                           ('raytracing', 4326)])
@pytest.mark.parametrize('dtype', [np.float64, np.float32])
def test_sharded_tropo_delay_is_bit_identical(wm_dataset, los, dtype, out_proj, monkeypatch):
    """Zenith (separable contractions, or the gather on a UTM output grid)
    and raytraced cubes on an 8-shard mesh: the unsharded cubes, bit for bit."""
    ds = dataset_from_reference(wm_dataset)
    # separable blocks of 2 of the 13 rows: 7 blocks over the 8 shards
    monkeypatch.setattr(t_engine, 'ZENITH_ROW_BLOCK', 2)
    one = _port(ds, _los(los), dtype, None, out_proj)
    splits, blocks = [], []

    def counted(place):
        def split(arrays, ray_axis, mesh=None):
            splits.append(len(arrays))
            return place(arrays, ray_axis, mesh)
        return split

    def counted_block(cube, w_y, w_x):
        blocks.append(w_y.shape[0])
        return contract_yx(cube, w_y, w_x)
    monkeypatch.setattr(t_engine, 'place_ray_arrays', counted(place_ray_arrays))
    monkeypatch.setattr(t_mesh, 'place_ray_arrays', counted(place_ray_arrays))
    monkeypatch.setattr(t_engine, 'contract_yx', counted_block)
    eight = _port(ds, _los(los), dtype, get_mesh(devices=CPU8), out_proj)
    if los == 'raytracing':          # each slice's rays and radii (shard_rays)
        assert splits == [6] * len(HEIGHTS) and not blocks, splits
    elif out_proj == 4326:           # 7 row blocks a field (wet, hydro)
        assert blocks == [2] * 6 + [1] + [2] * 6 + [1] and not splits, blocks
    else:                            # the gather path splits its rows once
        assert splits == [2] and not blocks, splits
    for name in ('wet', 'hydro'):
        a, b = np.asarray(eight[name].data), np.asarray(one[name].data)
        assert a.shape == b.shape and np.isfinite(a).all()
        np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize('los', ['zenith', 'raytracing'])
@pytest.mark.parametrize('dtype', [np.float64, np.float32])
def test_sharded_tropo_delay_matches_jax(wm_dataset, los, dtype):
    """The port on 8 CPU shards against the JAX engine sharding the same
    request over the 8 virtual CPU devices of tests/conftest.py."""
    assert len(jax.devices()) == 8
    orbit = synthetic_orbit(T0)
    j_los = JZen() if los == 'zenith' else JRay(orbit=orbit, time=T0)
    ref, _ = j_engine.tropo_delay(T0, wm_dataset, JBox(BBOX, cube_spacing_in_m=5000.0), j_los,
                                  height_levels=HEIGHTS, compute_dtype=dtype)
    out = _port(dataset_from_reference(wm_dataset), _los(los), dtype, get_mesh(devices=CPU8))
    for name in ('wet', 'hydro'):
        a, b = np.asarray(out[name].data), np.asarray(ref[name].data)
        assert a.shape == b.shape and np.isfinite(a).all()
        assert np.max(np.abs(a - b)) <= TOL[dtype]


def test_device_get_global_without_a_group():
    t = torch.arange(6.0).reshape(3, 2)
    got = device_get_global({'a': t, 'b': (t[0], 2.0)})
    np.testing.assert_array_equal(got['a'], t.numpy())
    assert isinstance(got['b'], tuple) and got['b'][1] == 2.0


_WORKER = os.path.join(os.path.dirname(os.path.abspath(__file__)), '_torch_dist_worker.py')


def test_two_process_group():
    """Two processes in a gloo group (``initialize_distributed``): each
    gathers the other's part of a batch (``device_get_global``, unequal
    lengths), runs a ray-sharded and a z-slab ``tropo_delay`` on a 2-shard
    CPU mesh of its own (4 shards and 4 slabs in all), and prints digests;
    both must agree with each other and with a one-process run. The workers
    import torch and the port only."""
    with socket.socket() as s:
        s.bind(('localhost', 0))
        port = s.getsockname()[1]
    env = {k: v for k, v in os.environ.items() if k not in ('XLA_FLAGS',)}
    env['PYTHONPATH'] = REPO
    procs = [subprocess.Popen([sys.executable, _WORKER, str(i), '2', str(port)],
                              stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
                              env=env, cwd=REPO)
             for i in range(2)]
    outs = []
    try:
        for p in procs:
            outs.append(p.communicate(timeout=120)[0])
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
    for i, (p, out) in enumerate(zip(procs, outs)):
        assert p.returncode == 0, f'worker {i} failed:\n{out[-3000:]}'
    lines = [[ln for ln in out.splitlines() if ln.startswith('DIST ')] for out in outs]
    assert len(lines[0]) == len(lines[1]) == 4, outs
    assert lines[0] == lines[1], lines
    single = subprocess.run([sys.executable, _WORKER, '0', '1', '0'], capture_output=True,
                            text=True, env=env, cwd=REPO, timeout=120)
    assert single.returncode == 0, single.stdout[-3000:] + single.stderr[-3000:]
    one = [ln for ln in single.stdout.splitlines() if ln.startswith('DIST ')]
    # the gathered batch and the ray-sharded cubes are the one-process ones
    # bit for bit; the z-slab sums differ only in their order
    assert one[:3] == lines[0][:3], (one, lines[0])
    a = np.array(lines[0][3].split()[2:], dtype=float)
    b = np.array(one[3].split()[2:], dtype=float)
    np.testing.assert_allclose(a, b, rtol=2e-6)
