"""Z-slab tables: the raytrace integrate for tables past one device's memory.

Counterpart of ``raider_tpu/parallel/zshard.py``. Ray sharding
(``parallel.mesh``) replicates the packed table; this module splits it
instead: the table's rows, which are z-anchor cells, go in contiguous
z-slabs over the mesh, every shard walks the whole ray batch against its
slab with each sample's contribution masked to the z cells it owns, and the
partial integrals are summed. Every pack16 / pack16_i16 sample reads one
row (its z-anchor cell; both z corners ride the row), so the slabs
partition the samples: each sample is added by exactly one shard. pack4
rows also read the anchor plane above, so its slabs carry one halo plane.
The NaN rule holds: the owner adds the sample the unsharded integrate adds,
NaN included, every other shard adds 0.

The sum differs from the unsharded one only in its order (each shard keeps
the unsharded walk's order; the partials are added in shard order on the
first device, so the result is the same on every run). This is a capacity
mode, not a speed-up: every shard still walks all samples.

The packed modes are plain torch (XLA in the JAX package, no Pallas
kernel): a slab is integrated by ``delay.raytrace._integrate_packed`` with
its ``slab`` bounds.
"""

from typing import Optional

import numpy as np
import torch

from raider_tpu_torch.constants import MAX_SEGMENT_LENGTH
from raider_tpu_torch.delay.raytrace import (_PLAN_BUCKET, _integrate_packed, _pack_cubes,
                                             _pad_point_plan, _quantized_pair,
                                             build_sampling_plan)
from raider_tpu_torch.parallel.mesh import Mesh, get_mesh, process_group_size

_Z_MODES = ('pack16', 'pack16_i16', 'pack4')


def zshard_auto(cube_shape, dtype, pack_mode: str, n_dev: int, force: Optional[bool] = None,
                budget_gb: float = 10.0) -> bool:
    """Whether the engine takes the z-slab path for this cube.

    ``force`` True takes it on any mesh of more than one shard, False never;
    by default it is taken when the replicated packed table would exceed
    ``budget_gb`` (the JAX package's default of 10 GB, so that both packages
    choose alike). Brick modes never take it."""
    if force is False or pack_mode not in _Z_MODES or n_dev <= 1:
        return False
    if force:
        return True
    itemsize = (dtype.itemsize if isinstance(dtype, torch.dtype)
                else np.dtype(dtype).itemsize)
    bytes_per_cell = {'pack16': 16 * itemsize, 'pack16_i16': 32,
                      'pack4': 4 * itemsize}[pack_mode]
    return int(np.prod(cube_shape)) * bytes_per_cell > budget_gb * 1e9


def _slab_bounds(n_cells: int, n_dev: int):
    """Contiguous anchor-cell slabs [lo_d, hi_d) covering [0, n_cells)."""
    edges = np.linspace(0, n_cells, n_dev + 1).round().astype(np.int64)
    return edges[:-1], edges[1:]


def _slab_range(n_dev: int):
    """The slabs this process holds, of how many: with a process group up,
    rank r holds slabs [r * n_dev, (r + 1) * n_dev) of world * n_dev."""
    world = process_group_size()
    if world <= 1:
        return 0, n_dev
    import torch.distributed as dist

    return dist.get_rank() * n_dev, world * n_dev


def pack_cube_slabs(cube_wet, cube_hydro, mode: str, n_dev: int, mesh: Optional[Mesh] = None):
    """The z-slab tables of ``n_dev`` shards.

    Slab d holds the rows of z anchors [lo_d, hi_d) (plus one halo anchor
    plane for pack4), packed from the cubes' planes [lo_d, hi_d + 1 (+1))
    by the port's ``_pack_cubes``; the int16 mode quantizes each whole
    field once (one global ``deq`` = [sw, ow, sh, oh]). Slab d goes to
    ``mesh.devices[d]`` (the cubes' device without a mesh). Returns
    (tables, z_lo, z_hi, deq): a list of tables, the (n_dev,) int64 slab
    bounds, and deq (None but for pack16_i16). Under a process group of
    more than one process the slabs are the process's share of
    world * n_dev."""
    if mode not in _Z_MODES:
        raise ValueError(f'z-shard supports {_Z_MODES}, not {mode!r}')
    if mesh is not None and mesh.size != n_dev:
        raise ValueError(f'pack_cube_slabs: {n_dev} slabs for a mesh of {mesh.size} shards')
    nz, ny, nx = cube_wet.shape
    deq = None
    pack_mode = mode
    if mode == 'pack16_i16':
        cube_wet, cube_hydro, deq = _quantized_pair(cube_wet, cube_hydro)
        pack_mode = 'pack16'
    first, total = _slab_range(n_dev)
    # anchors lie in [0, nz - 2] after the locate clipping: slab those cells
    lo, hi = _slab_bounds(nz - 1, total)
    lo, hi = lo[first:first + n_dev], hi[first:first + n_dev]
    halo = 1 if mode == 'pack4' else 0
    tables = []
    for d in range(n_dev):
        # the rows of anchors lo..hi-1 (+halo) need cube planes lo..hi (+halo)
        top = min(int(hi[d]) + 1 + halo, nz)
        t = _pack_cubes(cube_wet[int(lo[d]):top], cube_hydro[int(lo[d]):top], pack_mode)
        t = t[:(int(hi[d]) - int(lo[d]) + halo) * ny * nx]
        tables.append(t if mesh is None else t.to(mesh.devices[d]))
    return tables, lo, hi, deq


def integrate_rays_z_sharded(cube_wet, cube_hydro, ys, xs, zs,
                             bnd_y, bnd_x, bnd_z, d2, ray_len, re_local,
                             ray_lengths_max,
                             max_segment_length: float = MAX_SEGMENT_LENGTH,
                             z_clip: bool = True, mode: str = 'pack16',
                             mesh: Optional[Mesh] = None, packed=None):
    """The packed-mode integrate of one slice with the table in z-slabs.

    Same sampling as ``delay.raytrace.integrate_rays`` in 'pack16',
    'pack16_i16' or 'pack4'. The rays go to each distinct device of the
    mesh once, each shard integrates its slab (``_integrate_packed`` with
    the slab's bounds), and the partials are summed in shard order on the
    first shard's device; under a process group of more than one process,
    one ``all_reduce`` then adds the processes' sums. ``packed`` takes a
    :func:`pack_cube_slabs` result so that a slice loop packs once.
    Without ``packed`` the slabs are packed for ``mesh`` (by default
    every CUDA device). Returns (wet (N,), hydro (N,)) on the first shard's
    device."""
    if packed is None:
        mesh = mesh or get_mesh()
        packed = pack_cube_slabs(cube_wet, cube_hydro, mode, mesh.size, mesh=mesh)
    tables, z_lo, z_hi, deq = packed
    cdt = deq.dtype if deq is not None else tables[0].dtype
    plan = _pad_point_plan(build_sampling_plan(np.asarray(ray_lengths_max), max_segment_length),
                           _PLAN_BUCKET)
    rays = [a.to(cdt) for a in (bnd_y, bnd_x, bnd_z, d2, ray_len, re_local)]
    on = {}
    total = None
    for table, lo, hi in zip(tables, z_lo, z_hi):
        dev = table.device
        if dev not in on:
            on[dev] = ([a.to(dev) for a in rays], None if deq is None else deq.to(dev))
        r, q = on[dev]
        w, h = _integrate_packed(table, *r, *plan, ys, xs, zs, z_clip=z_clip, mode=mode,
                                 deq=q, slab=(int(lo), int(hi)))
        part = torch.stack([w, h])
        total = part if total is None else total + part.to(total.device)
    if process_group_size() > 1:
        import torch.distributed as dist

        dist.all_reduce(total)
    return total[0], total[1]
