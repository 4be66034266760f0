"""Device meshes and ray batches sharded over them.

Counterpart of ``raider_tpu/parallel/mesh.py``. The JAX mesh is one
controller driving several devices through SPMD programs; here a
:class:`Mesh` is a tuple of ``torch.device`` s with the single axis
``'rays'``, and a sharded call runs its function once per shard, each on its
own device, the ray axis split into contiguous equal chunks (edge-padded to
a multiple of the shard count). The weather cube (the table) is replicated,
once per distinct device; no collective is needed until the outputs are
gathered. A mesh may name a device more than once: the shards then run one
after another on it (the CPU tests and a one-card run use 4 or 8 logical
shards that way).

Across processes, :func:`initialize_distributed` starts a
``torch.distributed`` group (NCCL for CUDA, gloo for the CPU) and
:func:`device_get_global` gathers each process's part of a result.
"""

import math
from typing import Callable, Optional, Sequence

import numpy as np
import torch

RAY_AXIS = 'rays'


class Mesh:
    """A 1-D mesh: one ``torch.device`` a shard, the axis ``'rays'``."""

    axis_names = (RAY_AXIS,)

    def __init__(self, devices: Sequence) -> None:
        self.devices = tuple(torch.device(d) for d in devices)
        if not self.devices:
            raise ValueError('a mesh needs at least one device')

    @property
    def size(self) -> int:
        return len(self.devices)

    @property
    def distinct(self) -> tuple:
        """The mesh's devices, each once, in order of first appearance."""
        return tuple(dict.fromkeys(self.devices))

    def __repr__(self) -> str:
        return f'Mesh({", ".join(str(d) for d in self.devices)})'


def get_mesh(n_devices: Optional[int] = None, devices: Optional[Sequence] = None) -> Mesh:
    """A mesh over ``devices`` (which may repeat a device), else over the
    first ``n_devices`` CUDA devices (all of them by default). Without a
    CUDA device and without ``devices`` it raises."""
    if devices is None:
        n_cuda = torch.cuda.device_count() if torch.cuda.is_available() else 0
        if n_cuda == 0:
            raise RuntimeError('get_mesh: no CUDA device; pass devices=(...) to build a mesh '
                               'of other devices')
        devices = [torch.device('cuda', i) for i in range(n_cuda)]
    devices = list(devices)
    n = n_devices or len(devices)
    if n > len(devices):
        raise ValueError(f'get_mesh: {n} devices asked for, {len(devices)} available')
    return Mesh(devices[:n])


def default_mesh(device) -> Mesh:
    """The mesh an entry point uses when the caller names none: every CUDA
    device for a bare ``'cuda'``, else ``device`` alone (``'cuda:1'``, the
    CPU)."""
    device = torch.device(device)
    if device.type == 'cuda' and device.index is None:
        return get_mesh()
    return Mesh((device,))


def initialize_distributed(coordinator_address: Optional[str] = None,
                           num_processes: Optional[int] = None,
                           process_id: Optional[int] = None,
                           device='cuda') -> None:
    """Join a multi-process group (``torch.distributed``: NCCL when
    ``device`` is CUDA, gloo otherwise) at ``coordinator_address``
    (``host:port`` or ``tcp://host:port``); a no-op for at most one
    process."""
    if num_processes is None or num_processes <= 1:
        return
    import torch.distributed as dist

    if dist.is_initialized():
        return
    addr = coordinator_address or 'localhost:29500'
    if '://' not in addr:
        addr = 'tcp://' + addr
    backend = 'nccl' if torch.device(device).type == 'cuda' else 'gloo'
    dist.init_process_group(backend, init_method=addr, world_size=int(num_processes),
                            rank=int(process_id or 0))


def process_group_size() -> int:
    """The number of processes of the ``torch.distributed`` group (1 when
    none is up)."""
    import torch.distributed as dist

    return dist.get_world_size() if dist.is_available() and dist.is_initialized() else 1


def pad_to_multiple(arr, multiple: int, axis: int = 0):
    """Edge-pad ``axis`` of a numpy array or tensor up to a multiple of
    ``multiple``. Returns (padded, original_length)."""
    n = arr.shape[axis]
    target = math.ceil(n / multiple) * multiple
    if target == n:
        return arr, n
    if isinstance(arr, torch.Tensor):
        last = arr.narrow(axis, n - 1, 1)
        reps = [1] * arr.ndim
        reps[axis] = target - n
        return torch.cat([arr, last.repeat(*reps)], dim=axis), n
    widths = [(0, 0)] * arr.ndim
    widths[axis] = (0, target - n)
    return np.pad(arr, widths, mode='edge'), n


def process_rank() -> int:
    """This process's rank in the ``torch.distributed`` group (0 when none
    is up)."""
    import torch.distributed as dist

    return dist.get_rank() if process_group_size() > 1 else 0


def place_ray_arrays(arrays, ray_axis, mesh: Optional[Mesh] = None):
    """Split each array's ray axis (``ray_axis``: one for all arrays, or a
    sequence of one a array) over the mesh: edge-padded to a multiple of the
    shard count, cut into contiguous equal chunks, chunk d on shard d's
    device. Under a process group of more than one process the shards are
    those of every process's mesh in rank order (the same mesh size on
    each), and this process gets its own. Returns (one list of chunks per
    array, original length)."""
    mesh = mesh or get_mesh()
    first, total = process_rank() * mesh.size, process_group_size() * mesh.size
    axes = [ray_axis] * len(arrays) if isinstance(ray_axis, int) else list(ray_axis)
    placed, orig_n = [], None
    for a, axis in zip(arrays, axes):
        a = a if isinstance(a, torch.Tensor) else torch.as_tensor(np.asarray(a))
        a, n = pad_to_multiple(a, total, axis=axis)
        orig_n = n if orig_n is None else orig_n
        chunks = torch.chunk(a, total, dim=axis)[first:first + mesh.size]
        placed.append([c.to(dev).contiguous() for c, dev in zip(chunks, mesh.devices)])
    return placed, orig_n


def gather_rays(outs, n: int, mesh: Optional[Mesh] = None, dim: int = 0) -> np.ndarray:
    """The per-shard outputs of :func:`place_ray_arrays`' chunks, joined
    along ``dim`` in shard order, fetched through :func:`device_get_global`
    (so every process gets the whole) and trimmed to ``n``: host numpy."""
    local = _join(outs, (mesh or get_mesh()).devices[0], dim)
    if process_group_size() <= 1:
        return device_get_global(local.narrow(dim, 0, n))
    return np.moveaxis(device_get_global(local.movedim(dim, 0))[:n], 0, dim)


def _join(outs, device, dim: int = 0) -> torch.Tensor:
    """The tensors ``outs`` concatenated along ``dim`` on ``device`` (one
    tensor alone is not copied)."""
    if len(outs) == 1:
        return outs[0].to(device)
    return torch.cat([o.to(device) for o in outs], dim=dim)


def replicate(value, mesh: Optional[Mesh] = None) -> list:
    """``value`` (a tensor, or a tuple or list of them) on every shard's
    device: one copy per distinct device, shared by the shards on it."""
    mesh = mesh or get_mesh()
    copies = {dev: _to(value, dev) for dev in mesh.distinct}
    return [copies[dev] for dev in mesh.devices]


def _to(value, device):
    if isinstance(value, torch.Tensor):
        return value.to(device)
    if isinstance(value, (tuple, list)):
        return type(value)(_to(v, device) for v in value)
    return value


def shard_rays(fn: Callable, mesh: Optional[Mesh] = None, ray_axis_argnums=()) -> Callable:
    """Wrap a ray-batched function so the arguments in ``ray_axis_argnums``
    (positions, split along axis 0, or a dict of position to ray axis)
    split over the mesh and every other argument is replicated. ``fn`` runs
    once per shard on its device; the outputs (a tensor or a tuple of them,
    the ray axis leading) are joined on the mesh's first device and trimmed
    of the padding (under a process group of more than one process,
    gathered from every process first). A tensor argument passed again (the
    same object, say a table) is replicated only on its first call."""
    mesh = mesh or get_mesh()
    axes = (dict(ray_axis_argnums) if isinstance(ray_axis_argnums, dict)
            else dict.fromkeys(ray_axis_argnums, 0))
    replicas = {}

    def replicated(a):
        if not isinstance(a, (torch.Tensor, tuple, list)):
            return [a] * mesh.size
        if id(a) not in replicas or replicas[id(a)][0] is not a:
            replicas[id(a)] = (a, replicate(a, mesh))
        return replicas[id(a)][1]

    def join(outs, n):
        if isinstance(outs[0], (tuple, list)):
            return type(outs[0])(join([o[k] for o in outs], n) for k in range(len(outs[0])))
        if process_group_size() > 1:
            return torch.as_tensor(gather_rays(outs, n, mesh)).to(mesh.devices[0])
        return _join(outs, mesh.devices[0])[:n]

    def call(*args):
        sharded = [i for i in range(len(args)) if i in axes]
        if not sharded:
            return fn(*args)
        chunks, orig_n = place_ray_arrays([args[i] for i in sharded], [axes[i] for i in sharded],
                                          mesh)
        per_arg = dict(zip(sharded, chunks))
        reps = {i: replicated(a) for i, a in enumerate(args) if i not in per_arg}
        outs = [fn(*(per_arg[i][d] if i in per_arg else reps[i][d] for i in range(len(args))))
                for d in range(mesh.size)]
        return join(outs, orig_n)

    return call


def device_get_global(tree):
    """Host numpy copies of a tensor or a tuple, list or dict of them.

    With a ``torch.distributed`` group of more than one process up, each
    leaf is this process's part along axis 0: the parts are all-gathered in
    rank order (padded to the longest, then trimmed), so every process gets
    the whole; otherwise a plain copy to the host."""
    if isinstance(tree, dict):
        return {k: device_get_global(v) for k, v in tree.items()}
    if isinstance(tree, (tuple, list)):
        return type(tree)(device_get_global(v) for v in tree)
    if not isinstance(tree, torch.Tensor):
        return np.asarray(tree)
    if process_group_size() <= 1:
        return tree.detach().cpu().numpy()
    import torch.distributed as dist

    x = tree.detach().contiguous()
    if x.ndim == 0:
        x = x.reshape(1)
    world = dist.get_world_size()
    n = torch.tensor([x.shape[0]], dtype=torch.int64, device=x.device)
    sizes = [torch.zeros_like(n) for _ in range(world)]
    dist.all_gather(sizes, n)
    sizes = [int(s) for s in sizes]
    m = max(sizes)
    if x.shape[0] < m:
        x = torch.cat([x, x.new_zeros((m - x.shape[0],) + tuple(x.shape[1:]))])
    parts = [torch.empty_like(x) for _ in range(world)]
    dist.all_gather(parts, x)
    return torch.cat([p[:s] for p, s in zip(parts, sizes)]).cpu().numpy()
