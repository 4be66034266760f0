"""Build and launch layer for the hand-written CUDA kernels in ``csrc/``.

The ``.cu`` sources expose a plain C interface. At first use each source
is compiled by its own ``nvcc`` for sm_90a, all started together, and the
objects are linked into one shared library under ``<repo>/build/kernels/``,
named by a hash of the sources and flags, and loaded with ``ctypes``: no
PyTorch headers, so a build takes seconds.

Each launcher takes device pointers and torch's current stream, allocates
nothing, and returns ``cudaGetLastError()``; a non-zero code raises here.
``LAUNCHES`` counts the launches of each kernel (one per launcher call that
reached the kernel), so a caller can show that a run went through them.
The first build and load, and each count, hold a lock: the calc-delays
workflow launches B1 from its prefetch thread while the main thread
launches B2.
``nvcc`` runs with ``-Xptxas -v``; :func:`ptxas_resources` reads each
kernel's registers and spills from the build's log.
"""

import ctypes
import hashlib
import os
import re
import shutil
import subprocess
import threading
import time
from pathlib import Path

import numpy as np
import torch

CSRC = Path(__file__).resolve().parent.parent / 'csrc'
BUILD_DIR = Path(__file__).resolve().parents[2] / 'build' / 'kernels'
NVCC_FLAGS = ['-gencode', 'arch=compute_90a,code=sm_90a', '-std=c++17', '-O3',
              '-Xcompiler', '-fPIC', '-Xptxas', '-v']

# Shared memory of one Hopper SM (sm_90): what a block may take as dynamic
# shared memory, what an SM holds, and what the runtime keeps per resident block
SMEM_BLOCK_MAX = 232_448
SMEM_SM = 233_472
SMEM_BLOCK_RESERVED = 1_024
# kernels B2/K4 (csrc/brick_integrate.cu): warps a block (up to its launch
# bound of 512 threads) and the resident warps an SM past which registers,
# not shared memory, decide the occupancy
BRICK_WARPS = (4, 8, 16)
BRICK_TARGET_WARPS = 32
# planes a brick row may have in B2/K4: the ring's slot map keeps 2 bits a plane
BRICK_MAX_PLANES = 16

LAUNCHES = {'ztd_totals': 0, 'brick_integrate': 0, 'brick_integrate_i16': 0,
            'window_integrate': 0, 'probe_load': 0, 'probe_bitcast_i16_bf16': 0,
            'brick_contract': 0, 'brick_group_rows': 0, 'brick_group_merged': 0}

# element types of the S4 probe, by the suffix of their launcher
PROBE_DTYPES = {'bf16': torch.bfloat16, 'f16': torch.float16, 'i16': torch.int16}

_lib = None
_LIB_LOCK = threading.Lock()     # the first build and load of the library
_COUNT_LOCK = threading.Lock()   # LAUNCHES
build_seconds = None   # wall time of the build in this process (None: loaded a cached .so)
BUILD_LOG = {}         # nvcc's messages per source, from the build in this process


def reset_launch_counts() -> None:
    with _COUNT_LOCK:
        for k in LAUNCHES:
            LAUNCHES[k] = 0


def _count(name: str) -> None:
    with _COUNT_LOCK:
        LAUNCHES[name] += 1


def _sources():
    return sorted(CSRC.glob('*.cu')) + sorted(CSRC.glob('*.cuh'))


def _nvcc() -> str:
    for cand in (shutil.which('nvcc'),
                 os.path.join(os.environ.get('CUDA_HOME', '/usr/local/cuda'), 'bin', 'nvcc')):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError('nvcc not found (PATH or $CUDA_HOME/bin): cannot build the CUDA kernels')


def library_path() -> Path:
    h = hashlib.sha256(' '.join(NVCC_FLAGS).encode())
    for src in _sources():
        h.update(src.name.encode())
        h.update(src.read_bytes())
    return BUILD_DIR / f'libraider_kernels_{h.hexdigest()[:16]}.so'


def build() -> Path:
    """Compile ``csrc/*.cu`` into the hashed library unless it exists: one
    ``nvcc -c`` per source, all running at once, then one link."""
    global build_seconds
    out = library_path()
    if out.exists():
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    nvcc = _nvcc()
    tag = f'{out.stem}.{os.getpid()}.{threading.get_ident()}'
    t0 = time.perf_counter()
    jobs = []
    for src in sorted(CSRC.glob('*.cu')):
        obj = BUILD_DIR / f'{src.stem}.{tag}.o'
        jobs.append((src, obj, subprocess.Popen([nvcc, *NVCC_FLAGS, '-c', '-o', str(obj), str(src)],
                                                stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                                                text=True)))
    errors = []
    for src, _, proc in jobs:
        _, err = proc.communicate()
        BUILD_LOG[src.name] = err
        if proc.returncode != 0:
            errors.append(f'{src.name} ({proc.returncode}):\n{err}')
    tmp = out.with_suffix(f'.{tag}.tmp')
    try:
        if errors:
            raise RuntimeError('nvcc failed: ' + '\n'.join(errors))
        res = subprocess.run([nvcc, *NVCC_FLAGS, '-shared', '-o', str(tmp),
                              *[str(obj) for _, obj, _ in jobs]], capture_output=True, text=True)
        if res.returncode != 0:
            raise RuntimeError(f'nvcc link failed ({res.returncode}):\n{res.stderr}')
        os.replace(tmp, out)
    finally:
        for path in [obj for _, obj, _ in jobs] + [tmp]:
            path.unlink(missing_ok=True)
    build_seconds = time.perf_counter() - t0
    return out


def ptxas_resources(source: str) -> dict:
    """Per kernel function of ``source`` (its mangled name), the registers,
    spill stores/loads and stack bytes that ``ptxas -v`` reported in this
    process's build; empty when the library came from the cache."""
    res, fn = {}, None
    for line in BUILD_LOG.get(source, '').splitlines():
        m = re.search(r'Function properties for (\S+)', line)
        if m:
            fn = m.group(1)
            continue
        m = re.search(r'(\d+) bytes stack frame, (\d+) bytes spill stores, (\d+) bytes spill loads',
                      line)
        if m and fn is not None:
            res.setdefault(fn, {}).update(stack=int(m.group(1)), spill_stores=int(m.group(2)),
                                          spill_loads=int(m.group(3)))
        m = re.search(r'Used (\d+) registers', line)
        if m and fn is not None:
            res.setdefault(fn, {})['registers'] = int(m.group(1))
    return res


def brick_plan_bytes(n_groups: int, G: int) -> int:
    """Shared bytes of kernel B2/K4's plan: 10 words a slot and an anchor a
    group, rounded up to 16."""
    return -(-(n_groups * G * 40 + n_groups * 4) // 16) * 16


def brick_slot_bytes(wy: int, wx: int, itemsize: int) -> int:
    """Shared bytes of one ray's ring in B2/K4: four brick planes of wy x wx
    (wet, hydro) pairs, padded to an odd number of pairs."""
    return (4 * wy * wx + 1) * 2 * itemsize


def brick_launch_shape(wy: int, wx: int, itemsize: int, G: int, n_groups: int) -> tuple:
    """(threads a block, dynamic shared bytes a block) of kernel B2 (itemsize
    4) or K4 (itemsize 2) for a plan of ``n_groups`` x ``G`` slots.

    A block holds the plan and, per warp, the rings of its 32 rays. Of
    ``BRICK_WARPS`` it takes the block size that keeps the most warps
    resident on an SM by shared memory (counted up to
    ``BRICK_TARGET_WARPS``; the smaller block on a tie). Raises ValueError
    when not even the smallest block fits ``SMEM_BLOCK_MAX``.
    """
    warp_bytes = 32 * brick_slot_bytes(wy, wx, itemsize)
    plan = brick_plan_bytes(n_groups, G)
    best = None
    for w in BRICK_WARPS:
        smem = plan + w * warp_bytes
        if smem > SMEM_BLOCK_MAX:
            break
        resident = min(SMEM_SM // (smem + SMEM_BLOCK_RESERVED) * w, BRICK_TARGET_WARPS)
        if best is None or resident > best[0]:
            best = (resident, 32 * w, smem)
    if best is None:
        raise ValueError(f'brick integrate: a {wy}x{wx} window of {itemsize}-byte values with a '
                         f'{n_groups}x{G} plan needs {plan + BRICK_WARPS[0] * warp_bytes} bytes of '
                         f'shared memory a block, more than {SMEM_BLOCK_MAX}')
    return best[1], best[2]


def lib() -> ctypes.CDLL:
    """The loaded kernel library, built on first use (once, whichever
    thread gets here first)."""
    if _lib is None:
        with _LIB_LOCK:
            if _lib is None:
                _load()
    return _lib


def _load() -> None:
    """Build the library if needed, load it and declare its launchers."""
    global _lib
    so = ctypes.CDLL(str(build()))
    p, i, ll, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong, ctypes.c_float
    so.ztd_totals_launch.argtypes = [p, p, p, p, p, p, i, ll, ll, ll, f, f, f, p]
    so.ztd_totals_launch.restype = i
    so.brick_integrate_launch.argtypes = [
        p,                   # table
        p, p, p, p, p, p,    # bnd_y, bnd_x, bnd_z, d2, ray_len, re
        p, p, p,             # plan_i, plan_f, anchor
        p, p,                # y axis, x axis (non-uniform locate)
        p,                   # out (2, N)
        ll, i, i, i, i, i, i, i,      # n, n_groups, G, planes, wy, wx, ny, nx
        f, f, f, i,          # y lo, hi, step, uniform
        f, f, f, i,          # x lo, hi, step, uniform
        f, f, i,             # z lo, hi, z_clip
        i, ll,               # threads, dynamic shared bytes a block
        p]                   # stream
    so.brick_integrate_launch.restype = i
    so.brick_integrate_i16_launch.argtypes = [
        p,                   # int16 table
        p, p, p, p, p, p,    # bnd_y, bnd_x, bnd_z, d2, ray_len, re
        p, p, p,             # plan_i, plan_f, anchor
        p, p,                # y axis, x axis
        p, p,                # out (2, N), deq [sw, ow, sh, oh]
        ll, i, i, i, i, i, i, i,      # n, n_groups, G, planes, wy, wx, ny, nx
        f, f, f, i,          # y lo, hi, step, uniform
        f, f, f, i,          # x lo, hi, step, uniform
        f, f, i,             # z lo, hi, z_clip
        i, ll,               # threads, dynamic shared bytes a block
        p]                   # stream
    so.brick_integrate_i16_launch.restype = i
    so.brick_contract_launch.argtypes = [p, p, p, p, p, ll, i, i, i, i, p]
    so.brick_contract_launch.restype = i
    so.brick_contract_shape.argtypes = [i, i, i, i, ctypes.POINTER(i), ctypes.POINTER(ll)]
    so.brick_contract_shape.restype = i
    so.brick_group_rows_launch.argtypes = [
        p, p, p, p, p, p, p,  # brickT, by, bx, bz, d2, rl, aux
        p, p, p,              # plan_i, plan_f, out
        ll, i,                # n, S
        f, f, f, f, f, f,     # y lo, hi, x lo, hi, z lo, hi
        f, f, i, i, i, i,     # inv_sy, inv_sx, ny, nx, wy, wx
        p]                    # stream
    so.brick_group_rows_launch.restype = i
    so.brick_group_merged_launch.argtypes = [
        p, p, p, p, p,        # brick, merged, plan_i, plan_f (host), out
        ll, i, i, i, i,       # n, S, width, nb, nl
        f, f, f, f, f, f,     # y lo, hi, x lo, hi, z lo, hi
        f, f, i, i, i, i,     # inv_sy, inv_sx, ny, nx, wy, wx
        p]                    # stream
    so.brick_group_merged_launch.restype = i
    so.brick_group_merged_shape.argtypes = [i, i, i, i, i, i, ctypes.POINTER(i),
                                            ctypes.POINTER(ll)]
    so.brick_group_merged_shape.restype = i
    so.window_integrate_launch.argtypes = [
        p, p, p, p, p,       # lo, hi, d2, ray_len, re
        p,                   # cube (nz, ny, nxp, 2)
        p, p, p, p,          # ay, ax, sched_i, sched_f
        p,                   # out (2, N)
        ll, i, i, i, i, i,   # n, L, n_groups, K, n_fetch, n_slots
        i, i, i, i, i, i,    # wy, wx, tile, ny, nx, nxp
        f, f, f, f,          # y lo, y inv, x lo, x inv
        f, f, i,             # z lo, hi, z_clip
        p]                   # stream
    so.window_integrate_launch.restype = i
    so.window_integrate_config.argtypes = [ctypes.POINTER(i)] * 2
    so.window_integrate_config.restype = i
    so.window_integrate_shape.argtypes = [i, i, i, i, ctypes.POINTER(i), ctypes.POINTER(ll)]
    so.window_integrate_shape.restype = i
    for dt in PROBE_DTYPES:
        fn = getattr(so, f'probe_load_{dt}_launch')
        fn.argtypes = [p, p, ll, p]
        fn.restype = i
    so.probe_bitcast_i16_bf16_launch.argtypes = [p, p, ll, p]
    so.probe_bitcast_i16_bf16_launch.restype = i
    _lib = so


def _check(name: str, code: int) -> None:
    if code != 0:
        raise RuntimeError(f'{name}: CUDA error {code} at launch')


def _stream():
    return ctypes.c_void_p(torch.cuda.current_stream().cuda_stream)


def _ptr(t: torch.Tensor):
    return ctypes.c_void_p(t.data_ptr())


def launch_ztd_totals(t, p, e, dz, wet, hyd, k1, k2, k3, *, stride_z, stride_col) -> None:
    """Kernel B1 on (nz, ny, nx) float32 CUDA cubes t, p, e whose (z, column)
    strides are ``stride_z``, ``stride_col`` (checked by the caller), into
    contiguous wet and hyd. The launcher derives the launch shape and
    refuses a level count that does not fit a block's shared memory."""
    nz = t.shape[0]
    ncol = t.numel() // nz
    code = lib().ztd_totals_launch(_ptr(t), _ptr(p), _ptr(e), _ptr(dz), _ptr(wet), _ptr(hyd),
                                   nz, ncol, stride_z, stride_col, k1, k2, k3, _stream())
    _check('ztd_totals', code)
    _count('ztd_totals')


def launch_brick_integrate(table, bnd_y, bnd_x, bnd_z, d2, ray_len, re, plan_i, plan_f,
                           anchor, y_axis, x_axis, out, deq=None, *, G, planes, wy, wx,
                           y_lo, y_hi, y_step, y_uniform, x_lo, x_hi, x_step, x_uniform,
                           z_lo, z_hi, z_clip, threads, smem) -> None:
    """Kernel B2 on a float32 table, or K4 on an int16 table with ``deq``
    (arguments checked by the caller), in the launch shape ``threads``,
    ``smem`` of :func:`brick_launch_shape`."""
    n = bnd_y.shape[1]
    n_groups = anchor.shape[0]
    ny, nx = y_axis.shape[0], x_axis.shape[0]
    name = 'brick_integrate' if deq is None else 'brick_integrate_i16'
    extra = () if deq is None else (_ptr(deq),)
    code = getattr(lib(), f'{name}_launch')(
        _ptr(table), _ptr(bnd_y), _ptr(bnd_x), _ptr(bnd_z), _ptr(d2), _ptr(ray_len), _ptr(re),
        _ptr(plan_i), _ptr(plan_f), _ptr(anchor), _ptr(y_axis), _ptr(x_axis), _ptr(out),
        *extra, n, n_groups, G, planes, wy, wx, ny, nx,
        y_lo, y_hi, y_step, int(y_uniform), x_lo, x_hi, x_step, int(x_uniform),
        z_lo, z_hi, int(z_clip), threads, smem, _stream())
    _check(name, code)
    _count(name)


def brick_contract_shape(S: int, planes: int, wy: int, wx: int) -> tuple:
    """(threads a block, dynamic shared bytes a block) of kernel K1 for a
    group of ``S`` samples, as its launcher derives them; ValueError for a
    spec the launcher refuses (more than 64 samples, a window past 8x8, or a
    block that does not fit shared memory)."""
    threads, smem = ctypes.c_int(0), ctypes.c_longlong(0)
    code = lib().brick_contract_shape(S, planes, wy, wx, ctypes.byref(threads), ctypes.byref(smem))
    if code != 0:
        raise ValueError(f'brick_contract: no launch shape for {S} samples on a '
                         f'{planes}x{wy}x{wx} brick (CUDA error {code})')
    return threads.value, smem.value


def launch_brick_contract(brick, scal, dzos, out_w, out_h, *, planes, wy, wx) -> None:
    """Kernel K1 on one group (arguments checked by the caller; ``dzos`` the
    samples' z-plane offsets as Python ints, passed with the launch); the
    launcher derives the launch shape and refuses a spec that does not fit."""
    n = brick.shape[0]
    dz = (ctypes.c_int * len(dzos))(*dzos)
    code = lib().brick_contract_launch(_ptr(brick), _ptr(scal), dz, _ptr(out_w), _ptr(out_h),
                                       n, len(dzos), planes, wy, wx, _stream())
    _check('brick_contract', code)
    _count('brick_contract')


def launch_brick_group_rows(brickT, by, bx, bz, d2, rl, aux, plan_i, plan_f, out, *,
                            consts) -> None:
    """Kernel K2 on one group (arguments checked by the caller); ``consts``
    is (y_lo, y_hi, x_lo, x_hi, z_lo, z_hi, inv_sy, inv_sx, ny, nx, wy, wx)."""
    code = lib().brick_group_rows_launch(
        _ptr(brickT), _ptr(by), _ptr(bx), _ptr(bz), _ptr(d2), _ptr(rl), _ptr(aux),
        _ptr(plan_i), _ptr(plan_f), _ptr(out), aux.shape[1], plan_i.shape[0], *consts,
        _stream())
    _check('brick_group_rows', code)
    _count('brick_group_rows')


def brick_group_merged_shape(S: int, width: int, nb: int, nl: int, wy: int, wx: int) -> tuple:
    """(threads a block, dynamic shared bytes a block) of kernel K3 for a
    group of ``S`` samples on a brick of ``width`` floats a ray with ``nb``,
    ``nl`` merged rows, as its launcher derives them; ValueError for what
    the launcher refuses (more than 64 samples, a window past 8x8, or a
    block that does not fit shared memory)."""
    threads, smem = ctypes.c_int(0), ctypes.c_longlong(0)
    code = lib().brick_group_merged_shape(S, width, nb, nl, wy, wx, ctypes.byref(threads),
                                          ctypes.byref(smem))
    if code != 0:
        raise ValueError(f'brick_group_merged: no launch shape for {S} samples, width {width}, '
                         f'nb {nb}, nl {nl}, a {wy}x{wx} window (CUDA error {code})')
    return threads.value, smem.value


def launch_brick_group_merged(brick, merged, plan_i, plan_f, out, *, nb, nl, consts) -> None:
    """Kernel K3 on one group (arguments checked by the caller; ``plan_i``
    int32 (S, 4) and ``plan_f`` float32 (S, 6) host arrays, passed with the
    launch); the launcher derives the launch shape and refuses what does
    not fit."""
    pi = np.ascontiguousarray(plan_i, dtype=np.int32)
    pf = np.ascontiguousarray(plan_f, dtype=np.float32)
    code = lib().brick_group_merged_launch(
        _ptr(brick), _ptr(merged), pi.ctypes.data_as(ctypes.c_void_p),
        pf.ctypes.data_as(ctypes.c_void_p), _ptr(out), brick.shape[0], pi.shape[0],
        brick.shape[1], nb, nl, *consts, _stream())
    _check('brick_group_merged', code)
    _count('brick_group_merged')


def window_integrate_config() -> tuple:
    """(rays a block, stage count) of kernel B3 as the library was built:
    the host plans its ring with them."""
    rays, stages = ctypes.c_int(0), ctypes.c_int(0)
    code = lib().window_integrate_config(ctypes.byref(rays), ctypes.byref(stages))
    _check('window_integrate_config', code)
    return rays.value, stages.value


def window_integrate_shape(n_slots: int, K: int, n_fetch: int, n_groups: int) -> tuple:
    """(threads a block, dynamic shared bytes a block) of kernel B3 for a
    ring of ``n_slots`` slots and a schedule of ``K`` samples and
    ``n_fetch`` fetches over ``n_groups`` groups, as its launcher derives
    them; ValueError for what it refuses."""
    threads, smem = ctypes.c_int(0), ctypes.c_longlong(0)
    code = lib().window_integrate_shape(n_slots, K, n_fetch, n_groups, ctypes.byref(threads),
                                        ctypes.byref(smem))
    if code != 0:
        raise ValueError(f'window_integrate: no launch shape for {n_slots} ring slots, {K} '
                         f'samples, {n_fetch} fetches, {n_groups} groups (CUDA error {code})')
    return threads.value, smem.value


def launch_window_integrate(lo, hi, d2, ray_len, re, cube, ay, ax, sched_i, sched_f, out,
                            *, K, n_fetch, n_slots, wy, wx, tile, nx,
                            y_lo, y_inv, x_lo, x_inv, z_lo, z_hi, z_clip) -> None:
    """Kernel B3 (arguments checked by the caller; ``cube`` the (nz, ny,
    nx, 2) interleaved cubes, ``sched_i``/``sched_f`` the ring schedule of
    ``pallas_window.schedule_arrays``); the launcher derives the launch
    shape and refuses what does not fit."""
    _, L, n = lo.shape
    n_groups = ay.shape[1]
    ny, nxp = cube.shape[1:3]
    code = lib().window_integrate_launch(
        _ptr(lo), _ptr(hi), _ptr(d2), _ptr(ray_len), _ptr(re), _ptr(cube),
        _ptr(ay), _ptr(ax), _ptr(sched_i), _ptr(sched_f), _ptr(out),
        n, L, n_groups, K, n_fetch, n_slots, wy, wx, tile, ny, nx, nxp,
        y_lo, y_inv, x_lo, x_inv, z_lo, z_hi, int(z_clip), _stream())
    _check('window_integrate', code)
    _count('window_integrate')


def launch_probe_load(x, out) -> None:
    """Kernel S4 on an (n, 128) 16-bit CUDA tensor (checked by the caller)."""
    suffix = {v: k for k, v in PROBE_DTYPES.items()}[x.dtype]
    code = getattr(lib(), f'probe_load_{suffix}_launch')(_ptr(x), _ptr(out), x.shape[0], _stream())
    _check('probe_load', code)
    _count('probe_load')


def launch_probe_bitcast_i16_bf16(x, out) -> None:
    """Kernel S5 on an (n, 128) int16 CUDA tensor (checked by the caller)."""
    code = lib().probe_bitcast_i16_bf16_launch(_ptr(x), _ptr(out), x.numel(), _stream())
    _check('probe_bitcast_i16_bf16', code)
    _count('probe_bitcast_i16_bf16')
