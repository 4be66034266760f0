"""Build and launch layer for the hand-written CUDA kernels in ``csrc/``.

The ``.cu`` sources expose a plain C interface. At first use they are
compiled by ``nvcc`` for sm_90a into one shared library under
``<repo>/build/kernels/``, named by a hash of the sources and flags, and
loaded with ``ctypes``: no PyTorch headers, so a build takes seconds.

Each launcher takes device pointers and torch's current stream, allocates
nothing, and returns ``cudaGetLastError()``; a non-zero code raises here.
``LAUNCHES`` counts the launches of each kernel (one per launcher call that
reached the kernel), so a caller can show that a run went through them.
"""

import ctypes
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path

import torch

CSRC = Path(__file__).resolve().parent.parent / 'csrc'
BUILD_DIR = Path(__file__).resolve().parents[2] / 'build' / 'kernels'
NVCC_FLAGS = ['-gencode', 'arch=compute_90a,code=sm_90a', '-std=c++17', '-O3',
              '-shared', '-Xcompiler', '-fPIC']

LAUNCHES = {'ztd_totals': 0, 'brick_integrate': 0}

_lib = None
build_seconds = None   # wall time of the build in this process (None: loaded a cached .so)


def reset_launch_counts() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0


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
    """Compile ``csrc/*.cu`` into the hashed library unless it exists."""
    global build_seconds
    out = library_path()
    if out.exists():
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_suffix(f'.{os.getpid()}.tmp')
    cmd = [_nvcc(), *NVCC_FLAGS, '-o', str(tmp),
           *[str(s) for s in sorted(CSRC.glob('*.cu'))]]
    t0 = time.perf_counter()
    res = subprocess.run(cmd, capture_output=True, text=True)
    if res.returncode != 0:
        raise RuntimeError(f'nvcc failed ({res.returncode}):\n{res.stderr}')
    os.replace(tmp, out)
    build_seconds = time.perf_counter() - t0
    return out


def lib() -> ctypes.CDLL:
    """The loaded kernel library, built on first use."""
    global _lib
    if _lib is None:
        so = ctypes.CDLL(str(build()))
        p, i, ll, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong, ctypes.c_float
        so.ztd_totals_launch.argtypes = [p, p, p, p, p, p, i, ll, f, f, f, p]
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
            p]                   # stream
        so.brick_integrate_launch.restype = i
        _lib = so
    return _lib


def _check(name: str, code: int) -> None:
    if code != 0:
        raise RuntimeError(f'{name}: CUDA error {code} at launch')


def _stream():
    return ctypes.c_void_p(torch.cuda.current_stream().cuda_stream)


def _ptr(t: torch.Tensor):
    return ctypes.c_void_p(t.data_ptr())


def launch_ztd_totals(t, p, e, dz, wet, hyd, k1, k2, k3) -> None:
    """Kernel B1 on (nz, ny, nx) float32 CUDA tensors (checked by the caller)."""
    nz = t.shape[0]
    ncol = t.numel() // nz
    code = lib().ztd_totals_launch(_ptr(t), _ptr(p), _ptr(e), _ptr(dz), _ptr(wet), _ptr(hyd),
                                   nz, ncol, k1, k2, k3, _stream())
    _check('ztd_totals', code)
    LAUNCHES['ztd_totals'] += 1


def launch_brick_integrate(table, bnd_y, bnd_x, bnd_z, d2, ray_len, re, plan_i, plan_f,
                           anchor, y_axis, x_axis, out, *, G, planes, wy, wx,
                           y_lo, y_hi, y_step, y_uniform, x_lo, x_hi, x_step, x_uniform,
                           z_lo, z_hi, z_clip) -> None:
    """Kernel B2 (arguments checked by the caller)."""
    n = bnd_y.shape[1]
    n_groups = anchor.shape[0]
    ny, nx = y_axis.shape[0], x_axis.shape[0]
    code = lib().brick_integrate_launch(
        _ptr(table), _ptr(bnd_y), _ptr(bnd_x), _ptr(bnd_z), _ptr(d2), _ptr(ray_len), _ptr(re),
        _ptr(plan_i), _ptr(plan_f), _ptr(anchor), _ptr(y_axis), _ptr(x_axis), _ptr(out),
        n, n_groups, G, planes, wy, wx, ny, nx,
        y_lo, y_hi, y_step, int(y_uniform), x_lo, x_hi, x_step, int(x_uniform),
        z_lo, z_hi, int(z_clip), _stream())
    _check('brick_integrate', code)
    LAUNCHES['brick_integrate'] += 1
