"""Kernel B1 (ZTD totals) on the two layouts it reads, and the weather
model's steps around it.

    python -m raider_tpu_torch.scripts.ztd_layouts [nz,ny,nx ...]

For each grid (default: the headline cube 51x400x400 and the HRRR CONUS
grid 51x1059x1799) and each layout, t, p and e are drawn on the card from a
fixed seed: ``rows`` as contiguous (z, y, x) cubes, ``columns`` as
contiguous (y, x, z) cubes (the weather model's layout) passed as their
(z, y, x) views. One JSON line each: ``ms`` and ``plain_ms``, the wrapper's
and the twin's CUDA-event time per call (median of 5 after a warm-up; the
wrapper's includes its host work); ``device_ms``, the kernel's device time
per call (a ``torch.profiler`` trace of 5 calls); the kernel's max-abs
difference from the twin; and the bound (5 x 4 bytes a cell at 3.35 TB/s,
or 14 float32 operations a cell at 67 TFLOP/s, whichever is larger) with
its share of ``device_ms``. Then, on the first grid, one line for
``WeatherModel._get_ztd`` on a model holding t, p and e as contiguous
(y, x, z) cubes, and one for ``_trimExtent`` (a crop to the inner 300x300
of 400x400, as ``load`` makes when the bounds are set) followed by
``_get_ztd``: CUDA-event ms per call, and the device time of all their
kernels and of B1's.

The first line is the card (name, power limit) and the file of the
``raider_tpu_torch`` that ran. To time another tree of the port, put that
tree first on ``PYTHONPATH`` (with this tree's ``scripts/__init__.py``,
which has ``device_ms``) and run this file by its path. A layout that
tree's wrapper refuses is reported as refused, with its message.

On the CPU, ``run('cpu', grids)`` computes the same records with the twin
in place of the kernel and times nothing.
"""

import json
import sys

import numpy as np
import torch

import raider_tpu_torch
from raider_tpu_torch.ops.ztd import ztd_totals, ztd_totals_ref
from raider_tpu_torch.scripts import card, cuda_ms, device_ms
from raider_tpu_torch.utils import require_device

GRIDS = ((51, 400, 400), (51, 1059, 1799))
LAYOUTS = ('rows', 'columns')
K1, K2, K3 = 0.776, 0.233, 3.75e3
SEED = 0
HBM_BYTES_PER_S = 3.35e12   # H100 SXM published peaks, as in chip_smoke.py
F32_FLOP_PER_S = 67e12
KERNEL = 'ztd_totals_kernel'
CROP = 0.75                 # the trimmed model keeps the inner 75% of each axis


def cubes(grid, layout: str, device, seed: int = SEED):
    """t, p, e as (nz, ny, nx) float32 cubes in ``layout``, drawn on
    ``device`` from ``seed``, and the (nz,) level heights."""
    nz, ny, nx = grid
    gen = torch.Generator(device=device)
    gen.manual_seed(seed)
    shape = (nz, ny, nx) if layout == 'rows' else (ny, nx, nz)

    def draw(lo, hi):
        return lo + (hi - lo) * torch.rand(shape, generator=gen, device=device)

    fields = (draw(200.0, 310.0), draw(1e3, 1.05e5), draw(1.0, 4000.0))
    if layout == 'columns':
        fields = tuple(torch.movedim(a, -1, 0) for a in fields)
    zs = torch.as_tensor(-100.0 + 27100.0 * np.linspace(0.0, 1.0, nz) ** 1.4, device=device)
    return fields + (zs,)


def bound(grid) -> dict:
    cells = int(np.prod(grid))
    t_bytes, t_ops = 20 * cells / HBM_BYTES_PER_S, 14 * cells / F32_FLOP_PER_S
    return dict(bound_ms=max(t_bytes, t_ops) * 1e3,
                bound_by='bytes' if t_bytes >= t_ops else 'operations')


def measure(grid, layout: str, device) -> dict:
    """Kernel B1 (the twin on the CPU) against the twin on one grid and
    layout; times on CUDA only."""
    t, p, e, zs = cubes(grid, layout, device)
    rec = dict(grid=list(grid), layout=layout)
    try:
        w, h = ztd_totals(t, p, e, zs, K1, K2, K3)
    except ValueError as exc:   # a tree of the port that does not read this layout
        return dict(rec, refused=str(exc))
    rw, rh = ztd_totals_ref(t, p, e, zs, K1, K2, K3)
    rec['max_abs_err'] = float(max((w - rw).abs().max(), (h - rh).abs().max()))
    rec['equal'] = bool(torch.equal(w, rw) and torch.equal(h, rh))
    del w, h, rw, rh
    rec.update(bound(grid))
    if device.type == 'cuda':
        rec['ms'] = cuda_ms(lambda: ztd_totals(t, p, e, zs, K1, K2, K3))
        rec['device_ms'] = device_ms(lambda: ztd_totals(t, p, e, zs, K1, K2, K3), KERNEL)[1]
        rec['plain_ms'] = cuda_ms(lambda: ztd_totals_ref(t, p, e, zs, K1, K2, K3))
        rec['bound_share'] = rec['bound_ms'] / rec['device_ms'] if rec['device_ms'] else None
    return rec


def _model(grid, device):
    """A weather model holding ``grid``'s cubes as contiguous (y, x, z) t, p
    and e on ``device``, with its coordinates."""
    from raider_tpu_torch.wx.base import WeatherModel

    nz, ny, nx = grid
    m = WeatherModel()
    m._k1, m._k2, m._k3 = K1, K2, K3
    m._device = device
    t, p, e, zs = cubes(grid, 'columns', device)
    m._t, m._p, m._e = (torch.movedim(a, 0, -1) for a in (t, p, e))
    m._wet_refractivity, m._hydrostatic_refractivity = m._t, m._p
    m._zs = zs.cpu().numpy()
    m._ys, m._xs = np.linspace(16.0, 24.0, ny), np.linspace(1.5, 7.5, nx)
    m._lons, m._lats = np.meshgrid(m._xs, m._ys)
    return m


def get_ztd_record(grid, device) -> dict:
    """``WeatherModel._get_ztd`` on a model holding ``grid``'s cubes as
    contiguous (y, x, z) t, p and e; its time on CUDA only."""
    m = _model(grid, device)
    m._get_ztd()
    rec = dict(grid=list(grid), stage='_get_ztd', shape=list(m._wet_ztd.shape))
    if device.type == 'cuda':
        rec['ms'] = cuda_ms(m._get_ztd)
        rec['device_ms'], rec['kernel_device_ms'] = device_ms(m._get_ztd, KERNEL)
    return rec


def trim_record(grid, device) -> dict:
    """``_trimExtent`` to the inner ``CROP`` of each axis, then ``_get_ztd``,
    on the model of :func:`get_ztd_record`; its time on CUDA only. Each call
    first gives the model back its whole fields and coordinates."""
    m = _model(grid, device)
    whole = dict(vars(m))
    lo, hi = (1 - CROP) / 2, (1 + CROP) / 2
    ys, xs = m._ys, m._xs
    bounds = [ys[0] + lo * (ys[-1] - ys[0]), ys[0] + hi * (ys[-1] - ys[0]),
              xs[0] + lo * (xs[-1] - xs[0]), xs[0] + hi * (xs[-1] - xs[0])]

    def trim_and_ztd():
        vars(m).update(whole)
        m._trimExtent(bounds)
        m._get_ztd()

    trim_and_ztd()
    rec = dict(grid=list(grid), stage='_trimExtent + _get_ztd', shape=list(m._wet_ztd.shape))
    if device.type == 'cuda':
        rec['ms'] = cuda_ms(trim_and_ztd)
        rec['device_ms'], rec['kernel_device_ms'] = device_ms(trim_and_ztd, KERNEL)
    return rec


def run(device='cuda', grids=GRIDS, say=print) -> list:
    device = require_device(device)
    recs = [measure(g, layout, device) for g in grids for layout in LAYOUTS]
    recs += [get_ztd_record(grids[0], device), trim_record(grids[0], device)]
    for r in recs:
        say(json.dumps(r))
    return recs


def main(argv) -> int:
    grids = [tuple(int(v) for v in a.split(',')) for a in argv] or GRIDS
    print(f'{card()}; raider_tpu_torch from {raider_tpu_torch.__file__}', flush=True)
    run('cuda', grids, say=lambda s: print(s, flush=True))
    return 0


if __name__ == '__main__':
    sys.exit(main(sys.argv[1:]))
