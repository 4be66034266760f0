"""Where kernel B3 spends its time: the windowed integrate as built against
ablated builds of ``csrc/window_integrate.cu``, on the window ablation's
scene (a 50x400x400 cube, 1000x1000 coherent rays: 1,024,000 in tile order).

    python -m raider_tpu_torch.scripts.window_kernel_ablation [side]

  * ``kernel``: the kernel as the library builds it;
  * ``copy_only``: the operand rows are copied, and each
    ray writes one staged value instead of its sums: the copies alone;
  * ``no_ring``: no operand row is copied; each thread loads its operands
    from global memory in the sample's chain, as the kernel before the ring;
  * ``no_corners``: no corner is read (the trilinear value is a stand-in
    from the weights): everything but the cube gathers;
  * ``stages2``, ``stages8``: 2 or 8 samples' rows resident (the kernel's
    are 4), fetched 1 or 7 samples ahead;
  * ``rays256``: blocks of 256 rays (the kernel's are 128).

Each build is made as ``brick_ablation`` makes its own (under
``build/ablation/window_integrate/<name>``); the host plans the ring with
the build's stage count. One JSON line per build: the CUDA-event ms of the call
(median of 5 after a warm-up), its ms a call over bursts of 20 calls back
to back (``burst_ms``: the device's time when the host keeps ahead), the
kernel's device ms in a ``torch.profiler`` trace, whether it is
bit-identical to the twin with equal NaN masks (every build but
``copy_only`` and ``no_corners`` must be: the script raises otherwise), the
launch (threads, shared bytes, ring slots, stages) and the registers and
spills ptxas reported for the kernel, with the card.
"""

import json
import sys

import torch

from raider_tpu_torch import kernels
from raider_tpu_torch.delay.pallas_window import (prepare_windowed, window_integrate,
                                                  window_integrate_ref, window_launch_shape)
from raider_tpu_torch.scripts import burst_ms, card, cuda_ms, device_ms
from raider_tpu_torch.scripts.kernel_profile import same_bits
from raider_tpu_torch.scripts import window_ablation as wa
from raider_tpu_torch.scripts.brick_ablation import build_tree, library_from
from raider_tpu_torch.utils import require_device

SOURCE = 'window_integrate.cu'
_MATH = ('    const float2 v = sample(ly, hy, lx, hx, lz, hz, d2, rla, rlb, w0.w & 0xffff, '
         'w1.x, f0, zinv);\n')
_OPERANDS = (
    '    auto opnd = [&](int word, int byte) { return wring[((word >> 8 * byte) & 0xff) * 32 '
    '+ lane]; };\n'
    '    const float ly = opnd(w0.x, 0), lx = opnd(w0.x, 1), lz = opnd(w0.x, 2), '
    'hy = opnd(w0.x, 3);\n'
    '    const float hx = opnd(w0.y, 0), hz = opnd(w0.y, 1), d2 = opnd(w0.y, 2);\n'
    '    const float rla = opnd(w0.y, 3), rlb = opnd(w0.z, 0);\n')
_FETCH = ('      cp_async16(wring + (f & 0xff) * 32 + c, '
          'src + static_cast<size_t>(f >> 10) * N + rw + c);\n')
_CORNERS = '      const float2 v = mix4(prm.cube + base, nxp, plane, wx0, fx, m);\n'
_STAGES = 'constexpr int kStages = 4;'
_RAYS = 'constexpr int kRays = 128;'
# (the kernel's lines, their ablated form), or a list of such pairs
ABLATIONS = {
    'copy_only': (_MATH, '    const float2 v = make_float2(ly, re);\n'),
    'no_ring': [(_OPERANDS,
                 '    const int lv = w0.w >> 16, L = prm.L;\n'
                 '    const int wal = w1.w & 0xffff, wbl = w1.w >> 16;\n'
                 '    auto row = [&](const float* a, int r) {\n'
                 '      return __ldg(a + static_cast<size_t>(r) * N + rw + lane);\n    };\n'
                 '    const float ly = row(prm.lo, lv), lx = row(prm.lo, L + lv);\n'
                 '    const float lz = row(prm.lo, 2 * L + lv), hy = row(prm.hi, lv);\n'
                 '    const float hx = row(prm.hi, L + lv), hz = row(prm.hi, 2 * L + lv);\n'
                 '    const float d2 = row(prm.d2, lv);\n'
                 '    const float rla = row(prm.ray_len, wal), rlb = row(prm.ray_len, wbl);\n'),
                (_FETCH, '      (void)src;\n')],
    'no_corners': (_CORNERS, '      const float2 v = make_float2(__fadd_rn(wx0, m[0]), '
                   '__fadd_rn(fx, m[3]));\n'),
    'stages2': (_STAGES, 'constexpr int kStages = 2;'),
    'stages8': (_STAGES, 'constexpr int kStages = 8;'),
    'rays256': (_RAYS, 'constexpr int kRays = 256;'),
}
EXACT = ('kernel', 'no_ring', 'stages2', 'stages8', 'rays256')


def run(device='cuda', side: int = wa.SIDE, grid=wa.GRID, seed: int = 0, say=print) -> list:
    """The builds on the scene; returns the records it printed."""
    dev = require_device(device)
    if dev.type != 'cuda':
        raise ValueError('window_kernel_ablation times CUDA builds: it needs a CUDA device')
    sc = wa.build_scene(side, grid=grid, device=dev, seed=seed)
    b = prepare_windowed(*wa.windowed_args(sc), device=dev)
    del sc
    want = window_integrate_ref(b)
    where = dict(device=str(dev), card=card(), rays=int(b.re.shape[0]),
                 n_groups=int(b.lvl.shape[0]), wy=int(b.wy))
    records = []
    for name in ('kernel', *ABLATIONS):
        with library_from(*build_tree(name, SOURCE, ABLATIONS), source=SOURCE):
            got = window_integrate(b)
            torch.cuda.synchronize()
            exact = all(same_bits(g, w) for g, w in zip(got, want))
            if name in EXACT and not exact:
                raise AssertionError(f'build {name}: B3 is not bit-identical to its twin')
            fn = lambda: window_integrate(b)
            # registers and spills of this build (None when it came from the cache)
            ptxas = next(iter(kernels.ptxas_resources(SOURCE).values()), None)
            rec = dict(build=name, ms=cuda_ms(fn), burst_ms=burst_ms(fn),
                       device_ms=device_ms(fn, 'window_integrate_kernel')[1],
                       bit_identical=exact, **window_launch_shape(b), ptxas=ptxas, **where)
        say(json.dumps(rec))
        records.append(rec)
    torch.cuda.empty_cache()
    return records


def main() -> None:
    side = int(sys.argv[1]) if len(sys.argv) > 1 else wa.SIDE
    run(side=side, say=lambda s: print(s, flush=True))


if __name__ == '__main__':
    main()
