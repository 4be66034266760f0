"""Where kernel K3 spends its time: the merged-row group integrate as built
against ablated builds of ``csrc/brick_group.cu``, over the groups of a
spec (default 7,3,3,6: 11 groups) on the kernel profile's scene (1M
incoherent rays).

    python -m raider_tpu_torch.scripts.group_ablation [spec]

  * ``kernel``: the kernel as the library builds it;
  * ``copy_only``: the brick tile and the merged slab are staged and each
    ray writes two of its staged values instead of its sums: the copies
    alone;
  * ``no_copy``: the brick tile is not copied (the sums read whatever shared
    memory holds): everything but the brick copies;
  * ``no_slab``: the merged rows are not staged; each thread reads its rows
    from global memory, as the kernel before the slab did;
  * ``one_wait``: the position math waits for the brick tile too (one wait
    for all copies, not the slab first);
  * ``whole_rows``: every brick row copied whole, not only the planes the
    group's samples read;
  * ``rays64``, ``rays128``: blocks of 64 or 128 rays (the kernel's are 32).

Each build is made as ``brick_ablation`` makes its own (under
``build/ablation/brick_group/<name>``). One JSON line per build: the
CUDA-event ms of K3's calls over the groups (median of 5 after a warm-up),
whether it is bit-identical to the twin on every group (every build but
``copy_only`` and ``no_copy`` must be: the script raises otherwise),
and the registers and spills ptxas reported for the spec's window
instance, with the card.
"""

import json
import sys

import torch

from raider_tpu_torch import kernels
from raider_tpu_torch.scripts import card, cuda_ms
from raider_tpu_torch.scripts import kernel_profile as kp
from raider_tpu_torch.scripts.brick_ablation import build_tree, library_from
from raider_tpu_torch.utils import require_device

SPEC = (7, 3, 3, 6)
SOURCE = 'brick_group.cu'
_SLAB = ('  stage_slab(s_slab + head, merged + r0, n, M, nr, pitch);\n'
         '  const float* slab = s_slab + head;\n')
_MATH = ('      g[s] = sample_weights(row, ay, ax, re, s_pi + s * kPlanI, s_pf + s * kPlanF, k);\n'
         '    }\n  }\n  cp_async_wait<0>();\n  __syncthreads();\n  if (t >= nr) return;\n\n'
         '  const float2* pairs = reinterpret_cast<const float2*>(s_brick + t * P);\n'
         '  auto pair = [&](int i) { return pairs[i >> 1]; };\n'
         '  float acc_w = 0.0f, acc_h = 0.0f;\n  for (int s = 0; s < S; ++s) {\n'
         '    sample_sums<WY, WX>(g[s], s_pi[s * kPlanI + 3], pair, k, &acc_w, &acc_h);\n  }\n')
_RAYS = 'constexpr int kRays = 32;'
# (the kernel's lines, their ablated form)
ABLATIONS = {
    'copy_only': (_MATH, '      g[s] = make_float4(ay, ax, re, row(4, s));\n    }\n  }\n'
                  '  cp_async_wait<0>();\n  __syncthreads();\n  if (t >= nr) return;\n\n'
                  '  const float2* pairs = reinterpret_cast<const float2*>(s_brick + t * P);\n'
                  '  const float acc_w = pairs[0].x + g[0].x, acc_h = pairs[keep / 2 - 1].y;\n'),
    'no_copy': ('  stage_rows(s_brick, brick + r0 * width, nr, width, P, brick_unit, keep);\n',
                ''),
    'no_slab': (_SLAB, '  const float* slab = merged + r0;\n  pitch = static_cast<int>(n);\n'),
    'one_wait': ('  cp_async_wait<1>();\n', '  cp_async_wait<0>();\n'),
    'whole_rows': ('  const int keep = (top + 2) * wy * wx * 2;\n', '  const int keep = width;\n'),
    'rays64': (_RAYS, 'constexpr int kRays = 64;'),
    'rays128': (_RAYS, 'constexpr int kRays = 128;'),
}
EXACT = ('kernel', 'no_slab', 'one_wait', 'whole_rows', 'rays64', 'rays128')


def run(device='cuda', spec=SPEC, n_rays: int = kp.N_RAYS, grid=kp.GRID, seed: int = 0,
        say=print) -> list:
    """The builds on the scene at ``spec``; returns the records it printed."""
    dev = require_device(device)
    if dev.type != 'cuda':
        raise ValueError('group_ablation times CUDA builds: it needs a CUDA device')
    sc = kp.build_scene(dev, n_rays, grid, seed)
    st = kp.spec_setup(sc, spec)
    consts = kp.group_consts(sc['ys'], sc['xs'], sc['zs'], st['wy'], st['wx'])
    ops = [o + (consts,) for o in kp.merged_inputs(st['table'], sc['rays'], st['groups'],
                                                   sc['ys'], sc['xs'])]
    want = [kp.group_merged_ref(*o) for o in ops]
    where = dict(device=str(dev), card=card(), n_rays=n_rays, spec=list(spec), n_groups=len(ops))
    records = []
    for name in ('kernel', *ABLATIONS):
        with library_from(*build_tree(name, SOURCE, ABLATIONS), source=SOURCE):
            got = [kp.brick_group_merged(*o) for o in ops]
            exact = all(kp.same_bits(a, b) for g, w in zip(got, want) for a, b in zip(g, w))
            if name in EXACT and not exact:
                raise AssertionError(f'build {name}: K3 is not bit-identical to its twin')
            ms = cuda_ms(lambda: [kp.brick_group_merged(*o) for o in ops])
            ptxas = next((v for k, v in kernels.ptxas_resources(SOURCE).items()
                          if f'merged_kernelILi{st["wy"]}ELi{st["wx"]}E' in k), None)
        rec = dict(build=name, ms=ms, bit_identical=exact, ptxas=ptxas, **where)
        say(json.dumps(rec))
        records.append(rec)
    torch.cuda.empty_cache()
    return records


def main() -> None:
    spec = tuple(int(v) for v in sys.argv[1].split(',')) if len(sys.argv) > 1 else SPEC
    run(spec=spec, say=lambda s: print(s, flush=True))


if __name__ == '__main__':
    main()
