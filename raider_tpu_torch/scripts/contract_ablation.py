"""Where kernel K1 spends its time: the brick contraction as built against
ablated builds of ``csrc/brick_contract.cu``, over the 11 groups of spec
(7,3,3,6) on the kernel profile's scene (1M incoherent rays).

    python -m raider_tpu_torch.scripts.contract_ablation

  * ``kernel``: the kernel as the library builds it;
  * ``copy_only``: the tiles are staged and each ray writes two of its
    staged values instead of its sums: the copies, the lane tables and the
    scalar pass;
  * ``no_copy``: the brick tile is not copied (the sums read whatever shared
    memory holds): everything but the brick copies;
  * ``rays32``, ``rays128``: the launcher held to blocks of 32 or 128 rays
    (it picks 64 at this spec).

Each build is made as ``brick_ablation`` makes its own (under
``build/ablation/brick_contract/<name>``). One JSON line per build: the
CUDA-event ms of K1's calls over the groups (median of 5 after a warm-up),
whether it is bit-identical to the twin on every group (the kernel and the
block-size builds must be: the script raises otherwise), and the registers
and spills ptxas reported for the 3x3 instance, with the card.
"""

import json

import torch

from raider_tpu_torch import kernels
from raider_tpu_torch.scripts import card, cuda_ms
from raider_tpu_torch.scripts import kernel_profile as kp
from raider_tpu_torch.scripts.brick_ablation import build_tree, library_from
from raider_tpu_torch.utils import require_device

SPEC = (7, 3, 3, 6)
SOURCE = 'brick_contract.cu'
_ROW = '  const float2* row = reinterpret_cast<const float2*>(s_brick + t * P);\n'
_RAYS = 'constexpr int kRays[] = {32, 64, 128};'
# (the kernel's line, its ablated form)
ABLATIONS = {
    'copy_only': (_ROW, _ROW + '  if (S > 0) {\n    out_w[ray] = row[0].x;\n'
                  '    out_h[ray] = row[width / 2 - 1].y;\n    return;\n  }\n'),
    'no_copy': ('  stage_rows(s_brick, brick + r0 * width, nr, width, P, brick_unit, width);\n',
                ''),
    'rays32': (_RAYS, 'constexpr int kRays[] = {32};'),
    'rays128': (_RAYS, 'constexpr int kRays[] = {128};'),
}
EXACT = ('kernel', 'rays32', 'rays128')


def run(device='cuda', n_rays: int = kp.N_RAYS, grid=kp.GRID, seed: int = 0, say=print) -> list:
    """The five builds on the scene; returns the records it printed."""
    dev = require_device(device)
    if dev.type != 'cuda':
        raise ValueError('contract_ablation times CUDA builds: it needs a CUDA device')
    sc = kp.build_scene(dev, n_rays, grid, seed)
    st = kp.spec_setup(sc, SPEC)
    ops = [o + (st['planes'], st['wy'], st['wx'])
           for o in kp.contract_inputs(st['table'], sc['rays'], st['groups'], st['wy'], st['wx'],
                                       sc['ys'], sc['xs'], sc['zs'])]
    want = [kp.contract_ref(*o) for o in ops]
    where = dict(device=str(dev), card=card(), n_rays=n_rays, spec=list(SPEC), n_groups=len(ops))
    records = []
    for name in ('kernel', *ABLATIONS):
        with library_from(*build_tree(name, SOURCE, ABLATIONS), source=SOURCE):
            got = [kp.brick_contract(*o) for o in ops]
            exact = all(kp.same_bits(a, b) for g, w in zip(got, want) for a, b in zip(g, w))
            if name in EXACT and not exact:
                raise AssertionError(f'build {name}: K1 is not bit-identical to its twin')
            ms = cuda_ms(lambda: [kp.brick_contract(*o) for o in ops])
            ptxas = next((v for k, v in kernels.ptxas_resources(SOURCE).items()
                          if 'ILi3ELi3E' in k), None)
        rec = dict(build=name, ms=ms, bit_identical=exact, ptxas=ptxas, **where)
        say(json.dumps(rec))
        records.append(rec)
    torch.cuda.empty_cache()
    return records


def main() -> None:
    run(say=lambda s: print(s, flush=True))


if __name__ == '__main__':
    main()
