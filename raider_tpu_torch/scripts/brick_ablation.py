"""Where kernels B2 and K4 spend their time: the brick integrate as built
against two ablated builds of ``csrc/brick_integrate.cu``, on the kernel
profile's scene (1M incoherent rays, spec (7,3,3,6)).

    python -m raider_tpu_torch.scripts.brick_ablation

  * ``kernel``: the kernel as the library builds it;
  * ``nocopy``: no brick plane is copied into shared memory (the mix reads
    whatever the rings hold): the position math, the group anchors and the
    mix;
  * ``nomix``: the planes are copied, and the mix is replaced by one read of
    the ray's ring: the position math, the anchors and the copies.

An ablated source is written, beside copies of the other sources, under
``build/ablation/brick_integrate/<name>/csrc`` and built there like the
library. The ablated
builds compute wrong numbers on purpose: only this script loads them, and
it restores the library afterwards. One JSON line per build and table (f32
for B2, int16 for K4): CUDA-event ms (median of 5 after a warm-up) and the
registers and spills ptxas reported, with the card.
"""

import contextlib
import json
import shutil

import torch

from raider_tpu_torch import kernels
from raider_tpu_torch.delay.raytrace import _pack_bricks, _quantized_pair, integrate_bricks
from raider_tpu_torch.scripts import card, cuda_ms
from raider_tpu_torch.scripts import kernel_profile as kp
from raider_tpu_torch.utils import require_device

SPEC = (7, 3, 3, 6)
SOURCE = 'brick_integrate.cu'
# (the kernel's line, its ablated form)
ABLATIONS = {
    'nocopy': ('      cp_async<sizeof(Pair)>(ring + ray * slot + dst_off + off,',
               '      if (lane > 31) cp_async<sizeof(Pair)>(ring + ray * slot + dst_off + off,'),
    'nomix': ('    mix(mine + cur.x * plane_pairs, mine + cur.y * plane_pairs, dq, w, wy, wx, '
              '&acc_w, &acc_h);',
              '    acc_w = __fadd_rn(acc_w, w.wte);\n'
              '    acc_h = __fadd_rn(acc_h, static_cast<float>(\n'
              '        reinterpret_cast<const int*>(mine + cur.x * plane_pairs)[0]));'),
}


def ablated_source(name: str, source: str = SOURCE, ablations=None) -> str:
    """``source`` with ablation ``name`` of ``ablations`` (default: this
    script's) applied: one (line, replacement) pair, or a list of them;
    raises if a line it replaces is not in the source exactly once."""
    src = (kernels.CSRC / source).read_text()
    edits = (ABLATIONS if ablations is None else ablations)[name]
    for old, new in edits if isinstance(edits, list) else [edits]:
        if src.count(old) != 1:
            raise RuntimeError(f'ablation {name!r}: its line is not in {source} exactly once')
        src = src.replace(old, new)
    return src


@contextlib.contextmanager
def library_from(csrc, build_dir, source: str = SOURCE):
    """The kernel library built from ``csrc`` into ``build_dir`` for the
    duration of the block; the default library afterwards."""
    saved = kernels.CSRC, kernels.BUILD_DIR, kernels._lib
    kernels.CSRC, kernels.BUILD_DIR, kernels._lib = csrc, build_dir, None
    kernels.BUILD_LOG.pop(source, None)
    try:
        kernels.lib()
        yield
    finally:
        kernels.CSRC, kernels.BUILD_DIR, kernels._lib = saved


def build_tree(name: str, source: str = SOURCE, ablations=None):
    """(csrc, build dir) of build ``name`` of ``source``: the library's own
    for 'kernel'."""
    if name == 'kernel':
        return kernels.CSRC, kernels.BUILD_DIR
    root = kernels.BUILD_DIR.parent / 'ablation' / source.split('.')[0] / name
    csrc = root / 'csrc'
    shutil.rmtree(csrc, ignore_errors=True)
    shutil.copytree(kernels.CSRC, csrc)
    (csrc / source).write_text(ablated_source(name, source, ablations))
    return csrc, root / 'kernels'


def run(device='cuda', n_rays: int = kp.N_RAYS, grid=kp.GRID, seed: int = 0, say=print) -> list:
    """The three builds on the scene; returns the records it printed."""
    dev = require_device(device)
    if dev.type != 'cuda':
        raise ValueError('brick_ablation times CUDA builds: it needs a CUDA device')
    sc = kp.build_scene(dev, n_rays, grid, seed)
    st = kp.spec_setup(sc, SPEC)
    planes, wy, wx = st['planes'], st['wy'], st['wx']
    qw, qh, deq = _quantized_pair(sc['wet_d'], sc['hydro_d'])
    tables = {'f32': (st['table'], None), 'i16': (_pack_bricks(qw, qh, planes, wy, wx), deq)}
    del qw, qh
    where = dict(device=str(dev), card=card(), n_rays=n_rays, spec=list(SPEC))
    records = []
    for name in ('kernel', *ABLATIONS):
        with library_from(*build_tree(name)):
            res = kernels.ptxas_resources(SOURCE)
            for table_name, (table, dq) in tables.items():
                fn = (lambda t=table, d=dq: integrate_bricks(t, *sc['rays'], st['plan'], sc['ys'],
                                                             sc['xs'], sc['zs'], deq=d))
                tag = 'IfLi3ELi3E' if table_name == 'f32' else 'IsLi3ELi3E'
                ptxas = next((v for k, v in res.items() if tag in k), None)
                rec = dict(build=name, table=table_name, ms=cuda_ms(fn), ptxas=ptxas, **where)
                say(json.dumps(rec))
                records.append(rec)
    torch.cuda.empty_cache()
    return records


def main() -> None:
    run(say=lambda s: print(s, flush=True))


if __name__ == '__main__':
    main()
