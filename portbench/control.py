#!/usr/bin/env python3
"""The control of a cell's check: the reference put in the program's place,
its stored fields in bfloat16, compared with the float64 reference.

    python3 portbench/control.py --workload <cell> --requests <n> --seeds <s> [<s> ...]

For each seed the cell's set-up runs as in a run (the same fields, frames,
grids and samples), then the first ``n`` requests' sampled answers and the
models' sampled columns are computed by the reference twice, and the numbers
of ``correct`` are printed as one JSON line a seed. A sound check has the
control fail one of them. The benchmark's runs do not run this.
"""

import argparse
import json
import os
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)


def control(workload: str, seed: int, n_requests: int, device='cuda', overrides=None,
            store=None) -> dict:
    import torch

    from portbench.harness import main, registry

    _, _, cfg, traffic, limits = main.cell_inputs(workload, overrides)
    kind = registry.kind(traffic['kind'])
    scene = kind.Scene(cfg, traffic, seed, device, os.path.join(ROOT, 'build', 'portbench'))
    scene.free()
    scene.pending(n_requests)
    scene.fill_from(*scene.reference(store=store or torch.bfloat16))
    numbers = kind.compare(scene, *scene.reference())
    return {n: {'value': v, 'limit': limits[n]} for n, v in numbers.items()}


if __name__ == '__main__':
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument('--workload', required=True)
    p.add_argument('--requests', type=int, required=True)
    p.add_argument('--seeds', type=int, nargs='+', required=True)
    a = p.parse_args()
    for s in a.seeds:
        print(json.dumps({'workload': a.workload, 'seed': s, 'control': 'bfloat16',
                          'checks': control(a.workload, s, a.requests)}), flush=True)
