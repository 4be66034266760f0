#!/usr/bin/env python3
"""The benchmark of the PyTorch and CUDA port: one run of one cell.

    python3 portbench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

Run from the root of a checkout; see portbench/README.md.
"""

import time

T0 = time.perf_counter()

import os  # noqa: E402
import sys  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
# the program's caches stay in fixed directories of the checkout
for var, sub in (('TORCH_EXTENSIONS_DIR', 'torch_extensions'), ('TRITON_CACHE_DIR', 'triton')):
    os.environ[var] = os.path.join(ROOT, 'build', 'portbench', sub)
os.environ['USE_FLAX'] = '0'
sys.path.insert(0, ROOT)

from portbench.harness.main import main  # noqa: E402

if __name__ == '__main__':
    sys.exit(main(sys.argv[1:], t0=T0))
