"""Measurement entry points on the card, run as ``python -m raider_tpu_torch.scripts.<name>``,
and the helpers they share."""

import subprocess

import numpy as np
import torch


def card() -> str:
    """The card's name and power limit, as ``nvidia-smi`` reports them."""
    res = subprocess.run(['nvidia-smi', '--query-gpu=name,power.limit', '--format=csv,noheader'],
                         capture_output=True, text=True, check=True, timeout=60)
    return res.stdout.strip().splitlines()[0]


def cuda_ms(fn, reps: int = 5) -> float:
    """Median time of ``fn`` in ms by CUDA events, after one warm-up call."""
    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return float(np.median(times))
