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


def burst_ms(fn, n: int = 20, reps: int = 5) -> float:
    """Median ms per call of ``fn`` over ``reps`` bursts of ``n`` calls back
    to back between two CUDA events, after a warm-up: the device's time per
    call when the host enqueues calls faster than the device runs them."""
    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(n):
            fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end) / n)
    return float(np.median(times))


def device_ms(fn, kernel: str, launches: int = 1, reps: int = 5):
    """(all kernels, the kernels whose name holds ``kernel``) device ms per
    call of ``fn``, which launches that kernel ``launches`` times, from a
    ``torch.profiler`` trace of ``reps`` calls after a warm-up; (None, None)
    when three traces in a row miss some of its launches."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    for _ in range(3):   # a trace now and then comes back short of device events
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(reps):
                fn()
            torch.cuda.synchronize()
        total = mine = 0.0
        seen = 0
        for ev in prof.key_averages():
            total += ev.self_device_time_total
            if kernel in ev.key:
                mine += ev.self_device_time_total
                seen += ev.count
        if seen == reps * launches:
            return total / reps / 1e3, mine / reps / 1e3
    return None, None
