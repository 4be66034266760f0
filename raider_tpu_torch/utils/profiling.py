"""Per-stage wall-time tracing and optional device profiling.

The counterpart of ``raider_tpu/utils/profiling.py``: named stage timers
around the delay engine's steps (logged, and summed into a report), a
``torch.profiler`` trace of a region, and named regions that show up in
such a trace.

A stage is a host wall clock, as in the JAX package: it adds no
``torch.cuda.synchronize()`` to the path. CUDA launches return before the
card has run them, so on the card a stage that ends in a host copy (such as
``raytrace.final_fetch``, or ``delay.ztd_cube``, whose cubes come back to
the host) includes the device's wait for the work queued before it, and a
stage that ends earlier (``raytrace.integrate``) times only the launches.

Stages nest: ``delay.raytrace_cube`` holds every ``raytrace.*`` stage of
its request, and ``raytrace.device_geometry`` (one slice's geometry,
``delay.engine._slice_geometry``) holds ``raytrace.look_vectors`` and
``raytrace.build_ray``. The port's engine has one geometry branch, so it
reports the JAX package's device-geometry name and its host-geometry
names together; no JAX stage name is missing from the port.
"""

import contextlib
import os
import threading
import time
from collections import defaultdict
from typing import Dict, Iterator, Optional

from raider_tpu_torch.logger import logger

_stage_totals: Dict[str, float] = defaultdict(float)
_stage_counts: Dict[str, int] = defaultdict(int)
_stage_lock = threading.Lock()


@contextlib.contextmanager
def stage(name: str, log: bool = True) -> Iterator[None]:
    """Time a named pipeline stage; accumulates into the session report."""
    t0 = time.perf_counter()
    try:
        yield
    finally:
        dt = time.perf_counter() - t0
        with _stage_lock:
            _stage_totals[name] += dt
            _stage_counts[name] += 1
        if log:
            logger.debug('[stage] %s: %.3f s', name, dt)


def stage_report(reset: bool = False) -> Dict[str, dict]:
    """Accumulated per-stage timings: {name: {total_s, calls, mean_s}}."""
    with _stage_lock:
        out = {
            name: {
                'total_s': total,
                'calls': _stage_counts[name],
                'mean_s': total / max(_stage_counts[name], 1),
            }
            for name, total in _stage_totals.items()
        }
        if reset:
            _stage_totals.clear()
            _stage_counts.clear()
    return out


def log_stage_report() -> None:
    report = stage_report()
    if not report:
        return
    logger.info('--- stage timing report ---')
    for name, row in sorted(report.items(), key=lambda kv: -kv[1]['total_s']):
        logger.info('  %-28s %8.3f s  (%d calls)', name, row['total_s'], row['calls'])


@contextlib.contextmanager
def device_trace(log_dir: Optional[str] = None) -> Iterator[None]:
    """Capture a ``torch.profiler`` trace around a region and export it as
    a Chrome trace (``trace.json``, for Perfetto or chrome://tracing) into
    ``log_dir``.

    CPU activity is always recorded, CUDA activity when a card is present
    (the port's tensors live there). No-op when log_dir is None, so callers
    can leave the hook in place.
    """
    if log_dir is None:
        yield
        return
    import torch
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    with profile(activities=activities) as prof:
        yield
    path = os.path.join(log_dir, 'trace.json')
    prof.export_chrome_trace(path)
    logger.info('Wrote device trace to %s', path)


@contextlib.contextmanager
def annotate(name: str) -> Iterator[None]:
    """Named region that shows up in ``torch.profiler`` traces
    (``record_function``), and as an NVTX range when a card is present."""
    import torch

    nvtx = torch.cuda.is_available()
    if nvtx:
        torch.cuda.nvtx.range_push(name)
    try:
        with torch.profiler.record_function(name):
            yield
    finally:
        if nvtx:
            torch.cuda.nvtx.range_pop()
