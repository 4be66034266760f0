"""Reading a ``torch.profiler`` trace of the first requests of a window.

Only the device's activity is recorded (CUDA kernels, copies and sets):
recording every host operation as well slows a request by 30-60% and
leaves the device idle for the profiler's sake. From the trace: the seconds
in which some device operation ran (the union of their intervals) against
the traced requests' wall time on the host clock, the device operations
that took most time, the device time of each kernel name, and the longest
idle gaps, named by the device operations on either side of them.
"""

from collections import defaultdict


def start_profiler():
    """A started profiler of the device's activity (``stop()`` ends it)."""
    from torch.profiler import ProfilerActivity, profile

    prof = profile(activities=[ProfilerActivity.CUDA])
    prof.start()
    return prof


def _union(intervals):
    """Total length of the union of (start, end, name) intervals, and its
    gaps as (start, end, name before, name after)."""
    busy, gaps = 0, []
    end, last = None, None
    for s, e, n in sorted(intervals):
        if end is None or s > end:
            if end is not None:
                gaps.append((end, s, last, n))
            busy += e - s
            end, last = e, n
        elif e > end:
            busy += e - end
            end, last = e, n
    return busy, gaps


def summarize(prof, window_s: float, top: int = 10) -> dict:
    """busy_s, window_s, the top device operations and idle gaps, and the
    device seconds of every kernel name, of a traced region whose wall time
    is ``window_s``; {} when the trace holds no device activity."""
    from torch.autograd import DeviceType

    device = [(ev.start_ns(), ev.start_ns() + ev.duration_ns(), ev.name())
              for ev in prof.profiler.kineto_results.events()
              if ev.device_type() == DeviceType.CUDA]
    if not device:
        return {}
    busy, gaps = _union(device)
    by_name = defaultdict(int)
    for s, e, n in device:
        by_name[n] += e - s
    idle = [[f'between {a[:80]} and {b[:80]}', (g1 - g0) * 1e-9]
            for g0, g1, a, b in sorted(gaps, key=lambda g: g[0] - g[1])[:top]]
    ops = sorted(by_name.items(), key=lambda kv: -kv[1])
    return dict(busy_s=busy * 1e-9, window_s=window_s,
                device_ops=[[n, t * 1e-9] for n, t in ops[:top]], idle_gaps=idle,
                kernels={n: t * 1e-9 for n, t in ops})
