"""One run of one cell: set-up, the measured window, the check, one result line.

    python3 portbench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

Set-up builds the cell's scene (its request family, from the traffic mix's
``kind``) and runs one request outside the window. The window is a closed
loop: one worker sends the scene's requests back to back until ``seconds``
have passed, and the run counts the work of every request it started,
from the first request's start to the last one's end. With ``--trace 1``
the first ``trace_requests`` requests run under ``torch.profiler``. After
the window: the peak memory, the program's stage timers and the sampled
model columns are read, the program's state is dropped, and the reference
recomputes the sampled answers from the same raw fields; each number is
held to its limit in ``portbench/limits/<cell>.json``. Every metric is read
by its own module in ``portbench/metrics``.
"""

import argparse
import gc
import json
import os
import sys
import time
from types import SimpleNamespace

from portbench.harness import registry

FORBIDDEN = ('jax', 'jaxlib', 'flax', 'raider_tpu')


def parse(argv):
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument('--workload', required=True)
    p.add_argument('--seed', type=int, required=True)
    p.add_argument('--seconds', type=float, required=True)
    p.add_argument('--trace', type=int, choices=(0, 1), default=0)
    return p.parse_args(argv)


def say(msg: str) -> None:
    print(msg, file=sys.stderr, flush=True)


def forbidden_modules() -> list:
    """Loaded modules whose top-level name is JAX's or the JAX package's."""
    return sorted({m.split('.')[0] for m in list(sys.modules)} & set(FORBIDDEN))


def cell_inputs(workload: str, overrides=None):
    """(benchmark, cell, configuration, traffic mix, limits), with
    ``overrides`` ({'config': {...}, 'traffic': {...}, 'limits': {...}})
    laid over the files (the CPU tests shrink a cell this way)."""
    bench = registry.benchmark()
    cell = registry.workload(bench, workload)
    cfg = registry.config(bench, cell['config'])
    traffic = registry.traffic(cell['traffic'])
    limits = registry.limits(workload)
    for part, target in (('config', cfg), ('traffic', traffic), ('limits', limits)):
        target.update((overrides or {}).get(part, {}))
    return bench, cell, cfg, traffic, limits


def main(argv=None, *, device=None, t0=None, overrides=None) -> int:
    """Run one cell once; returns the exit code. ``device`` None looks for
    the cell's cards and refuses to run without them; the CPU tests pass
    'cpu'."""
    t0 = time.perf_counter() if t0 is None else t0
    args = parse(argv)
    bench, cell, cfg, traffic, limits = cell_inputs(args.workload, overrides)
    import torch

    if device is None:
        n = torch.cuda.device_count() if torch.cuda.is_available() else 0
        if n < cell['chips']:
            say(f'portbench: {cell["name"]} needs {cell["chips"]} CUDA device(s), found {n}')
            return 2
        device = 'cuda'
    on_card = torch.device(device).type == 'cuda'
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    def sync():
        if on_card:
            torch.cuda.synchronize()

    from portbench.harness import system, trace

    system.quiet()
    workdir = os.path.join(str(registry.ROOT), 'build', 'portbench')
    t_import = time.perf_counter() - t0
    scene = registry.kind(traffic['kind']).Scene(cfg, traffic, args.seed, device, workdir)
    sync()
    t_scene = time.perf_counter() - t0
    scene.request(0, keep=False)
    sync()
    setup_s = time.perf_counter() - t0
    setup_peak = torch.cuda.max_memory_allocated() if on_card else 0
    if on_card:
        torch.cuda.reset_peak_memory_stats()
    system.stage_report(reset=True)
    system.reset_launch_counts()

    n_traced = traffic['trace_requests'] if args.trace else 0
    seconds, pairs, k = [], 0, 0
    # the CPU has no device activity to trace
    prof = trace.start_profiler() if n_traced and on_card else None
    t_first = time.perf_counter()
    while k == 0 or time.perf_counter() - t_first < args.seconds:
        start = time.perf_counter()
        pairs += scene.request(k)
        if k < n_traced:
            sync()
        seconds.append(time.perf_counter() - start)
        k += 1
        if k == n_traced:
            traced_s = time.perf_counter() - t_first
            if prof is not None:
                prof.stop()
            # the stage timers read the untraced requests only
            system.stage_report(reset=True)
    t_last = time.perf_counter()
    if prof is not None and k < n_traced:
        traced_s = t_last - t_first
        prof.stop()
    say(f'portbench: set-up {setup_s:.3f} s (imports and the card {t_import:.3f} s, the scene '
        f'until {t_scene:.3f} s), {k} requests in {t_last - t_first:.3f} s: '
        + ' '.join(f'{t:.3f}' for t in seconds))
    prof_summary = trace.summarize(prof, traced_s) if prof is not None else None
    del prof
    window_peak = torch.cuda.max_memory_allocated() if on_card else 0
    ctx = SimpleNamespace(
        pairs=pairs, requests=k, window_s=t_last - t_first, request_seconds=seconds,
        setup_s=setup_s, stages=system.stage_report(), launches=dict(system.LAUNCHES),
        trace=prof_summary, traced=min(k, n_traced), peak_window_bytes=window_peak, scene=scene,
        device=device)

    scene.keep_models()
    scene.free()
    gc.collect()
    if on_card:
        torch.cuda.empty_cache()
    wanted = (registry.per_layer(bench, cell) if args.trace else registry.end_to_end(bench, cell))
    metrics = {}
    for m in wanted:
        value = registry.metric_reader(m['name']).read(ctx)
        if value is not None:
            metrics[m['name']] = {'value': value, 'unit': m['unit']}

    say(f'portbench: metrics read at {time.perf_counter() - t0:.3f} s')
    answers, columns = scene.reference()
    numbers = registry.kind(traffic['kind']).compare(scene, answers, columns)
    checks = {n: {'value': v, 'limit': limits[n]} for n, v in numbers.items()}
    correct = all(c['value'] <= c['limit'] for c in checks.values())

    say(f'portbench: reference done at {time.perf_counter() - t0:.3f} s')
    bad = forbidden_modules()
    if bad:
        say(f'portbench: modules of JAX or the JAX package are loaded: {bad}')
        return 3
    result = {'correct': correct, 'attempted': k, 'failed': 0, 'metrics': metrics,
              'device': _device(torch, on_card, max(setup_peak, window_peak), prof_summary)}
    if prof_summary:
        result['breakdown'] = {'device_ops': prof_summary['device_ops'],
                               'idle_gaps': prof_summary['idle_gaps']}
    result['checks'] = checks
    for n, c in checks.items():
        say(f'check {n} {c["value"]!r} limit {c["limit"]!r}')
    print(json.dumps(result), flush=True)
    return 0


def _device(torch, on_card: bool, peak: int, summary) -> dict:
    if on_card:
        dev = {'platform': 'gpu', 'kind': torch.cuda.get_device_name(0), 'count': 1,
               'memory_peak_bytes': int(peak)}
    else:
        dev = {'platform': 'cpu', 'kind': 'cpu', 'count': 1, 'memory_peak_bytes': 0}
    if summary:
        dev.update(busy_s=summary['busy_s'], window_s=summary['window_s'])
    return dev
