"""Finding a cell's files by the names in ``BENCHMARK.json``.

    configuration  the file its entry names (``portbench/configs/<name>.json``)
    traffic mix    portbench/traffic/<traffic>.json (its ``kind`` names the
                   request family: portbench/kinds/<kind>.py)
    limits         portbench/limits/<workload>.json
    metric         portbench/metrics/<metric>.py, whose ``read(ctx)`` returns
                   the value or None

so that a new configuration, mix, cell or metric is a new file.
"""

import importlib
import importlib.util
import json
from pathlib import Path

ROOT = Path(__file__).resolve().parents[2]
HERE = ROOT / 'portbench'


def _json(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


def benchmark() -> dict:
    return _json(ROOT / 'BENCHMARK.json')


def _named(entries, name: str, what: str) -> dict:
    for e in entries:
        if e['name'] == name:
            return e
    raise KeyError(f'BENCHMARK.json names no {what} {name!r}')


def workload(bench: dict, name: str) -> dict:
    return _named(bench['workloads'], name, 'workload')


def config(bench: dict, name: str) -> dict:
    return _json(ROOT / _named(bench['configs'], name, 'configuration')['file'])


def traffic(name: str) -> dict:
    return _json(HERE / 'traffic' / f'{name}.json')


def limits(workload_name: str) -> dict:
    return _json(HERE / 'limits' / f'{workload_name}.json')


def kind(name: str):
    return importlib.import_module(f'portbench.kinds.{name}')


def metric_reader(name: str):
    path = HERE / 'metrics' / f'{name}.py'
    spec = importlib.util.spec_from_file_location(f'portbench.metrics.{name}', path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def per_layer(bench: dict, cell: dict) -> list:
    """The per-layer metrics a cell reports: those whose ``workloads`` list
    it, or that have no such list and move an end-to-end metric the cell
    reports."""
    e2e = {m['name'] for m in bench['end_to_end']
           if 'workloads' not in m or cell['name'] in m['workloads']}
    return [m for m in bench['per_layer']
            if (cell['name'] in m['workloads'] if 'workloads' in m else m['moves'] in e2e)]


def end_to_end(bench: dict, cell: dict) -> list:
    return [m for m in bench['end_to_end']
            if 'workloads' not in m or cell['name'] in m['workloads']]
