"""The harness finds configurations, mixes, limits and metrics by name, and
BENCHMARK.json keeps to the benchmark's contract."""

import json
import re
import shutil

import pytest

from portbench.harness import registry

NAME = re.compile(r'^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$')


@pytest.fixture
def bench():
    return registry.benchmark()


def test_every_cell_finds_its_files(bench):
    for cell in bench['workloads']:
        cfg = registry.config(bench, cell['config'])
        assert cfg['name'] == cell['config'] and cfg['reduced'] == []
        mix = registry.traffic(cell['traffic'])
        assert registry.kind(mix['kind']).Scene
        limits = registry.limits(cell['name'])
        assert limits['nan_mismatch'] == 0
        assert all(isinstance(v, (int, float)) and v >= 0 for v in limits.values())
        for m in registry.per_layer(bench, cell) + registry.end_to_end(bench, cell):
            assert callable(registry.metric_reader(m['name']).read)


def test_contract_shape(bench):
    assert set(bench) == {'command', 'paths', 'run_seconds', 'configs', 'workloads',
                          'end_to_end', 'per_layer'}
    assert bench['paths'] == ['portbench'] and 1 <= bench['run_seconds'] <= 51
    names = [e['name'] for part in ('configs', 'workloads', 'end_to_end', 'per_layer')
             for e in bench[part]]
    assert all(NAME.match(n) for n in names)
    assert len(set(e['name'] for e in bench['end_to_end'] + bench['per_layer'])) == \
        len(bench['end_to_end']) + len(bench['per_layer'])
    assert {c['config'] for c in bench['workloads']} == {c['name'] for c in bench['configs']}
    assert all(c['chips'] == 1 for c in bench['workloads'])
    assert 'setup_s' in {m['name'] for m in bench['end_to_end']}
    assert all(0.01 <= m['bound'] <= 0.25 for m in bench['end_to_end'])
    e2e = {m['name'] for m in bench['end_to_end']}
    assert all(m['moves'] in e2e for m in bench['per_layer'])
    for m in bench['per_layer']:
        assert set(m) <= {'name', 'unit', 'better', 'source', 'layer', 'moves', 'workloads'}
    for m in bench['per_layer'] + bench['end_to_end']:
        if m['name'].endswith('_roofline'):
            assert m['unit'] == '%'
    assert len(json.dumps(bench)) < 64 * 1024


def test_a_new_mix_is_new_files(tmp_path, monkeypatch, capsys):
    """A throwaway cell: a mix file, a limits file and its entry in
    BENCHMARK.json, beside copies of the files that are there, and no other
    change; the harness runs it."""
    from _portbench_tiny import overrides, run

    root = tmp_path / 'checkout'
    shutil.copytree(registry.HERE, root / 'portbench',
                    ignore=shutil.ignore_patterns('__pycache__', 'tests'))
    bench = registry.benchmark()
    mix = registry.traffic('ray')
    mix.update(heights_m=[0.0, 3000.0], dates=3)
    (root / 'portbench' / 'traffic' / 'throwaway.json').write_text(json.dumps(mix))
    (root / 'portbench' / 'limits' / 'hrrr_frame.throwaway.json').write_text(
        (registry.HERE / 'limits' / 'hrrr_frame.ray.json').read_text())
    bench['workloads'].append({'name': 'hrrr_frame.throwaway', 'config': 'hrrr_frame',
                               'traffic': 'throwaway', 'chips': 1, 'why': 'a test'})
    (root / 'BENCHMARK.json').write_text(json.dumps(bench))
    monkeypatch.setattr(registry, 'ROOT', root)
    monkeypatch.setattr(registry, 'HERE', root / 'portbench')
    ov = overrides(heights_m=[0.0, 3000.0], dates=3)
    rc, out, _ = run('frame_cut', capsys, workload='hrrr_frame.throwaway', overrides=ov)
    res = json.loads(out[-1])
    assert rc == 0 and res['correct'] and res['attempted'] >= 1
    assert set(res['metrics']) == {'delays_per_s', 'setup_s'}
