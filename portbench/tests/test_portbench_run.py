"""A run's result line, its checks on standard error, its refusals."""

import json
import subprocess
import sys
import types

import pytest

from _portbench_tiny import SHAPES, WORKLOAD, StepClock, run
from portbench.harness import main

KEYS = {'correct', 'attempted', 'failed', 'metrics', 'device'}


@pytest.mark.parametrize('shape', SHAPES)
def test_last_line_has_the_contract_keys(shape, capsys):
    rc, out, err = run(shape, capsys)
    res = json.loads(out[-1])
    assert rc == 0 and KEYS <= set(res) and list(res)[-1] == 'checks'
    assert res['correct'] is True and res['failed'] == 0 and res['attempted'] >= 1
    bench = main.registry.benchmark()
    e2e = main.registry.end_to_end(bench, main.registry.workload(bench, WORKLOAD))
    assert set(res['metrics']) == {m['name'] for m in e2e} and 'setup_s' in res['metrics']
    assert all(m['value'] > 0 for m in res['metrics'].values())
    assert set(res['device']) >= {'platform', 'kind', 'count', 'memory_peak_bytes'}
    checks = [line for line in err if line.startswith('check ')]
    assert checks == err[-len(checks):] and len(checks) == len(res['checks'])


def test_traced_line_reports_per_layer_metrics(monkeypatch, capsys):
    monkeypatch.setattr(main, 'time', StepClock())      # four requests, one traced
    rc, out, _ = run('frame_cut', capsys, seconds=1.0, trace=1)
    res = json.loads(out[-1])
    # the CPU has no device trace: only the stage timers of the requests
    # after the traced one read something
    assert rc == 0 and set(res['metrics']) == {'geometry_s_per_slice', 'raytrace_cube_s'}


def test_jax_modules_refuse_the_result(monkeypatch, capsys):
    monkeypatch.setitem(sys.modules, 'jaxlib.fake', types.ModuleType('jaxlib.fake'))
    rc, out, err = run('frame_cut', capsys)
    assert rc != 0 and not any(line.startswith('{') for line in out)
    assert 'jaxlib' in err[-1]


def test_port_name_is_not_the_jax_package(monkeypatch):
    monkeypatch.setitem(sys.modules, 'raider_tpu_torch.fake', types.ModuleType('x'))
    assert main.forbidden_modules() == [m for m in main.forbidden_modules()
                                        if m != 'raider_tpu_torch']
    assert 'raider_tpu' not in main.forbidden_modules() or 'raider_tpu' in {
        m.split('.')[0] for m in sys.modules}


def test_no_card_no_result():
    import torch

    if torch.cuda.is_available():
        pytest.skip('this machine has a card')
    res = subprocess.run([sys.executable, 'portbench/run.py', '--workload', 'hrrr_frame.ray',
                          '--seed', '1', '--seconds', '1', '--trace', '0'],
                         capture_output=True, text=True, cwd=main.registry.ROOT, timeout=300)
    assert res.returncode != 0 and res.stdout.strip() == ''


def test_the_harness_loads_no_jax():
    """The run's modules, the reference and the control import neither JAX nor
    the JAX package; the reference imports nothing of the port either."""
    code = ('import sys; sys.path.insert(0, "."); '
            'import portbench.harness.main, portbench.control, portbench.kinds.raytraced_boxes, '
            'portbench.harness.system; '
            'print(sorted({m.split(".")[0] for m in sys.modules}))')
    mods = subprocess.run([sys.executable, '-c', code], capture_output=True, text=True,
                          cwd=main.registry.ROOT, timeout=300, check=True).stdout
    assert 'jax' not in mods and "'raider_tpu'" not in mods and 'raider_tpu_torch' in mods
    code = ('import sys; sys.path.insert(0, "."); import portbench.reference.hrrr; '
            'print(sorted({m.split(".")[0] for m in sys.modules}))')
    mods = subprocess.run([sys.executable, '-c', code], capture_output=True, text=True,
                          cwd=main.registry.ROOT, timeout=300, check=True).stdout
    assert 'raider_tpu' not in mods and 'jax' not in mods
