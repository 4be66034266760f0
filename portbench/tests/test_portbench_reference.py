"""The check that decides ``correct``: the reference agrees with the port's
``tropo_delay`` on the CPU in float64 at a tiny size, its control (the
reference with its stored fields in bfloat16) fails the same limits, and a
run of each scene whose timed path is broken comes out not correct."""

import json

import numpy as np
import pytest
import torch

from _portbench_tiny import SEED, SHAPES, WORKLOAD, StepClock, overrides, run
from portbench import control
from portbench.harness import main, registry
from portbench.reference import hrrr as ref


@pytest.mark.parametrize('shape', SHAPES)
def test_reference_agrees_with_the_port(shape, capsys):
    rc, out, _ = run(shape, capsys)
    checks = json.loads(out[-1])['checks']
    assert rc == 0 and all(c['value'] <= c['limit'] for c in checks.values()), checks


@pytest.mark.parametrize('shape', SHAPES)
def test_control_fails(shape):
    checks = control.control(WORKLOAD, SEED, 2, device='cpu', overrides=overrides(shape))
    assert any(c['value'] > c['limit'] for c in checks.values()), checks


def _break(answers, fault: str, last: dict):
    """``answers`` (wet, hydro host arrays, the pixels' axis last) as
    ``fault`` leaves them."""
    wet, hyd = answers
    if fault == 'stale':                      # the previous request's answer again
        prev = last.get('out', (wet, hyd))
        last['out'] = (wet, hyd)
        return prev
    wet, hyd = wet.copy(), hyd.copy()
    if fault == 'half':                       # half of the pixels left out
        wet[..., ::2] = 0.0
        hyd[..., ::2] = 0.0
    elif fault == 'altered':                  # answers altered by 1 mm where produced
        wet[-1] += 1e-3
    return wet, hyd


def _broken(monkeypatch, fault: str):
    """Break the timed path where the engine produces the answers: the
    raytraced cube."""
    from raider_tpu_torch.delay import engine

    own = engine._build_cube_ray
    last = {}

    def broken(*args, **kwargs):
        return _break(own(*args, **kwargs), fault, last)

    monkeypatch.setattr(engine, '_build_cube_ray', broken)


@pytest.mark.parametrize('fault', ['stale', 'half', 'altered'])
@pytest.mark.parametrize('shape', SHAPES)
def test_a_broken_timed_path_is_not_correct(shape, fault, monkeypatch, capsys):
    _broken(monkeypatch, fault)
    monkeypatch.setattr(main, 'time', StepClock())      # four requests on any CPU
    rc, out, _ = run(shape, capsys, seconds=1.0)
    res = json.loads(out[-1])
    assert rc == 0 and res['attempted'] >= 2 and res['correct'] is False, res['checks']


def test_lambert_conformal_matches_the_port():
    from raider_tpu_torch.wx.hrrr import HRRR_CONUS_PROJ

    cf = registry.config(registry.benchmark(), 'hrrr_frame')['grid']['crs_cf']
    lat = torch.linspace(21.0, 50.0, 97, dtype=torch.float64)[:, None].expand(97, 101)
    lon = torch.linspace(-130.0, -62.0, 101, dtype=torch.float64)[None, :].expand(97, 101)
    mine = ref.LambertConformal(cf)
    x, y = mine.forward(lat, lon)
    px, py = HRRR_CONUS_PROJ.forward(lon, lat)
    assert float((x - px).abs().max()) < 1e-6 and float((y - py).abs().max()) < 1e-6
    blat, blon = mine.inverse(x, y)
    assert float((blat - lat).abs().max()) < 1e-10 and float((blon - lon).abs().max()) < 1e-10


def test_geodesy_round_trip():
    lat = torch.linspace(-80.0, 80.0, 41, dtype=torch.float64)
    lon = torch.linspace(-179.0, 179.0, 41, dtype=torch.float64)
    h = torch.linspace(-500.0, 30000.0, 41, dtype=torch.float64)
    blat, blon, bh = ref.ecef_to_geodetic(ref.geodetic_to_ecef(lat, lon, h))
    assert float((blat - lat).abs().max()) < 1e-11 and float((bh - h).abs().max()) < 1e-6
    assert np.allclose(blon.numpy(), lon.numpy(), atol=1e-11)
