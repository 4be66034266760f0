"""Stage timers and traces: raider_tpu_torch.utils.profiling vs raider_tpu's (CPU).

The timers accumulate and report as the JAX package's do; ``device_trace``
writes a Chrome trace on the CPU; and after the same small zenith and
raytraced ``tropo_delay`` in both packages (tests/test_torch_slice.py's
scene), the port reports every stage name the JAX package does. The port
has one geometry branch, so it also reports ``raytrace.device_geometry``,
the name of the JAX package's device-geometry branch (which its CPU run
does not take): the profiling module's docstring says so.
"""

import json
import os
import time

import numpy as np
import pytest

from raider_tpu.delay import engine as j_engine
from raider_tpu.geometry.aoi import BoundingBox as JBox
from raider_tpu.geometry.los import Raytracing as JRay
from raider_tpu.geometry.los import Zenith as JZen
from raider_tpu.utils import profiling as j_prof
from raider_tpu_torch.convert import dataset_from_reference, orbit_from_reference
from raider_tpu_torch.delay import engine as t_engine
from raider_tpu_torch.geometry import BoundingBox, Raytracing, Zenith
from raider_tpu_torch.utils import profiling as t_prof

from tests.test_orbit import synthetic_orbit
from tests.test_torch_slice import BBOX, HEIGHTS, T0, wm_dataset  # noqa: F401 (fixture)

PORT_ONLY = {'raytrace.device_geometry'}


def test_stage_report_and_reset(caplog):
    t_prof.stage_report(reset=True)
    for _ in range(3):
        with t_prof.stage('a.x'):
            time.sleep(0.002)
    with t_prof.stage('b.y', log=False):
        pass
    with pytest.raises(RuntimeError), t_prof.stage('c.err'):
        raise RuntimeError('timed all the same')
    rep = t_prof.stage_report()
    assert set(rep) == {'a.x', 'b.y', 'c.err'}
    assert rep['a.x']['calls'] == 3 and rep['a.x']['total_s'] >= 0.006
    assert rep['a.x']['mean_s'] == pytest.approx(rep['a.x']['total_s'] / 3)
    assert set(rep['b.y']) == {'total_s', 'calls', 'mean_s'}
    import logging

    caplog.set_level(logging.INFO, logger='raider_tpu_torch')
    t_prof.log_stage_report()
    assert 'stage timing report' in caplog.text and 'a.x' in caplog.text
    assert set(t_prof.stage_report(reset=True)) == {'a.x', 'b.y', 'c.err'}
    assert t_prof.stage_report() == {}


def test_device_trace_and_annotate(tmp_path):
    import torch

    with t_prof.device_trace(None):
        pass
    assert not os.listdir(tmp_path)
    with t_prof.device_trace(str(tmp_path / 'trace')):
        with t_prof.annotate('port.region'):
            torch.ones(64).cumsum(0)
    path = tmp_path / 'trace' / 'trace.json'
    events = json.loads(path.read_text())['traceEvents']
    assert any(e.get('name') == 'port.region' for e in events)


def test_stage_names_match_jax(wm_dataset):
    orbit = synthetic_orbit(T0)
    names = {}
    for tag in ('jax', 'port'):
        prof = j_prof if tag == 'jax' else t_prof
        prof.stage_report(reset=True)
        for los in ('zenith', 'raytracing'):
            if tag == 'jax':
                j_engine.tropo_delay(T0, wm_dataset, JBox(BBOX, cube_spacing_in_m=20000.0),
                                     JZen() if los == 'zenith' else JRay(orbit=orbit, time=T0),
                                     height_levels=HEIGHTS, compute_dtype=np.float64)
            else:
                t_engine.tropo_delay(
                    T0, dataset_from_reference(wm_dataset),
                    BoundingBox(BBOX, cube_spacing_in_m=20000.0),
                    Zenith() if los == 'zenith' else Raytracing(orbit=orbit_from_reference(orbit),
                                                                 time=T0),
                    height_levels=HEIGHTS, compute_dtype=np.float64, device='cpu')
        names[tag] = prof.stage_report(reset=True)
    assert set(names['port']) - PORT_ONLY == set(names['jax'])
    assert set(names['jax']) >= {'delay.ztd_cube', 'delay.raytrace_cube', 'raytrace.look_vectors',
                                 'raytrace.build_ray', 'raytrace.integrate',
                                 'raytrace.final_fetch'}
    rep = names['port']
    for k in ('raytrace.device_geometry', 'raytrace.look_vectors', 'raytrace.build_ray',
              'raytrace.integrate'):
        assert rep[k]['calls'] == len(HEIGHTS), k
    assert rep['delay.ztd_cube']['calls'] == rep['delay.raytrace_cube']['calls'] == 1
    # nesting: a slice's geometry holds its look vectors and intersections,
    # and the cube every raytrace stage
    geom = rep['raytrace.device_geometry']['total_s']
    assert rep['raytrace.look_vectors']['total_s'] + rep['raytrace.build_ray']['total_s'] <= geom
    inner = sum(rep[k]['total_s'] for k in ('raytrace.device_geometry', 'raytrace.integrate',
                                            'raytrace.final_fetch'))
    assert inner <= rep['delay.raytrace_cube']['total_s']
