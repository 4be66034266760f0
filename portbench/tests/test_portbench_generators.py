"""The seeded generators repeat exactly for one seed and differ between seeds
and dates."""

import numpy as np
import pytest
import torch

from _portbench_tiny import DRAWN, GRID, SEED
from portbench.harness import fields, registry, scenes


@pytest.fixture
def grid():
    cfg = registry.config(registry.benchmark(), 'hrrr_frame')
    return dict(cfg['grid'], **GRID)


def test_fields_repeat_for_one_seed(grid):
    a, b = (fields.raw_fields(grid, SEED, 1, 'cpu') for _ in range(2))
    for k in ('t', 'q', 'pres', 'z', 'lat', 'lon'):
        assert torch.equal(a[k], b[k])
    assert a['t'].dtype == torch.float32 and a['t'].shape == (12, 190, 160)
    other_date = fields.raw_fields(grid, SEED, 0, 'cpu')
    other_seed = fields.raw_fields(grid, SEED + 1, 1, 'cpu')
    assert torch.equal(other_date['z'], a['z'])          # one terrain for every date
    assert not torch.equal(other_date['t'], a['t'])
    assert not torch.equal(other_seed['z'], a['z'])


def test_scenes_repeat_for_one_seed():
    assert scenes.frames(DRAWN, None, SEED) == scenes.frames(DRAWN, None, SEED)
    assert scenes.frames(DRAWN, None, SEED) != scenes.frames(DRAWN, None, SEED + 1)
    for a, b in zip(scenes.answer_sample(SEED, 3, (20, 40, 50), 256),
                    scenes.answer_sample(SEED, 3, (20, 40, 50), 256)):
        assert np.array_equal(a, b)
    o = scenes.orbit(-103.4, 37.5, registry.traffic('ray')['orbit'])
    t, pos, vel = scenes.statevectors(o)
    assert pos[-1, 2] > pos[0, 2]                         # ascending
    np.testing.assert_allclose(np.gradient(pos, t, axis=0)[1:-1], vel[1:-1], rtol=2e-3)

