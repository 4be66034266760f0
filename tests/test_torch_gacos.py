"""GACOS headers: raider_tpu_torch.workflows.gacos vs raider_tpu's (CPU).

Both packages write the .vrt and ENVI .hdr of the same seeded .ztd grid;
the texts are identical, and the port's ENVI reader reads the grid back
with its geotransform.
"""

import os
import shutil
import subprocess
import sys

import numpy as np
import pytest

from raider_tpu.workflows import gacos as j_gacos
from raider_tpu_torch.io import read_envi
from raider_tpu_torch.workflows import gacos as t_gacos

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
RSC = {'WIDTH': 37, 'FILE_LENGTH': 23, 'X_FIRST': -118.4, 'Y_FIRST': 34.2,
       'X_STEP': 0.008333333, 'Y_STEP': -0.008333333}


def write_ztd(path, seed=0):
    """A GACOS grid: FILE_LENGTH x WIDTH float32, little-endian, with its
    .rsc sidecar."""
    rng = np.random.default_rng(seed)
    grid = rng.uniform(2.2, 2.5, (RSC['FILE_LENGTH'], RSC['WIDTH'])).astype('<f4')
    grid.tofile(path)
    with open(str(path) + '.rsc', 'w') as f:
        for k, v in RSC.items():
            f.write(f'{k:<14}{v}\n')
    return grid


@pytest.mark.parametrize('dtype', ['Float32', 'Float64'])
def test_headers_match_and_read_back(tmp_path, dtype):
    out = {}
    for tag, mod in (('jax', j_gacos), ('port', t_gacos)):
        os.makedirs(tmp_path / tag)
        grid = write_ztd(tmp_path / tag / '20200130.ztd')
        out[tag] = mod.makeVRT(tmp_path / tag / '20200130.ztd', dtype=dtype)
        assert out[tag] == str(tmp_path / tag / '20200130.ztd.vrt')
    for ext in ('.vrt', '.hdr'):
        assert ((tmp_path / 'port' / f'20200130.ztd{ext}').read_text()
                == (tmp_path / 'jax' / f'20200130.ztd{ext}').read_text())
    data, prof = read_envi(str(tmp_path / 'port' / '20200130.ztd'))
    np.testing.assert_array_equal(data[0], np.fromfile(tmp_path / 'port' / '20200130.ztd', '<f4')
                                  .reshape(grid.shape))
    assert (prof['width'], prof['height']) == (RSC['WIDTH'], RSC['FILE_LENGTH'])
    assert tuple(prof['transform'])[:6] == (RSC['X_FIRST'], RSC['X_STEP'], 0.0,
                                            RSC['Y_FIRST'], 0.0, RSC['Y_STEP'])


def test_parse_rsc_and_cli(tmp_path, capsys):
    write_ztd(tmp_path / 'a.ztd', seed=1)
    assert t_gacos.parse_rsc(tmp_path / 'a.ztd.rsc') == j_gacos.parse_rsc(tmp_path / 'a.ztd.rsc')
    shutil.copy(tmp_path / 'a.ztd', tmp_path / 'b.ztd')
    shutil.copy(tmp_path / 'a.ztd.rsc', tmp_path / 'b.ztd.rsc')
    t_gacos.main([str(tmp_path / 'a.ztd'), str(tmp_path / 'b.ztd')])
    assert capsys.readouterr().out.split() == [str(tmp_path / f'{n}.ztd.vrt') for n in 'ab']
    res = subprocess.run([sys.executable, '-m', 'raider_tpu_torch.workflows.gacos',
                          str(tmp_path / 'a.ztd')], cwd=REPO, capture_output=True, text=True,
                         timeout=120)
    assert res.returncode == 0 and res.stdout.strip() == str(tmp_path / 'a.ztd.vrt'), res.stderr
