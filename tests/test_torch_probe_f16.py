"""16-bit row probes: the twins of kernels S4 and S5 vs the JAX probe (CPU).

  * S4 (``probe_load``): the twin against the probe's own numpy check,
    ``x[:, ::16].sum(axis=1) * 0.5`` (scripts/probe_f16.py:78), for bf16,
    f16 and int16 blocks;
  * S5 (``probe_bitcast_i16_bf16``): the twin against the Pallas kernel's
    body as plain JAX, ``bitcast_convert_type(raw, bfloat16).astype(float32)``.

Both exact at N = 4096 rows: every conversion is exact, and the S4 sums of
these blocks round identically in either order.
"""

import json

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from raider_tpu_torch import kernels
from raider_tpu_torch.scripts import probe_f16

N = 4096
DTYPES = {'bf16': (jnp.bfloat16, torch.bfloat16), 'f16': (np.float16, torch.float16),
          'i16': (np.int16, torch.int16)}


def _block(np_dtype):
    """The probe's block (probe_f16.py:42-50) at N rows, made with numpy."""
    v = np.arange(N * probe_f16.WIDTH, dtype=np.float32).reshape(N, probe_f16.WIDTH)
    v = np.sin(v * np.float32(1e-3)) * np.float32(100.0)
    if np_dtype == np.int16:
        return np.round(v * 100.0).astype(np.int16)
    return v.astype(np_dtype)


def _to_torch(x, torch_dtype):
    # torch has no numpy bfloat16: hand over the bits
    return torch.from_numpy(x.view(np.int16)).view(torch_dtype)


@pytest.mark.parametrize('name', list(DTYPES))
def test_probe_load_twin_matches_numpy_check(name):
    np_dtype, torch_dtype = DTYPES[name]
    x = _block(np_dtype)
    want = np.asarray(x, np.float32)[:, ::16].sum(axis=1) * 0.5
    before = dict(kernels.LAUNCHES)
    got = probe_f16.probe_load(_to_torch(x, torch_dtype))
    assert kernels.LAUNCHES == before
    assert got.dtype == torch.float32 and got.shape == (N,)
    np.testing.assert_array_equal(got.numpy(), want)
    np.testing.assert_array_equal(probe_f16.probe_load_ref(_to_torch(x, torch_dtype)).numpy(), want)


def test_probe_bitcast_twin_matches_jax():
    vals = _block(jnp.bfloat16)
    raw = jax.lax.bitcast_convert_type(jnp.asarray(vals), jnp.int16)
    want = np.asarray(jax.lax.bitcast_convert_type(raw, jnp.bfloat16).astype(jnp.float32))
    got = probe_f16.probe_bitcast_i16_bf16(torch.from_numpy(np.array(raw)))
    assert got.dtype == torch.float32 and got.shape == (N, probe_f16.WIDTH)
    np.testing.assert_array_equal(got.numpy(), want)
    np.testing.assert_array_equal(want, np.asarray(vals, np.float32))


@pytest.mark.parametrize('bad', ['width', 'dtype', 'rank'])
def test_probe_wrappers_reject_bad_blocks(bad):
    x = torch.zeros((8, probe_f16.WIDTH), dtype=torch.int16)
    x = dict(width=x[:, :64], dtype=x.float(), rank=x[0])[bad]
    with pytest.raises(ValueError):
        probe_f16.probe_load(x)
    with pytest.raises(ValueError):
        probe_f16.probe_bitcast_i16_bf16(x)


def test_probe_run_on_the_cpu():
    """The entry point's probe loop at a small size: twins only, no timing."""
    lines = []
    records = probe_f16.run('cpu', n=256, say=lines.append)
    assert [json.loads(s) for s in lines] == records
    assert [next(iter(r)) for r in records] == ['probe_load_bf16', 'probe_load_f16',
                                                'probe_load_i16', 'bitcast_i16_bf16']
    assert all(r['max_abs_err'] == 0.0 for r in records)
