"""raiderStats' device reductions (``raider_tpu_torch.workflows.stats``) on
the CPU and, marked ``cuda``, on the card, against numpy.

This file imports neither jax nor raider_tpu, so it also runs on a machine
with the card and without jax:

    python -m pytest tests/test_torch_stats_device.py --noconftest -p no:cacheprovider -q
"""

import numpy as np
import pytest
import torch

from raider_tpu_torch.workflows import stats as T


@pytest.mark.parametrize('device', ['cpu', pytest.param('cuda', marks=pytest.mark.cuda)])
def test_group_sums_are_bincount_bit_for_bit(device):
    """The group-by sums are numpy's ``bincount`` sums bit for bit, on the
    CPU and on the card: they rest on ``torch.segment_reduce`` adding each
    segment of 2-D data in row order (on CUDA, 1-D data takes a tree
    reduction instead), which PyTorch does not document, so a torch
    upgrade that changes it fails here first."""
    if device == 'cuda' and not torch.cuda.is_available():
        pytest.skip('needs an NVIDIA GPU with CUDA')
    rng = np.random.default_rng(11)
    n = 8
    sizes = np.array([0, 1, 2, 7, 1000, 65_537, 3, 150_000])
    keys = np.repeat(np.arange(n), sizes)
    rng.shuffle(keys)
    vals = rng.normal(2.3, 0.05, (keys.size, 3)) * 10.0 ** rng.integers(-3, 4, (keys.size, 1))
    groups = T._Groups(torch.as_tensor(keys, device=device), n)
    got = groups.sum(torch.as_tensor(vals, device=device)).cpu().numpy()
    for k in range(vals.shape[1]):
        want = np.bincount(keys, weights=vals[:, k], minlength=n)
        assert np.array_equal(got[:, k], want), k
