"""Hand-made operands of kernel K1 (``kernel_profile.brick_contract``) with
poisoned rays, shared by the CPU test of its twin's semantics and the card
test of the kernel. Seeded numpy, no jax."""

import numpy as np
import torch

SPEC = (7, 3, 3)                 # planes, wy, wx: width 126
DZOS = (0, 1, 1, 2, 3, 4)        # plane 6 is touched by no sample
UNTOUCHED = (6 * 18 + 2, 6 * 18 + 11)   # a wet and a hydro lane of plane 6
# ray -> (what is poisoned, the twin's (wet, hydro): 'nan', 'inf' or 'finite')
CASES = {
    1: ('wte NaN', ('nan', 'nan')),
    2: ('fz +inf', ('nan', 'nan')),
    3: ('gx NaN', ('nan', 'nan')),
    4: ('gy +inf', ('finite', 'finite')),
    5: ('gy -inf', ('finite', 'finite')),
    6: ('brick NaN on an untouched lane', ('nan', 'nan')),
    7: ('brick inf on an untouched lane', ('nan', 'nan')),
    8: ('brick inf on a touched wet lane', ('inf', 'nan')),
}


def contract_case(n: int = 16, seed: int = 0, device='cpu', dzos=DZOS, poison: bool = True):
    """(brick (n, 126), scal (n, 4S), dzos) at spec (7, 3, 3): bricks in
    0.1-100, gy, gx in [0, 2], fz in [0, 1], wte in [0.5, 2]; with
    ``poison``, rays 1-8 carry the cases of ``CASES`` (n >= 9; with other
    ``dzos``, sample indices taken modulo S)."""
    planes, wy, wx = SPEC
    rng = np.random.default_rng(seed)
    S = len(dzos)
    brick = rng.uniform(0.1, 100.0, (n, planes * wy * wx * 2)).astype(np.float32)
    scal = np.stack([rng.uniform(0.0, 2.0, (n, S)), rng.uniform(0.0, 2.0, (n, S)),
                     rng.uniform(0.0, 1.0, (n, S)), rng.uniform(0.5, 2.0, (n, S))],
                    axis=-1).reshape(n, 4 * S).astype(np.float32)
    if poison:
        scal[1, 4 * (2 % S) + 3] = np.nan     # wte of sample 2
        scal[2, 4 * 0 + 2] = np.inf           # fz of sample 0
        scal[3, 4 * (4 % S) + 1] = np.nan     # gx of sample 4
        scal[4, 4 * (1 % S) + 0] = np.inf     # gy of sample 1
        scal[5, 4 * (3 % S) + 0] = -np.inf    # gy of sample 3
        brick[6, UNTOUCHED[0]] = np.nan
        brick[7, UNTOUCHED[1]] = np.inf
        # lane 0 (plane 0, dy = dx = 0, wet): sample 0 gives it U > 0
        scal[8, 0:2] = 0.25
        brick[8, 0] = np.inf
    return (torch.as_tensor(brick, device=device), torch.as_tensor(scal, device=device),
            tuple(dzos))
