"""ECMWF hydrostatic model-level integration on torch tensors.

Counterpart of ``raider_tpu/wx/calcgeoh.py``: pressure, geopotential and
geopotential height on model levels from the log surface pressure and the
A/B half-level coefficients, a bottom-up scan over levels in float64 on the
fields' device.
"""

from typing import Tuple

import numpy as np
import torch

from raider_tpu_torch.constants import _g0
from raider_tpu_torch.geodesy.ellipsoid import as_f64


def calcgeoh(lnsp, t, q, z, a, b, R_d, num_levels) -> Tuple[torch.Tensor, torch.Tensor,
                                                             torch.Tensor]:
    """Integrate the hydrostatic equation up model levels.

    Args:
        lnsp: (y, x) log surface pressure
        t, q: (z, y, x) temperature [K] and specific humidity, level 0 = top
        z:    (y, x) or scalar surface geopotential
        a, b: (nz+1,) half-level pressure coefficients
        R_d:  dry-air gas constant
        num_levels: number of full model levels

    Returns:
        (geopotential, pressure, geopotential height), each (z, y, x), on
        ``t``'s device.
    """
    t = as_f64(t)
    dev = t.device
    q = as_f64(q, dev)
    if len(a) != num_levels + 1 or len(b) != num_levels + 1:
        raise ValueError(
            f'Model has {num_levels} levels but a/b have lengths {len(a)}/{len(b)} '
            '(they must be num_levels + 1).')
    a = as_f64(np.asarray(a, dtype=np.float64), dev)
    b = as_f64(np.asarray(b, dtype=np.float64), dev)
    sp = torch.exp(as_f64(lnsp, dev))
    z = as_f64(z, dev)

    # virtual ("moist") temperature on all levels
    t_v = t * (1 + 0.609133 * q)
    # half-level pressures Ph[k] = a[k] + b[k] * sp, k = 0..num_levels
    ph = a[:, None, None] + b[:, None, None] * sp[None, :, :]

    geopotential = torch.zeros_like(t)
    pressurelvs = torch.zeros_like(t)
    geoheight = torch.zeros_like(t)
    z_h = 0.0  # geopotential of the lower half level, integrated upward
    for lev in range(num_levels, 0, -1):
        ilevel = lev - 1
        ph_lev = ph[lev - 1]
        ph_levplusone = ph[lev]
        pressurelvs[ilevel] = ph_lev
        if lev == 1:
            dlogp = torch.log(ph_levplusone / 0.1)
            alpha = float(np.log(2))
        else:
            dlogp = torch.log(ph_levplusone) - torch.log(ph_lev)
            alpha = 1 - (ph_lev / (ph_levplusone - ph_lev)) * dlogp
        trd = t_v[ilevel] * R_d
        geopotential[ilevel] = z_h + trd * alpha + z
        geoheight[ilevel] = geopotential[ilevel] / float(_g0)
        z_h = z_h + trd * dlogp
    return geopotential, pressurelvs, geoheight
