"""Device compute primitives: interpolation, integration, the ZTD kernel."""

from raider_tpu_torch.ops.interp import (  # noqa: F401
    contract_yx,
    contract_z,
    grid_weights,
    interp3d_points,
    interp3d_separable,
    interp_along_axis,
)
from raider_tpu_torch.ops.integrate import cumtrapz_from_top  # noqa: F401
from raider_tpu_torch.ops.ztd import ztd_totals, ztd_totals_ref  # noqa: F401
