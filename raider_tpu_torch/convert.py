"""Moving state from the JAX package into this one, without importing it.

The system has no learned weights: its state is the processed weather
dataset and the orbit. These helpers duck-type the JAX package's objects
(``.coords``/``.variables`` of items with ``.dims``, ``.data`` and
``.attrs``; an orbit's ``times``/``pos``/``vel``/``ref_time``; a CRS's
``to_cf()``), so both packages can compute on identical inputs.
"""

import numpy as np

from raider_tpu_torch.geodesy.crs import CRS, crs_from_cf
from raider_tpu_torch.geometry.orbit import Orbit
from raider_tpu_torch.io import Dataset, Variable


def _var(v) -> Variable:
    data = np.array(v.data) if np.ndim(v.data) else v.data
    return Variable(tuple(v.dims), data, dict(v.attrs))


def dataset_from_reference(ds) -> Dataset:
    """A copy of a JAX-package ``Dataset`` as this package's ``Dataset``."""
    return Dataset(coords={k: _var(v) for k, v in ds.coords.items()},
                   variables={k: _var(v) for k, v in ds.variables.items()},
                   attrs=dict(ds.attrs))


def orbit_from_reference(orbit) -> Orbit:
    """A copy of a JAX-package ``Orbit`` as this package's ``Orbit``."""
    return Orbit(times=np.array(orbit.times, dtype=np.float64),
                 pos=np.array(orbit.pos, dtype=np.float64),
                 vel=np.array(orbit.vel, dtype=np.float64),
                 ref_time=orbit.ref_time)


def crs_from_reference(crs) -> CRS:
    """A JAX-package CRS as this package's, through its CF attributes (a UTM
    zone number, which CF does not carry, is not kept)."""
    return crs_from_cf(crs.to_cf())
