"""Model-level constant tables (A/B half-level coefficients, level heights).

Published physical constants: the ECMWF IFS half-level pressure
coefficients (L137/L91/L60 tables from the IFS documentation) and nominal
level heights for ERA5/ERA-I/HRES/HRRR/pressure-level grids, stored as
compressed binary data. This package keeps its own copy of the tables of
``raider_tpu/wx/levels.py``.
"""

from functools import lru_cache
from pathlib import Path

import numpy as np

_DATA = Path(__file__).parent / 'data_model_levels.npz'


@lru_cache(maxsize=1)
def _tables() -> dict:
    with np.load(_DATA) as z:
        return {k: z[k].copy() for k in z.files}


def __getattr__(name: str) -> np.ndarray:
    tables = _tables()
    if name in tables:
        return tables[name]
    raise AttributeError(f'module {__name__!r} has no attribute {name!r}')


def available() -> list:
    return sorted(_tables().keys())
