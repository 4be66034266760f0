"""Latitude-dependent gravity / Earth-radius models and geopotential heights.

Counterpart of ``raider_tpu/geodesy/gravity.py`` on torch tensors.
"""

import torch

from raider_tpu_torch.constants import R_EARTH_MAX_WGS84 as _RMAX
from raider_tpu_torch.constants import R_EARTH_MIN_WGS84 as _RMIN
from raider_tpu_torch.constants import _g0, _g1
from raider_tpu_torch.geodesy.ellipsoid import as_f64


def get_g_ll(lats):
    """Variation of gravity with latitude [deg]."""
    c2 = torch.cos(2.0 * torch.deg2rad(as_f64(lats)))
    return float(_g1) * (1.0 - 0.002637 * c2 + 0.0000059 * c2**2)


def get_Re(lats):
    """WGS84 Earth radius as a function of geodetic latitude [deg]."""
    lats = torch.deg2rad(as_f64(lats))
    coslat = torch.cos(lats)
    sinlat = torch.sin(lats)
    return torch.sqrt(1.0 / (coslat**2 / _RMAX**2 + sinlat**2 / _RMIN**2))


def geo_to_ht(lats, hts):
    """Geopotential height -> (approximate) WGS84 ellipsoidal height:
    h = (hts Re) / (g(lat)/g0 Re - hts)."""
    lats = as_f64(lats)
    hts = as_f64(hts, lats.device)
    g_ll = get_g_ll(lats)
    re = get_Re(lats)
    return (hts * re) / (g_ll / float(_g0) * re - hts)
