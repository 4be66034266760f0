"""Small utilities: the counterpart of ``raider_tpu/utils/misc.py``.

The UTM conversions run the port's CRSs in float64 on ``device`` (the CUDA
card unless the caller names another) and return host values.
"""

import numpy as np
import torch

from raider_tpu_torch.geodesy.crs import utm_crs
from raider_tpu_torch.utils import require_device


def sind(x):
    """Sine of degrees."""
    return np.sin(np.radians(x))


def cosd(x):
    """Cosine of degrees."""
    return np.cos(np.radians(x))


def projectDelays(delay, inc):
    """Zenith -> slant projection by cos(incidence)."""
    if np.any(np.asarray(inc) == 90):
        raise ZeroDivisionError
    return delay / cosd(inc)


def convertLons(in_lons: np.ndarray) -> np.ndarray:
    """Convert longitudes from [0, 360) to [-180, 180)."""
    mask = in_lons > 180
    out = np.array(in_lons, dtype=np.float64)
    out[mask] -= 360
    return out


def utm_zone(lon, lat) -> int:
    """UTM zone for a lon/lat, with the Norway/Svalbard exceptions."""
    if 56 <= lat < 64 and 3 <= lon < 12:
        return 32
    if 72 <= lat < 84 and 0 <= lon < 42:
        if lon < 9:
            return 31
        if lon < 21:
            return 33
        if lon < 33:
            return 35
        return 37
    return int((lon + 180) / 6) + 1


def utm_letter(lat) -> str:
    """UTM latitude band letter."""
    return 'CDEFGHJKLMNPQRSTUVWXX'[int((lat + 80) / 8)]


def _f64(a, device) -> torch.Tensor:
    return torch.as_tensor(np.asarray(a, dtype=np.float64), device=device)


def _host(t) -> np.ndarray:
    return t.cpu().numpy()


def WGS84_to_UTM(lon, lat, common_center: bool = False, *, device='cuda'):
    """Vectorized WGS84 -> UTM.

    Returns (zone, letter, x, y) arrays.
    """
    device = require_device(device)
    lon = np.atleast_1d(np.asarray(lon, dtype=np.float64))
    lat = np.atleast_1d(np.asarray(lat, dtype=np.float64))
    shp = lat.shape
    lon_f, lat_f = lon.ravel(), lat.ravel()
    if common_center:
        zones = np.full(lon_f.shape, utm_zone(np.median(lon_f), np.median(lat_f)), dtype=int)
    else:
        zones = np.array([utm_zone(lo, la) for lo, la in zip(lon_f, lat_f)])
    letters = np.array([utm_letter(la) for la in lat_f])
    x = np.empty_like(lon_f)
    y = np.empty_like(lat_f)
    for z in np.unique(zones):
        sel = zones == z
        crs = utm_crs(int(z))
        xx, yy = (_host(v) for v in crs.forward(_f64(lon_f[sel], device),
                                                _f64(lat_f[sel], device)))
        yy = np.where(yy < 0, yy + 10000000.0, yy)
        x[sel] = xx
        y[sel] = yy
    return zones.reshape(shp), letters.reshape(shp), x.reshape(shp), y.reshape(shp)


def UTM_to_WGS84(z, ltr, x, y, *, device='cuda'):
    """Vectorized UTM -> WGS84."""
    device = require_device(device)
    z = np.atleast_1d(np.asarray(z, dtype=int)).ravel()
    ltr = np.atleast_1d(np.asarray(ltr)).ravel()
    x = np.atleast_1d(np.asarray(x, dtype=np.float64))
    shp = x.shape
    x = x.ravel()
    y = np.atleast_1d(np.asarray(y, dtype=np.float64)).ravel()
    lon = np.empty_like(x)
    lat = np.empty_like(y)
    for zone in np.unique(z):
        sel = z == zone
        crs = utm_crs(int(zone))
        yy = y[sel].copy()
        south = np.array([str(b) < 'N' for b in ltr[sel]])
        yy[south] -= 10000000.0
        lo, la = (_host(v) for v in crs.inverse(_f64(x[sel], device), _f64(yy, device)))
        lon[sel] = lo
        lat[sel] = la
    return lon.reshape(shp), lat.reshape(shp)


def project(coordinates, z: int = None, ltr: str = None, *, device='cuda'):
    """Single-point WGS84 -> UTM: (zone, letter, easting, northing)
    ``coordinates`` is (lon, lat)."""
    lon, lat = float(coordinates[0]), float(coordinates[1])
    if z is None:
        z = utm_zone(lon, lat)
    if ltr is None:
        ltr = utm_letter(lat)
    device = require_device(device)
    x, y = (float(v) for v in utm_crs(int(z)).forward(_f64(lon, device), _f64(lat, device)))
    if y < 0:
        y += 10000000.0
    return z, ltr, x, y


def unproject(z: int, ltr: str, x: float, y: float, *, device='cuda'):
    """Single-point UTM -> WGS84 (lng, lat)."""
    y = float(y)
    if ltr < 'N':
        y -= 10000000.0
    device = require_device(device)
    lng, lat = (float(v) for v in utm_crs(int(z)).inverse(_f64(x, device), _f64(y, device)))
    return lng, lat
