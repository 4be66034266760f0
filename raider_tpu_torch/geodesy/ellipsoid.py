"""WGS84 ellipsoid transforms on torch tensors (float64 on the device).

Counterpart of ``raider_tpu/geodesy/ellipsoid.py``. Inputs may be tensors
(computed on their own device) or array-likes (made into float64 CPU
tensors). Angles are degrees.
"""

import torch

from raider_tpu_torch.constants import WGS84_A, WGS84_E2

_A = float(WGS84_A)
_E2 = float(WGS84_E2)


def as_f64(x, device=None) -> torch.Tensor:
    """``x`` as a float64 tensor: a tensor stays on its device (or moves to
    ``device`` when one is given), anything else is created on ``device``
    (the CPU when None)."""
    if isinstance(x, torch.Tensor):
        return x.to(dtype=torch.float64, device=device if device is not None else x.device)
    return torch.as_tensor(x, dtype=torch.float64, device=device)


def lla2ecef(lat, lon, height):
    """Geodetic lat/lon/height [deg, deg, m] -> ECEF x/y/z [m]."""
    lat = torch.deg2rad(as_f64(lat))
    lon = torch.deg2rad(as_f64(lon, lat.device))
    height = as_f64(height, lat.device)
    sin_lat = torch.sin(lat)
    cos_lat = torch.cos(lat)
    n = _A / torch.sqrt(1.0 - _E2 * sin_lat**2)
    x = (n + height) * cos_lat * torch.cos(lon)
    y = (n + height) * cos_lat * torch.sin(lon)
    z = (n * (1.0 - _E2) + height) * sin_lat
    return x, y, z


def ecef2lla(x, y, z):
    """ECEF x/y/z [m] -> geodetic lat/lon/height [deg, deg, m].

    Closed form (Vermeille 2002), as in the JAX package. torch has no cbrt:
    its argument ``1 + s + sqrt(s (2 + s))`` is >= 1 (s >= 0 off the
    Earth's centre), so ``pow(., 1/3)`` is the real cube root there.
    """
    x = as_f64(x)
    y = as_f64(y, x.device)
    z = as_f64(z, x.device)
    a2 = _A * _A
    e2 = _E2
    e4 = e2 * e2

    xy2 = x * x + y * y
    p = xy2 / a2
    q = (1.0 - e2) * z * z / a2
    r = (p + q - e4) / 6.0
    s = e4 * p * q / (4.0 * r**3)
    t = torch.pow(1.0 + s + torch.sqrt(s * (2.0 + s)), 1.0 / 3.0)
    u = r * (1.0 + t + 1.0 / t)
    v = torch.sqrt(u * u + e4 * q)
    w = e2 * (u + v - q) / (2.0 * v)
    k = torch.sqrt(u + v + w * w) - w
    big_d = k * torch.sqrt(xy2) / (k + e2)

    hyp = torch.sqrt(big_d * big_d + z * z)
    lat = 2.0 * torch.atan2(z, big_d + hyp)
    height = (k + e2 - 1.0) / k * hyp
    lon = torch.atan2(y, x)
    return torch.rad2deg(lat), torch.rad2deg(lon), height


def geodetic_normal(lat, lon):
    """Unit outward ellipsoid-normal vector (= zenith look vector), (..., 3)."""
    lat = torch.deg2rad(as_f64(lat))
    lon = torch.deg2rad(as_f64(lon, lat.device))
    return torch.stack([torch.cos(lat) * torch.cos(lon),
                        torch.cos(lat) * torch.sin(lon),
                        torch.sin(lat)], dim=-1)
