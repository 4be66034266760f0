"""Coordinate reference systems: geographic and geocentric on torch tensors.

Counterpart of ``raider_tpu/geodesy/crs.py`` for the pair the delay path
uses (Geographic <-> Geocentric). Lambert conformal conic, polar
stereographic and transverse Mercator (UTM) are recognised in CF attributes
and EPSG codes but raise NotImplementedError: their port is ROADMAP item A4.
"""

from dataclasses import dataclass
from typing import Optional, Union

import numpy as np
import torch

from raider_tpu_torch.constants import WGS84_A, WGS84_INV_F

_NOT_PORTED = 'is not ported to raider_tpu_torch yet (ROADMAP A4)'


@dataclass(frozen=True)
class Ellipsoid:
    """Reference ellipsoid; ``f == 0`` means a sphere."""

    a: float = float(WGS84_A)
    f: float = 1.0 / float(WGS84_INV_F)

    @property
    def b(self) -> float:
        return self.a * (1.0 - self.f)

    def cf_attrs(self) -> dict:
        if self.f == 0.0:
            return {'earth_radius': self.a}
        return {
            'semi_major_axis': self.a,
            'semi_minor_axis': self.b,
            'inverse_flattening': 1.0 / self.f,
        }


WGS84 = Ellipsoid()


class CRS:
    """Base CRS. Subclasses provide forward/inverse maps to/from lon-lat."""

    ellipsoid: Ellipsoid = WGS84
    is_geographic: bool = False
    is_geocentric: bool = False

    def forward(self, lon, lat):
        raise NotImplementedError

    def inverse(self, x, y):
        raise NotImplementedError

    def to_cf(self) -> dict:
        raise NotImplementedError

    def to_epsg(self) -> Optional[int]:
        return None

    def __eq__(self, other) -> bool:
        return isinstance(other, CRS) and self.to_cf() == other.to_cf()

    def __hash__(self):
        return hash(tuple(sorted((k, str(v)) for k, v in self.to_cf().items())))


@dataclass(frozen=True, eq=False)
class Geographic(CRS):
    """Plain geodetic longitude/latitude (EPSG:4326 when on WGS84)."""

    ellipsoid: Ellipsoid = WGS84
    is_geographic: bool = True

    def forward(self, lon, lat):
        return lon, lat

    def inverse(self, x, y):
        return x, y

    def to_cf(self) -> dict:
        return {'grid_mapping_name': 'latitude_longitude', **self.ellipsoid.cf_attrs()}

    def to_epsg(self) -> Optional[int]:
        return 4326 if self.ellipsoid == WGS84 else None


@dataclass(frozen=True, eq=False)
class Geocentric(CRS):
    """Earth-centered earth-fixed cartesian (EPSG:4978). 3-D only."""

    ellipsoid: Ellipsoid = WGS84
    is_geocentric: bool = True

    def to_cf(self) -> dict:
        return {'grid_mapping_name': 'geocentric', **self.ellipsoid.cf_attrs()}

    def to_epsg(self) -> Optional[int]:
        return 4978 if self.ellipsoid == WGS84 else None


def crs_from_epsg(code: Union[int, str]) -> CRS:
    code = int(code)
    if code == 4326:
        return Geographic()
    if code == 4978:
        return Geocentric()
    if 32601 <= code <= 32660 or 32701 <= code <= 32760:
        raise NotImplementedError(f'UTM (EPSG:{code}) {_NOT_PORTED}')
    raise ValueError(f'Unsupported EPSG code: {code}')


def _ellipsoid_from_cf(cf: dict) -> Ellipsoid:
    def _scalar(v):
        return float(np.asarray(v).ravel()[0])

    if 'earth_radius' in cf:
        return Ellipsoid(a=_scalar(cf['earth_radius']), f=0.0)
    a = _scalar(cf.get('semi_major_axis', WGS84.a))
    if 'inverse_flattening' in cf:
        invf = _scalar(cf['inverse_flattening'])
        f = 0.0 if invf == 0 else 1.0 / invf
    elif 'semi_minor_axis' in cf:
        f = (a - _scalar(cf['semi_minor_axis'])) / a
    else:
        f = WGS84.f
    if abs(a - WGS84.a) < 1e-3 and abs(f - WGS84.f) < 1e-12:
        return WGS84
    return Ellipsoid(a=a, f=f)


def crs_from_cf(cf: dict) -> CRS:
    """Build a CRS from CF grid-mapping attributes."""
    cf = {k: (v.decode() if isinstance(v, bytes) else v) for k, v in cf.items()}
    name = cf.get('grid_mapping_name')
    if name == 'latitude_longitude':
        return Geographic(ellipsoid=_ellipsoid_from_cf(cf))
    if name == 'geocentric':
        return Geocentric(ellipsoid=_ellipsoid_from_cf(cf))
    if name in ('lambert_conformal_conic', 'polar_stereographic', 'transverse_mercator'):
        raise NotImplementedError(f'The {name} projection {_NOT_PORTED}')
    if name is None and 'crs_wkt' in cf:
        raise NotImplementedError(f'Reading a CRS from WKT {_NOT_PORTED}')
    raise ValueError(f'Unsupported CF grid mapping: {name!r}')


def crs_from_user(value) -> CRS:
    """Parse int EPSG / 'EPSG:xxxx' / CF dict / CRS instance."""
    if isinstance(value, CRS):
        return value
    if isinstance(value, int):
        return crs_from_epsg(value)
    if isinstance(value, str):
        v = value.strip()
        if v.upper().startswith('EPSG:'):
            return crs_from_epsg(v.split(':')[-1])
        if v.isdigit():
            return crs_from_epsg(v)
        raise NotImplementedError(f'Reading a CRS from WKT {_NOT_PORTED}')
    if isinstance(value, dict):
        return crs_from_cf(value)
    raise TypeError(f'Cannot interpret {value!r} as a CRS')


def transform_points(src: CRS, dst: CRS, x, y, z=None):
    """Transform coordinate tuples between two CRSs (always_xy order).

    Heights pass through unchanged except for geocentric conversions.
    """
    from raider_tpu_torch.geodesy.ellipsoid import ecef2lla, lla2ecef

    if src == dst:
        return (x, y) if z is None else (x, y, z)
    if src.is_geocentric:
        lat, lon, h = ecef2lla(x, y, z)
    else:
        lon, lat = src.inverse(x, y)
        h = z
    if dst.is_geocentric:
        if h is None:
            h = torch.zeros_like(torch.as_tensor(lon, dtype=torch.float64))
        return lla2ecef(lat, lon, h)
    xo, yo = dst.forward(lon, lat)
    return (xo, yo) if h is None else (xo, yo, h)
