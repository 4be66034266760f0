"""Coordinate reference systems as closed-form transforms on torch tensors.

Counterpart of ``raider_tpu/geodesy/crs.py``. Each projection is a small
immutable object with ``forward(lon, lat) -> (x, y)`` and
``inverse(x, y) -> (lon, lat)`` maps in float64 on the inputs' device (a
tensor stays where it is; anything else becomes a CPU tensor):

  * Geographic (EPSG:4326)                     - ERA5/ERA5T/ERA-I/HRES/GMAO/MERRA2/NCMR
  * Geocentric ECEF (EPSG:4978)                - ray geometry
  * Lambert conformal conic (sphere/ellipsoid) - HRRR CONUS, WRF
  * Polar stereographic                        - HRRR Alaska
  * Transverse Mercator / UTM                  - projected outputs

Angles at the public API are degrees. Math follows Snyder (1987), "Map
Projections: A Working Manual"; the inverse series iterate a fixed number of
times. Projection constants are computed on Python floats with numpy, as the
JAX package computes them, so both packages start from the same bits.
"""

import re
from dataclasses import dataclass
from typing import Optional, Union

import numpy as np
import torch

from raider_tpu_torch.constants import WGS84_A, WGS84_INV_F
from raider_tpu_torch.geodesy.ellipsoid import as_f64

_QUARTER_PI = np.pi / 4.0


@dataclass(frozen=True)
class Ellipsoid:
    """Reference ellipsoid; ``f == 0`` means a sphere."""

    a: float = float(WGS84_A)
    f: float = 1.0 / float(WGS84_INV_F)

    @property
    def b(self) -> float:
        return self.a * (1.0 - self.f)

    @property
    def e2(self) -> float:
        return self.f * (2.0 - self.f)

    @property
    def e(self) -> float:
        return float(np.sqrt(self.e2))

    def cf_attrs(self) -> dict:
        if self.f == 0.0:
            return {'earth_radius': self.a}
        return {
            'semi_major_axis': self.a,
            'semi_minor_axis': self.b,
            'inverse_flattening': 1.0 / self.f,
        }

    def wkt_spheroid(self) -> str:
        """WKT1 SPHEROID fragment (inverse flattening 0 encodes a sphere)."""
        name = 'WGS 84' if self == WGS84 else ('sphere' if self.f == 0.0 else 'ellipsoid')
        inv_f = 0.0 if self.f == 0.0 else 1.0 / self.f
        return f'SPHEROID["{name}",{self.a!r},{inv_f!r}]'


WGS84 = Ellipsoid()
SPHERE_6371229 = Ellipsoid(a=6371229.0, f=0.0)  # NCEP sphere (HRRR grids)


def _pair(x, y):
    """``x`` and ``y`` as float64 tensors on ``x``'s device."""
    x = as_f64(x)
    return x, as_f64(y, x.device)


def _norm_lon(lon_deg):
    """Longitudes in [-180, 180), the PROJ convention for inverse
    projections: with lon_0 far from 0 (HRRR's 262.5, HRRR-AK's 225) an
    inverse would otherwise return (lon_0 - 180, lon_0 + 180]."""
    return torch.remainder(lon_deg + 180.0, 360.0) - 180.0


def _conformal_t(lat_rad, e):
    """Snyder eq. 15-9: isometric colatitude function t(phi)."""
    s = torch.sin(lat_rad)
    return torch.tan(_QUARTER_PI - lat_rad / 2.0) / ((1.0 - e * s) / (1.0 + e * s)) ** (e / 2.0)


def _inv_conformal_t(t, e, iterations: int = 12):
    """Invert t(phi) by fixed-point iteration (Snyder eq. 7-9)."""
    lat = np.pi / 2.0 - 2.0 * torch.atan(t)
    for _ in range(iterations):
        s = torch.sin(lat)
        lat = np.pi / 2.0 - 2.0 * torch.atan(t * ((1.0 - e * s) / (1.0 + e * s)) ** (e / 2.0))
    return lat


def _m_factor(lat_rad, e2):
    """Snyder eq. 14-15: m = cos(phi)/sqrt(1 - e^2 sin^2 phi)."""
    return torch.cos(lat_rad) / torch.sqrt(1.0 - e2 * torch.sin(lat_rad) ** 2)


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

    def _geogcs_wkt(self) -> str:
        """The GEOGCS block shared by geographic and projected WKT1."""
        name = 'WGS 84' if self.ellipsoid == WGS84 else 'unnamed'
        return (f'GEOGCS["{name}",DATUM["{name.replace(" ", "_")}",'
                f'{self.ellipsoid.wkt_spheroid()}],'
                'PRIMEM["Greenwich",0],UNIT["degree",0.0174532925199433]]')

    def to_wkt(self) -> str:
        """WKT1 string for this CRS (round-trips through crs_from_wkt)."""
        raise NotImplementedError

    def _projcs_wkt(self, name: str, projection: str, params: dict) -> str:
        plist = ','.join(f'PARAMETER["{k}",{float(v)!r}]' for k, v in params.items())
        return (f'PROJCS["{name}",{self._geogcs_wkt()},'
                f'PROJECTION["{projection}"],{plist},UNIT["metre",1]]')

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

    def to_wkt(self) -> str:
        return self._geogcs_wkt()


@dataclass(frozen=True, eq=False)
class Geocentric(CRS):
    """Earth-centered earth-fixed cartesian (EPSG:4978). 3-D only."""

    ellipsoid: Ellipsoid = WGS84
    is_geocentric: bool = True

    def to_cf(self) -> dict:
        return {'grid_mapping_name': 'geocentric', **self.ellipsoid.cf_attrs()}

    def to_epsg(self) -> Optional[int]:
        return 4978 if self.ellipsoid == WGS84 else None

    def to_wkt(self) -> str:
        name = 'WGS 84' if self.ellipsoid == WGS84 else 'unnamed'
        return (f'GEOCCS["{name}",DATUM["{name.replace(" ", "_")}",'
                f'{self.ellipsoid.wkt_spheroid()}],'
                'PRIMEM["Greenwich",0],UNIT["metre",1]]')


@dataclass(frozen=True, eq=False)
class LambertConformalConic(CRS):
    """Lambert conformal conic, 1 or 2 standard parallels (Snyder ch. 15).

    HRRR CONUS uses it on a sphere of radius 6371229 m with
    lat_1 = lat_2 = lat_0 = 38.5, lon_0 = 262.5.
    """

    lat_0: float = 0.0
    lon_0: float = 0.0
    lat_1: float = 0.0
    lat_2: Optional[float] = None
    x_0: float = 0.0
    y_0: float = 0.0
    ellipsoid: Ellipsoid = WGS84

    def _params(self):
        """Projection constants, numpy on Python floats."""
        e = self.ellipsoid.e
        e2 = self.ellipsoid.e2
        a = self.ellipsoid.a

        def m_np(phi):
            s = np.sin(phi)
            return np.cos(phi) / np.sqrt(1.0 - e2 * s * s)

        def t_np(phi):
            s = np.sin(phi)
            return np.tan(_QUARTER_PI - phi / 2.0) / ((1.0 - e * s) / (1.0 + e * s)) ** (e / 2.0)

        phi1 = np.deg2rad(self.lat_1)
        phi2 = np.deg2rad(self.lat_2 if self.lat_2 is not None else self.lat_1)
        phi0 = np.deg2rad(self.lat_0)
        m1 = float(m_np(phi1))
        t1 = float(t_np(phi1))
        if abs(phi1 - phi2) < 1e-12:
            n = float(np.sin(phi1))
        else:
            n = float(np.log(m1 / float(m_np(phi2))) / np.log(t1 / float(t_np(phi2))))
        big_f = m1 / (n * t1**n)
        rho0 = a * big_f * float(t_np(phi0)) ** n
        return e, a, n, big_f, rho0

    def forward(self, lon, lat):
        lon, lat = _pair(lon, lat)
        e, a, n, big_f, rho0 = self._params()
        t = _conformal_t(torch.deg2rad(lat), e)
        rho = a * big_f * t**n
        dlon = torch.deg2rad(lon - self.lon_0)
        # wrap to [-180, 180) so cones spanning the antimeridian behave
        dlon = torch.remainder(dlon + np.pi, 2.0 * np.pi) - np.pi
        theta = n * dlon
        x = rho * torch.sin(theta) + self.x_0
        y = rho0 - rho * torch.cos(theta) + self.y_0
        return x, y

    def inverse(self, x, y):
        x, y = _pair(x, y)
        e, a, n, big_f, rho0 = self._params()
        x = x - self.x_0
        y = y - self.y_0
        sign_n = float(np.sign(n)) if n != 0 else 1.0
        rho = sign_n * torch.sqrt(x * x + (rho0 - y) ** 2)
        theta = torch.atan2(sign_n * x, sign_n * (rho0 - y))
        t = (rho / (a * big_f)) ** (1.0 / n)
        lat = _inv_conformal_t(t, e)
        lon = torch.rad2deg(theta / n) + self.lon_0
        return _norm_lon(lon), torch.rad2deg(lat)

    def to_cf(self) -> dict:
        sp = (self.lat_1 if self.lat_2 is None or self.lat_2 == self.lat_1
              else [self.lat_1, self.lat_2])
        return {
            'grid_mapping_name': 'lambert_conformal_conic',
            'standard_parallel': sp,
            'longitude_of_central_meridian': self.lon_0,
            'latitude_of_projection_origin': self.lat_0,
            'false_easting': self.x_0,
            'false_northing': self.y_0,
            **self.ellipsoid.cf_attrs(),
        }

    def to_wkt(self) -> str:
        return self._projcs_wkt('unnamed', 'Lambert_Conformal_Conic_2SP', {
            'latitude_of_origin': self.lat_0,
            'central_meridian': self.lon_0,
            'standard_parallel_1': self.lat_1,
            'standard_parallel_2': self.lat_1 if self.lat_2 is None else self.lat_2,
            'false_easting': self.x_0,
            'false_northing': self.y_0,
        })


@dataclass(frozen=True, eq=False)
class PolarStereographic(CRS):
    """Polar stereographic (Snyder ch. 21). HRRR-AK: sphere 6371229 m,
    lat_0 = 90, lon_0 = 225, lat_ts = 60.
    """

    lat_0: float = 90.0  # +90 or -90
    lon_0: float = 0.0
    lat_ts: Optional[float] = None  # standard parallel; None -> use k0
    k0: float = 1.0
    x_0: float = 0.0
    y_0: float = 0.0
    ellipsoid: Ellipsoid = WGS84

    def _scale(self) -> float:
        """rho = a * _scale() * t (t at the |lat|-equivalent); numpy on
        Python floats."""
        e = self.ellipsoid.e
        e2 = self.ellipsoid.e2
        if self.lat_ts is not None:
            phi_c = np.deg2rad(abs(self.lat_ts))
            s = np.sin(phi_c)
            m_c = np.cos(phi_c) / np.sqrt(1.0 - e2 * s * s)
            t_c = np.tan(_QUARTER_PI - phi_c / 2.0) / ((1.0 - e * s) / (1.0 + e * s)) ** (e / 2.0)
            return float(m_c / t_c)
        # k0 form: rho = 2 a k0 t / sqrt((1+e)^(1+e) (1-e)^(1-e))
        return 2.0 * self.k0 / float(np.sqrt((1.0 + e) ** (1.0 + e) * (1.0 - e) ** (1.0 - e)))

    def forward(self, lon, lat):
        lon, lat = _pair(lon, lat)
        e = self.ellipsoid.e
        a = self.ellipsoid.a
        south = self.lat_0 < 0
        if south:
            lon, lat = -lon, -lat
        t = _conformal_t(torch.deg2rad(lat), e)
        rho = a * self._scale() * t
        dlon = torch.deg2rad(lon - (-self.lon_0 if south else self.lon_0))
        x = rho * torch.sin(dlon)
        y = -rho * torch.cos(dlon)
        if south:
            x, y = -x, -y
        return x + self.x_0, y + self.y_0

    def inverse(self, x, y):
        x, y = _pair(x, y)
        e = self.ellipsoid.e
        a = self.ellipsoid.a
        x = x - self.x_0
        y = y - self.y_0
        south = self.lat_0 < 0
        if south:
            x, y = -x, -y
        rho = torch.sqrt(x * x + y * y)
        lat = _inv_conformal_t(rho / (a * self._scale()), e)
        lon0 = -self.lon_0 if south else self.lon_0
        lon = lon0 + torch.rad2deg(torch.atan2(x, -y))
        lat = torch.rad2deg(lat)
        if south:
            lon, lat = -lon, -lat
        return _norm_lon(lon), lat

    def to_cf(self) -> dict:
        cf = {
            'grid_mapping_name': 'polar_stereographic',
            'straight_vertical_longitude_from_pole': self.lon_0,
            'latitude_of_projection_origin': self.lat_0,
            'false_easting': self.x_0,
            'false_northing': self.y_0,
            **self.ellipsoid.cf_attrs(),
        }
        if self.lat_ts is not None:
            cf['standard_parallel'] = self.lat_ts
        else:
            cf['scale_factor_at_projection_origin'] = self.k0
        return cf

    def to_wkt(self) -> str:
        params = {
            'latitude_of_origin': self.lat_0,
            'central_meridian': self.lon_0,
            'false_easting': self.x_0,
            'false_northing': self.y_0,
        }
        # crs_from_wkt reads standard_parallel_1 as lat_ts (default 60): a
        # k0-form CRS round-trips only through CF attrs, not WKT1
        if self.lat_ts is not None:
            params['standard_parallel_1'] = self.lat_ts
        else:
            params['scale_factor'] = self.k0
        return self._projcs_wkt('unnamed', 'Polar_Stereographic', params)


def _tm_series(n: float):
    """6th-order Krueger series coefficients for transverse Mercator (Karney
    2011, "Transverse Mercator with an accuracy of a few nanometers"), from
    n = f / (2 - f)."""
    n2, n3, n4, n5, n6 = n**2, n**3, n**4, n**5, n**6
    alpha = np.array([
        n / 2 - 2 * n2 / 3 + 5 * n3 / 16 + 41 * n4 / 180 - 127 * n5 / 288 + 7891 * n6 / 37800,
        13 * n2 / 48 - 3 * n3 / 5 + 557 * n4 / 1440 + 281 * n5 / 630 - 1983433 * n6 / 1935360,
        61 * n3 / 240 - 103 * n4 / 140 + 15061 * n5 / 26880 + 167603 * n6 / 181440,
        49561 * n4 / 161280 - 179 * n5 / 168 + 6601661 * n6 / 7257600,
        34729 * n5 / 80640 - 3418889 * n6 / 1995840,
        212378941 * n6 / 319334400,
    ])
    beta = np.array([
        n / 2 - 2 * n2 / 3 + 37 * n3 / 96 - n4 / 360 - 81 * n5 / 512 + 96199 * n6 / 604800,
        n2 / 48 + n3 / 15 - 437 * n4 / 1440 + 46 * n5 / 105 - 1118711 * n6 / 3870720,
        17 * n3 / 480 - 37 * n4 / 840 - 209 * n5 / 4480 + 5569 * n6 / 90720,
        4397 * n4 / 161280 - 11 * n5 / 504 - 830251 * n6 / 7257600,
        4583 * n5 / 161280 - 108847 * n6 / 3991680,
        20648693 * n6 / 638668800,
    ])
    a_cap = (1.0 + n2 / 4 + n4 / 64 + n6 / 256) / (1.0 + n)  # A / a
    return alpha, beta, a_cap


@dataclass(frozen=True, eq=False)
class TransverseMercator(CRS):
    """Transverse Mercator (Krueger series, nm accuracy); basis for UTM."""

    lon_0: float = 0.0
    lat_0: float = 0.0
    k0: float = 0.9996
    x_0: float = 500000.0
    y_0: float = 0.0
    ellipsoid: Ellipsoid = WGS84
    utm_zone: Optional[int] = None
    utm_south: bool = False

    def forward(self, lon, lat):
        lon, lat = _pair(lon, lat)
        ell = self.ellipsoid
        alpha, _, a_cap = _tm_series(ell.f / (2.0 - ell.f))
        e = ell.e
        lat_rad = torch.deg2rad(lat)
        lon_rad = torch.deg2rad(lon - self.lon_0)
        # conformal latitude
        s = torch.sin(lat_rad)
        t = torch.sinh(torch.atanh(s) - e * torch.atanh(e * s))
        xi_p = torch.atan2(t, torch.cos(lon_rad))
        eta_p = torch.asinh(torch.sin(lon_rad) / torch.sqrt(t * t + torch.cos(lon_rad) ** 2))
        xi = xi_p
        eta = eta_p
        for j in range(6):
            c = float(alpha[j])
            xi = xi + c * torch.sin(2 * (j + 1) * xi_p) * torch.cosh(2 * (j + 1) * eta_p)
            eta = eta + c * torch.cos(2 * (j + 1) * xi_p) * torch.sinh(2 * (j + 1) * eta_p)
        big_a = a_cap * ell.a
        x = self.k0 * big_a * eta + self.x_0
        y = self.k0 * big_a * xi + self.y_0
        if self.lat_0 != 0.0:
            y = y - self.k0 * big_a * self._xi_of_lat0()
        return x, y

    def _xi_of_lat0(self) -> float:
        ell = self.ellipsoid
        alpha, _, _ = _tm_series(ell.f / (2.0 - ell.f))
        e = ell.e
        s = np.sin(np.deg2rad(self.lat_0))
        t = np.sinh(np.arctanh(s) - e * np.arctanh(e * s))
        xi_p = np.arctan2(t, 1.0)
        xi = xi_p
        for j in range(6):
            xi += alpha[j] * np.sin(2 * (j + 1) * xi_p)
        return float(xi)

    def inverse(self, x, y):
        x, y = _pair(x, y)
        ell = self.ellipsoid
        _, beta, a_cap = _tm_series(ell.f / (2.0 - ell.f))
        e = ell.e
        big_a = a_cap * ell.a
        y_adj = y - self.y_0
        if self.lat_0 != 0.0:
            y_adj = y_adj + self.k0 * big_a * self._xi_of_lat0()
        xi = y_adj / (self.k0 * big_a)
        eta = (x - self.x_0) / (self.k0 * big_a)
        xi_p = xi
        eta_p = eta
        for j in range(6):
            c = float(beta[j])
            xi_p = xi_p - c * torch.sin(2 * (j + 1) * xi) * torch.cosh(2 * (j + 1) * eta)
            eta_p = eta_p - c * torch.cos(2 * (j + 1) * xi) * torch.sinh(2 * (j + 1) * eta)
        chi = torch.asin(torch.sin(xi_p) / torch.cosh(eta_p))  # conformal latitude
        # invert the conformal latitude by fixed-point iteration
        lat = chi
        for _ in range(10):
            s = torch.sin(lat)
            lat = lat + (torch.asin(torch.clamp(torch.tanh(torch.atanh(torch.sin(chi))
                                                           + e * torch.atanh(e * s)), -1, 1))
                         - lat)
        lon = self.lon_0 + torch.rad2deg(torch.atan2(torch.sinh(eta_p), torch.cos(xi_p)))
        return _norm_lon(lon), torch.rad2deg(lat)

    def to_cf(self) -> dict:
        return {
            'grid_mapping_name': 'transverse_mercator',
            'longitude_of_central_meridian': self.lon_0,
            'latitude_of_projection_origin': self.lat_0,
            'scale_factor_at_central_meridian': self.k0,
            'false_easting': self.x_0,
            'false_northing': self.y_0,
            **self.ellipsoid.cf_attrs(),
        }

    def to_epsg(self) -> Optional[int]:
        # EPSG 326xx/327xx are the WGS 84 UTM codes: a UTM grid on another
        # ellipsoid has no code here
        if self.utm_zone is not None and self.ellipsoid == WGS84:
            return (32700 if self.utm_south else 32600) + self.utm_zone
        return None

    def to_wkt(self) -> str:
        name = 'unnamed'
        if self.utm_zone is not None:
            # the WGS 84 name only when the datum is WGS 84: GIS tools
            # classify by the PROJCS name
            zone = f'UTM zone {self.utm_zone}{"S" if self.utm_south else "N"}'
            name = f'WGS 84 / {zone}' if self.ellipsoid == WGS84 else zone
        return self._projcs_wkt(name, 'Transverse_Mercator', {
            'latitude_of_origin': self.lat_0,
            'central_meridian': self.lon_0,
            'scale_factor': self.k0,
            'false_easting': self.x_0,
            'false_northing': self.y_0,
        })


def utm_crs(zone: int, south: bool = False) -> TransverseMercator:
    """UTM zone CRS (EPSG 326xx / 327xx)."""
    if not 1 <= int(zone) <= 60:
        raise ValueError(f'Invalid UTM zone: {zone} (must be 1-60)')
    return TransverseMercator(lon_0=-183.0 + 6.0 * zone, k0=0.9996, x_0=500000.0,
                              y_0=10000000.0 if south else 0.0, utm_zone=zone, utm_south=south)


def crs_from_epsg(code: Union[int, str]) -> CRS:
    code = int(code)
    if code == 4326:
        return Geographic()
    if code == 4978:
        return Geocentric()
    if 32601 <= code <= 32660:
        return utm_crs(code - 32600, south=False)
    if 32701 <= code <= 32760:
        return utm_crs(code - 32700, south=True)
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
    if name is None and 'crs_wkt' in cf:
        return crs_from_wkt(cf['crs_wkt'])
    ell = _ellipsoid_from_cf(cf)

    def _scalar(key, default=0.0):
        return float(np.asarray(cf.get(key, default)).ravel()[0])

    if name == 'latitude_longitude':
        return Geographic(ellipsoid=ell)
    if name == 'geocentric':
        return Geocentric(ellipsoid=ell)
    if name == 'lambert_conformal_conic':
        sp = np.atleast_1d(np.asarray(cf.get('standard_parallel', 0.0), dtype=float))
        return LambertConformalConic(
            lat_0=_scalar('latitude_of_projection_origin'),
            lon_0=_scalar('longitude_of_central_meridian'),
            lat_1=float(sp[0]),
            lat_2=float(sp[1]) if sp.size > 1 else None,
            x_0=_scalar('false_easting'),
            y_0=_scalar('false_northing'),
            ellipsoid=ell,
        )
    if name == 'polar_stereographic':
        lat_ts = cf.get('standard_parallel')
        return PolarStereographic(
            lat_0=_scalar('latitude_of_projection_origin', 90.0),
            lon_0=_scalar('straight_vertical_longitude_from_pole'),
            lat_ts=float(np.asarray(lat_ts).ravel()[0]) if lat_ts is not None else None,
            k0=_scalar('scale_factor_at_projection_origin', 1.0),
            x_0=_scalar('false_easting'),
            y_0=_scalar('false_northing'),
            ellipsoid=ell,
        )
    if name == 'transverse_mercator':
        return TransverseMercator(
            lon_0=_scalar('longitude_of_central_meridian'),
            lat_0=_scalar('latitude_of_projection_origin'),
            k0=_scalar('scale_factor_at_central_meridian', 1.0),
            x_0=_scalar('false_easting'),
            y_0=_scalar('false_northing'),
            ellipsoid=ell,
        )
    raise ValueError(f'Unsupported CF grid mapping: {name!r}')


def crs_from_wkt(wkt: str) -> CRS:
    """A small WKT reader: classify by projection keyword (reads the CRS
    metadata other tools write; this package's own files carry CF attrs)."""
    w = wkt.lower()
    ell = WGS84
    m = re.search(r'(?:spheroid|ellipsoid)\s*\[\s*"[^"]*"\s*,\s*([-0-9.eE+]+)\s*,\s*([-0-9.eE+]+)',
                  wkt, re.IGNORECASE)
    if m:
        a = float(m.group(1))
        invf = float(m.group(2))
        ell = Ellipsoid(a=a, f=0.0 if invf == 0 else 1.0 / invf)
    if 'geogcrs' in w or 'geogcs' in w or '"wgs 84"' in w and 'projcrs' not in w and 'projcs' not in w:
        if 'projcrs' not in w and 'projcs' not in w and 'geoccs' not in w:
            return Geographic(ellipsoid=ell)
    if 'geocentric' in w or 'geoccs' in w or '4978' in w:
        return Geocentric(ellipsoid=ell)

    def _param(name, default=0.0):
        m = re.search(r'parameter\s*\[\s*"' + name + r'"\s*,\s*([-0-9.eE+]+)', wkt, re.IGNORECASE)
        return float(m.group(1)) if m else default

    if 'lambert' in w:
        return LambertConformalConic(
            lat_0=_param('latitude_of_origin'),
            lon_0=_param('central_meridian'),
            lat_1=_param('standard_parallel_1'),
            lat_2=_param('standard_parallel_2', _param('standard_parallel_1')),
            x_0=_param('false_easting'),
            y_0=_param('false_northing'),
            ellipsoid=ell,
        )
    if 'stereographic' in w or 'stere' in w:
        # the k0 form carries scale_factor and no standard parallel
        has_sp = re.search(r'parameter\s*\[\s*"standard_parallel_1"', wkt, re.IGNORECASE) is not None
        has_k0 = re.search(r'parameter\s*\[\s*"scale_factor"', wkt, re.IGNORECASE) is not None
        return PolarStereographic(
            lat_0=_param('latitude_of_origin', 90.0),
            lon_0=_param('central_meridian'),
            lat_ts=None if (has_k0 and not has_sp) else _param('standard_parallel_1', 60.0),
            k0=_param('scale_factor', 1.0),
            x_0=_param('false_easting'),
            y_0=_param('false_northing'),
            ellipsoid=ell,
        )
    if 'transverse' in w or 'utm' in w:
        return TransverseMercator(
            lon_0=_param('central_meridian'),
            lat_0=_param('latitude_of_origin'),
            k0=_param('scale_factor', 0.9996),
            x_0=_param('false_easting', 500000.0),
            y_0=_param('false_northing'),
            ellipsoid=ell,
        )
    raise ValueError('Could not classify WKT CRS')


def crs_from_user(value) -> CRS:
    """Parse int EPSG / 'EPSG:xxxx' / WKT / CF dict / CRS instance."""
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
        return crs_from_wkt(v)
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
            h = torch.zeros_like(as_f64(lon))
        return lla2ecef(lat, lon, h)
    xo, yo = dst.forward(lon, lat)
    return (xo, yo) if h is None else (xo, yo, h)
