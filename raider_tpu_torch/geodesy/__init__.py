"""Geodesy on torch tensors: WGS84 transforms, CRSs, gravity models."""

from raider_tpu_torch.geodesy.ellipsoid import ecef2lla, geodetic_normal, lla2ecef  # noqa: F401
from raider_tpu_torch.geodesy.gravity import geo_to_ht, get_g_ll, get_Re  # noqa: F401
from raider_tpu_torch.geodesy.crs import (  # noqa: F401
    CRS,
    SPHERE_6371229,
    WGS84,
    Ellipsoid,
    Geocentric,
    Geographic,
    LambertConformalConic,
    PolarStereographic,
    TransverseMercator,
    crs_from_cf,
    crs_from_epsg,
    crs_from_user,
    crs_from_wkt,
    transform_points,
    utm_crs,
)
