"""WRF custom-run weather model reader (rh humidity type).

Counterpart of ``raider_tpu/wx/wrf.py``. Two forms: a nodes file
(XLAT/XLONG) plus a post-processed pressure-level file
(P_PL/T_PL/RH_PL/GHT_PL), with unit checks, _FillValue/-999 null handling,
per-level nanmean height fill, the spherical-earth (6370 km) Lambert
conformal projection from the file's global attributes and the mean-based
regular native grid; or a single raw ``wrfout`` prognostic file
(PH/PHB/T/P/PB/QVAPOR), whose temperature comes from Poisson's equation and
rh from qvapor. Files are read by scipy on the host; the fields go to the
model's device. There is no download service (WRF is user-run).
"""

import numpy as np

from raider_tpu_torch.geodesy import Geographic, LambertConformalConic, transform_points
from raider_tpu_torch.geodesy.crs import Ellipsoid
from raider_tpu_torch.wx.base import TIME_RES, WeatherModel, find_svp, host_to_device

# WRF's LCC is on a 6370 km sphere, the radius WRF itself assumes
SPHERE_WRF = Ellipsoid(a=6370e3, f=0.0)


class UnitTypeError(Exception):
    """Unexpected units on a WRF variable."""

    def __init__(self, varName, unittype):
        super().__init__(f"Unknown units for {varName}: '{unittype}'")


def checkUnits(unitCheck: str, varName: str) -> None:
    unitDict = {'pressure': 'Pa', 'temperature': 'K',
                'relative humidity': '%', 'geopotential': 'm'}
    if unitCheck != unitDict[varName]:
        raise UnitTypeError(varName, unitCheck)


def getNullValue(var):
    """_FillValue if recorded, else the de-facto -999 the files use."""
    try:
        return var._FillValue
    except AttributeError:
        return -999


def _decode(v):
    return v.decode('utf-8') if isinstance(v, bytes) else v


class WRF(WeatherModel):
    """User-run WRF output reader."""

    def __init__(self) -> None:
        super().__init__()
        self._humidityType = 'rh'
        self._model_level_type = 'ml'
        self._classname = 'wrf'
        self._dataset = 'wrf'
        self._Name = 'WRF'
        self._time_res = TIME_RES['WRF']
        # AOI-buffering resolution (set_latlon_bounds): WRF domains are
        # user-run at km scale; 0.05 deg ~ a typical inner-domain spacing
        self._lat_res = 0.05
        self._lon_res = 0.05

        # constants for the WRF refractivity formulation
        self._k1 = 0.776
        self._k2 = 0.233
        self._k3 = 3.75e3

    def _fetch(self, out) -> None:
        raise RuntimeError(
            'WRF output is produced by user-run simulations; there is no download '
            'service. Point the model at your wrfout files instead.'
        )

    # ------------------------------------------------------------- loaders
    def load_weather(self, file1=None, file2=None, f=None, *args, **kwargs) -> None:
        """Load WRF output.

        Two-file form: one file holds the node coordinates (XLAT/XLONG), the other the
        pressure-level fields (P_PL/T_PL/RH_PL/GHT_PL); either order works.
        Single-file form: a raw ``wrfout`` prognostic file.
        """
        file1 = file1 or f
        if file1 is None:
            raise ValueError('WRF.load_weather requires a wrfout file')
        if file2 is None:
            self._load_raw_wrfout(file1)
            return
        # probe ONLY the nodes read for the swapped-argument case: a
        # malformed plev file must raise its own error, not a misleading
        # KeyError('XLAT') from retrying the wrong file
        try:
            lons, lats = self._get_wm_nodes(file1)
        except KeyError:
            lons, lats = self._get_wm_nodes(file2)
            self._read_netcdf(file1)
        else:
            self._read_netcdf(file2)
        self._finish_native_grid(lons, lats)

    def _get_wm_nodes(self, nodeFile):
        """Node longitudes and latitudes of the first date."""
        from scipy.io import netcdf_file

        with netcdf_file(str(nodeFile), 'r', maskandscale=True) as outf:
            lats = outf.variables['XLAT'][0].copy()
            lons = outf.variables['XLONG'][0].copy()
        lons = np.asarray(lons, dtype=np.float64)
        lats = np.asarray(lats, dtype=np.float64)
        lons[lons > 180] -= 360
        return lons, lats

    def _read_netcdf(self, weatherFile) -> None:
        """Pressure-level fields + LCC projection from the plev file.
        Stores (z, y, x) host cubes; the caller restacks them to the
        package's (y, x, z) convention on the device."""
        from scipy.io import netcdf_file

        with netcdf_file(str(weatherFile), 'r', maskandscale=True) as fh:
            spvar = fh.variables['P_PL']
            temp = fh.variables['T_PL']
            humid = fh.variables['RH_PL']
            geohvar = fh.variables['GHT_PL']

            attrs = {(_decode(k)): v for k, v in fh._attributes.items()}
            lon0 = float(attrs['STAND_LON'])
            lat0 = float(attrs['MOAD_CEN_LAT'])
            lat1 = float(attrs['TRUELAT1'])
            lat2 = float(attrs['TRUELAT2'])

            checkUnits(_decode(spvar.units), 'pressure')
            checkUnits(_decode(temp.units), 'temperature')
            checkUnits(_decode(humid.units), 'relative humidity')
            checkUnits(_decode(geohvar.units), 'geopotential')

            tNull = getNullValue(temp)
            hNull = getNullValue(humid)
            gNull = getNullValue(geohvar)
            pNull = getNullValue(spvar)

            sp = np.asarray(spvar[0].copy(), dtype=np.float64)
            temps = np.asarray(temp[0].copy(), dtype=np.float64)
            humids = np.asarray(humid[0].copy(), dtype=np.float64)
            geoh = np.asarray(geohvar[0].copy(), dtype=np.float64)

        # spherical-earth LCC (see http://www.pkrc.net/wrf-lambert.html)
        self._proj = LambertConformalConic(
            lat_0=lat0, lon_0=lon0, lat_1=lat1, lat_2=lat2,
            ellipsoid=SPHERE_WRF,
        )

        temps[temps == tNull] = np.nan
        sp[sp == pNull] = np.nan
        humids[humids == hNull] = np.nan
        geoh[geoh == gNull] = np.nan

        self._t = temps
        self._rh = humids

        # heights below topography are nan: fill each level with its nanmean
        zmeans = np.nanmean(geoh, axis=(1, 2))
        ix = np.isnan(geoh)
        geoh[ix] = np.broadcast_to(zmeans[:, None, None], geoh.shape)[ix]
        self._zs = geoh

        if sp.ndim == 1:
            self._p = np.broadcast_to(
                sp[:, np.newaxis, np.newaxis], self._zs.shape).copy()
        else:
            self._p = sp

    def _finish_native_grid(self, lons, lats) -> None:
        """WRF gives node coordinates only in lat/lon; project them to the
        native LCC and enforce a regular grid by averaging (the interpolation
        needs a regular grid)."""
        xs2, ys2 = (v.numpy() for v in transform_points(Geographic(), self._proj, lons, lats)[:2])
        xs = np.mean(xs2, axis=0)       # (nx,): average over rows
        ys = np.mean(ys2, axis=1)       # (ny,): average over columns

        def _restack(a):                # (z, y, x) -> (y, x, z) on the device
            return host_to_device(a, self._device, None).permute(1, 2, 0)

        self._t = _restack(self._t)
        self._rh = _restack(self._rh)
        self._p = _restack(self._p)
        self._zs = _restack(self._zs)
        self._xs = xs
        self._ys = ys
        self._lats = lats
        self._lons = lons

    def _load_raw_wrfout(self, file1) -> None:
        """Single raw ``wrfout`` prognostic file: T from Poisson's equation
        on the perturbation potential temperature, rh from qvapor, on the
        device."""
        from scipy.io import netcdf_file

        with netcdf_file(str(file1), 'r', maskandscale=True) as f1:
            lats = np.asarray(f1.variables['XLAT'][0].copy(), np.float64)
            lons = np.asarray(f1.variables['XLONG'][0].copy(), np.float64)
            # perturbation + base geopotential -> height
            ph = f1.variables['PH'][0].copy()
            phb = f1.variables['PHB'][0].copy()
            t_pert = f1.variables['T'][0].copy()  # potential temp perturbation
            p_pert = f1.variables['P'][0].copy()
            pb = f1.variables['PB'][0].copy()
            qvapor = f1.variables['QVAPOR'][0].copy()

            # projection from global attrs (WRF LCC standard attrs)
            attrs = {(_decode(k)): v for k, v in f1._attributes.items()}
            truelat1 = float(attrs.get('TRUELAT1', 30.0))
            truelat2 = float(attrs.get('TRUELAT2', 60.0))
            cen_lat = float(attrs.get('MOAD_CEN_LAT', attrs.get('CEN_LAT', 40.0)))
            cen_lon = float(attrs.get('STAND_LON', attrs.get('CEN_LON', -100.0)))
            self._proj = LambertConformalConic(
                lat_0=cen_lat, lon_0=cen_lon, lat_1=truelat1, lat_2=truelat2,
                ellipsoid=SPHERE_WRF,
            )

        lons[lons > 180] -= 360
        # in the file's precision, as the JAX package computes them
        ph, phb, t_pert, p_pert, pb, qvapor = (host_to_device(a, self._device, None) for a in
                                               (ph, phb, t_pert, p_pert, pb, qvapor))
        geo_ht = (ph + phb) / self._g0              # staggered (nz+1, ny, nx)
        geo_ht = 0.5 * (geo_ht[:-1] + geo_ht[1:])   # de-stagger to mass levels
        pres = p_pert + pb                           # full pressure [Pa]
        theta = t_pert + 300.0                       # full potential temperature
        temp = theta * (pres / 1e5) ** 0.2854        # Poisson: theta -> T

        # rh from qvapor via saturation vapor pressure
        svp = find_svp(temp)
        e = qvapor * pres / (0.622 + qvapor)
        self._t = temp
        self._rh = 100.0 * e / svp
        self._p = pres
        self._zs = geo_ht
        self._finish_native_grid(lons, lats)
