"""Skeleton for user-contributed weather model readers.

Counterpart of ``raider_tpu/wx/template.py``. Copy this file, rename the
class, and fill in the marked sections; the base class handles everything
downstream (vapor pressure, z-regularization, refractivities, ZTD
integration, writing).
"""

import datetime as dt

from raider_tpu_torch.geodesy import Geographic
from raider_tpu_torch.wx.base import WeatherModel


class customModelReader(WeatherModel):
    """Fill in the marked attributes and the two methods below."""

    def __init__(self) -> None:
        super().__init__()
        # === FILL IN: humidity type ('q' specific / 'rh' relative) ===
        self._humidityType = 'q'
        # === FILL IN: model identifiers ===
        self._model_level_type = 'ml'
        self._classname = 'custom'
        self._dataset = 'custom'
        self._Name = 'CUSTOM'
        self._time_res = 1  # hours between analyses
        # === FILL IN: valid date range and availability lag ===
        self._valid_range = (
            dt.datetime(2000, 1, 1, tzinfo=dt.timezone.utc),
            dt.datetime.now(dt.timezone.utc),
        )
        self._lag_time = dt.timedelta(hours=6)
        # === FILL IN: refractivity constants (defaults are fine for most) ===
        self._k1 = 0.776    # [K/Pa]
        self._k2 = 0.233    # [K/Pa]
        self._k3 = 3.75e3   # [K^2/Pa]
        # === FILL IN: grid resolution (degrees) and native projection ===
        self._lat_res = 0.25
        self._lon_res = 0.25
        self._proj = Geographic()

    def _fetch(self, out) -> None:
        """Download raw data covering self._ll_bounds at self._time to ``out``.

        Use any client you like; write the result as a netCDF the loader
        below can read (e.g. via raider_tpu_torch.wx.gmao.write_weather_vars).
        """
        raise NotImplementedError

    def load_weather(self, f=None, *args, **kwargs) -> None:
        """Populate, from the raw file ``f``, the cubes in (y, x, z) layout
        with z ascending (arrays, or tensors on ``self._device``, the device
        :meth:`load` was given):
            self._p [Pa], self._t [K], self._q (or self._rh [%]),
            self._zs [m, ellipsoidal heights], self._lats/_lons (2-D),
            self._xs/_ys (grid coordinates in self._proj).
        """
        raise NotImplementedError
