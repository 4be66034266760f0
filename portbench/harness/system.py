"""The system under test: what the benchmark calls in ``raider_tpu_torch``.

Everything the benchmark takes from the port goes through this module: the
HRRR weather model (the port's ``wx.hrrr.HRRR`` with only its raw-file read
replaced by fields already on the device), its processing (``load`` and
``to_dataset``), the request objects (``BoundingBox``, ``Raytracing``) as
the calc-delays workflow prepares them, ``tropo_delay`` itself, and the
port's stage timers and kernel launch counters.
"""

import logging

import numpy as np
import torch

from raider_tpu_torch.delay.engine import tropo_delay
from raider_tpu_torch.geodesy import crs_from_cf
from raider_tpu_torch.geometry import BoundingBox, Raytracing
from raider_tpu_torch.geometry.orbit import Orbit
from raider_tpu_torch.kernels import LAUNCHES, reset_launch_counts
from raider_tpu_torch.utils.profiling import stage_report
from raider_tpu_torch.wx.hrrr import HRRR

__all__ = ['LAUNCHES', 'reset_launch_counts', 'stage_report', 'processed_model', 'frame_request',
           'delays', 'quiet']


def quiet() -> None:
    """The port logs every slice at INFO; a production queue runs at WARNING."""
    logging.getLogger('raider_tpu_torch').setLevel(logging.WARNING)


class FieldsHRRR(HRRR):
    """The port's HRRR model reading fields already on the device: the same
    attributes ``HRRR.load_weather`` sets from a raw file (the (y, x, z)
    float64 views of (z, y, x) t, q, pressure and geopotential height, the
    host axes and lat/lon grids, the CRS), without the file."""

    def __init__(self, raw: dict, crs_cf: dict) -> None:
        super().__init__()
        self._raw = raw
        self._crs_cf = crs_cf

    def load_weather(self, f=None, *args, **kwargs) -> None:
        raw = self._raw
        pres, temps, qs, geo_hgt = (raw[k].to(self._device).to(torch.float64).permute(1, 2, 0)
                                    for k in ('pres', 't', 'q', 'z'))
        lats = raw['lat'].cpu().numpy()
        self._get_heights(lats, geo_hgt)
        self._t = temps
        self._q = qs
        self._p = pres
        self._xs = np.asarray(raw['xs'], dtype=np.float64)
        self._ys = np.asarray(raw['ys'], dtype=np.float64)
        self._lats = lats
        self._lons = raw['lon'].cpu().numpy()
        self._proj = crs_from_cf(self._crs_cf)


def processed_model(raw: dict, crs_cf: dict, when, device, wm_dir: str, ll_bounds=None):
    """``load`` and ``to_dataset`` of the fields in ``raw``: the processed
    model as the engine takes it, in memory. ``ll_bounds`` are the SNWE
    bounds calc-delays sets on the model (they name a processed file in
    ``wm_dir``, which must not exist, or ``load`` would read it)."""
    model = FieldsHRRR(raw, crs_cf)
    model.setTime(when)
    model.set_wmLoc(wm_dir)
    if ll_bounds is not None:
        model._ll_bounds = np.asarray(ll_bounds, dtype=np.float64)
    model.load(device=device)
    return model.to_dataset()


def frame_request(box, spacing_m: float, times, pos, vel, ref_time, look: str = 'right'):
    """(AOI, LOS, model bounds) of a raytraced request over the SNWE ``box``
    at ``spacing_m``, as calc-delays prepares them: the box buffered by the
    HRRR grid, its output grid in EPSG:4326, and the model's bounds widened
    toward the sensor."""
    los = Raytracing(orbit=Orbit(times=times, pos=pos, vel=vel, ref_time=ref_time), look_dir=look)
    aoi = BoundingBox(list(box), cube_spacing_in_m=spacing_m)
    model = HRRR()
    aoi.add_buffer(model.getLLRes())
    aoi.set_output_xygrid(4326)
    bounds = aoi.calc_buffer_ray(los.getSensorDirection(), lookDir=los.getLookDirection(),
                                 incAngle=30)
    model.set_latlon_bounds(bounds, output_spacing=aoi.get_output_spacing())
    return aoi, los, [float(v) for v in model.get_latlon_bounds()]


def delays(when, ds_model, aoi, los, heights, device):
    """One request through ``tropo_delay``: the delay cube's Dataset (host
    float64 ``wet`` and ``hydro``, (z, y, x))."""
    out, _ = tropo_delay(when, ds_model, aoi, los, height_levels=heights, device=device)
    return out

