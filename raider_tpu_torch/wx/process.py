"""Idempotent weather-model preparation (download or reuse -> load -> write).

Counterpart of ``raider_tpu/wx/process.py``. The processed netCDF filename
(model + time + bounds) is the cache key.
"""

import os

import numpy as np
import torch

from raider_tpu_torch.io import read_nc
from raider_tpu_torch.logger import logger
from raider_tpu_torch.utils.bbox import box_contains_with_translates
from raider_tpu_torch.wx.base import make_raw_weather_data_filename
from raider_tpu_torch.wx.exceptions import (
    CriticalError,
    DatetimeOutsideRange,
    ExistingWeatherModelTooSmall,
    TryToKeepGoingError,
)


def checkContainment_raw(path_wm_raw, ll_bounds, buffer_deg: float = 1e-5) -> bool:
    """Whether an existing raw file covers the bounds. An unreadable or
    corrupt raw file counts as not covering them (it is downloaded again)."""
    try:
        ds = read_nc(path_wm_raw)
    except Exception:  # noqa: BLE001 - any parse failure means download again
        return False
    for yname, xname in (('latitude', 'longitude'), ('y', 'x')):
        try:
            ys = np.asarray(ds[yname].data, dtype=np.float64)
            xs = np.asarray(ds[xname].data, dtype=np.float64)
            break
        except KeyError:
            continue
    else:
        return False
    ymin, ymax = np.nanmin(ys), np.nanmax(ys)
    xmin, xmax = np.mod(np.array([np.nanmin(xs), np.nanmax(xs)]) + 180, 360) - 180
    s, n, w, e = ll_bounds
    return box_contains_with_translates((xmin, ymin, xmax, ymax), (w, s, e, n), buffer_deg)


def prepareWeatherModel(
    weather_model,
    time,
    ll_bounds,
    download_only: bool = False,
    makePlots: bool = False,
    force_download: bool = False,
    *,
    device='cuda',
    nc_format: str = 'NETCDF4',
):
    """Download (or reuse), process on ``device`` (the CUDA card unless the
    caller names another) and write a weather model in ``nc_format`` (see
    ``io.ncdf.write_nc``); returns the processed filename. ``makePlots``
    plots a freshly processed model (``wx.plots``) before it is written."""
    if weather_model.get_latlon_bounds() is None:
        weather_model.set_latlon_bounds(ll_bounds)

    wmLoc = weather_model.get_wmLoc()
    weather_model.setTime(time)
    path_wm_raw = make_raw_weather_data_filename(wmLoc, weather_model.Model(), time)
    path_wm_crop = weather_model.out_file(wmLoc)

    if os.path.exists(path_wm_crop) and not force_download:
        logger.warning('Processed weather model already exists, please remove it ("%s") '
                       'if you want to download a new one.', path_wm_crop)
    elif (not force_download and os.path.exists(path_wm_raw)
          and checkContainment_raw(path_wm_raw, ll_bounds)):
        logger.warning('Raw weather model already exists, please remove it ("%s") '
                       'if you want to download a new one.', path_wm_raw)
    else:
        os.makedirs(os.path.dirname(path_wm_raw), exist_ok=True)
        try:
            weather_model.fetch(path_wm_raw, time)
        except DatetimeOutsideRange:
            raise TryToKeepGoingError
        if force_download and os.path.exists(path_wm_crop):
            # without this, load() would return the stale processed file and
            # the fresh download would never be processed
            logger.warning('force_download: removing stale processed file "%s"', path_wm_crop)
            os.remove(path_wm_crop)

    if download_only:
        logger.warning('download_only flag selected. No further processing will happen.')
        return None

    f = weather_model.load(device=device)
    if f is not None:
        logger.warning('The processed weather model file already exists, so I will use that.')
        containment = weather_model.checkContainment(ll_bounds)
        # only HRRR CONUS is exempt, on the cached and the fresh path alike
        # (the JAX package's rule: the AK model's name is 'HRRR-AK')
        if not containment and weather_model.Model() not in ('HRRR',):
            raise ExistingWeatherModelTooSmall
        return f

    wet = weather_model.getWetRefractivity()
    logger.debug('Number of weather model nodes: %s', wet.numel())
    logger.debug('Weather model: %s', weather_model.Model())
    logger.debug('Mean wet refractivity: %f', float(torch.nanmean(wet)))
    logger.debug('Mean hydrostatic refractivity: %f',
                 float(torch.nanmean(weather_model.getHydroRefractivity())))

    if makePlots:
        from raider_tpu_torch.wx import plots

        plots.plot_wh(weather_model, savefig=True)
        plots.plot_pqt(weather_model, savefig=True)

    try:
        f = weather_model.write(nc_format=nc_format)
        containment = weather_model.checkContainment(ll_bounds)
    except Exception as e:
        logger.exception('Unable to save weathermodel to file')
        logger.exception(e)
        raise CriticalError
    finally:
        name = weather_model.Model()

    if not containment and name not in ('HRRR',):
        raise ExistingWeatherModelTooSmall
    return f
