"""The main delay-calculation workflow: calcDelays.

The counterpart of ``raider_tpu/workflows/calc_delays.py``: a YAML run
config -> ``checkArgs`` -> per date, the weather model prepared (fetched or
reused, processed on the device and written), chosen or combined in time,
and ``tropo_delay`` on the device -> the outputs. Everything runs on
``device``, the CUDA card unless the caller names another. The one option
the JAX CLI lacks is ``--nc_format``: the machine with the card has no
h5py, so there the processed models, the combined files and the cubes are
written as netCDF-3 (``NETCDF3_64BIT_OFFSET``) when asked; nothing
switches format by itself.
"""

import argparse
import datetime as dt
import os
import shutil
import sys
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path
from typing import Optional, Sequence

import numpy as np
import torch

from raider_tpu_torch.delay import tropo_delay
from raider_tpu_torch.geometry.los import Raytracing
from raider_tpu_torch.io import read_nc, write_nc
from raider_tpu_torch.io.ncdf import NC_FORMATS
from raider_tpu_torch.logger import logger
from raider_tpu_torch.utils import require_device
from raider_tpu_torch.utils.timeutils import get_dt, get_nearest_wmtimes
from raider_tpu_torch.workflows.check_args import checkArgs, write_station_table
from raider_tpu_torch.workflows.config import read_run_config_file
from raider_tpu_torch.wx.exceptions import (
    DatetimeFailed,
    NoWeatherModelData,
    TryToKeepGoingError,
    WrongNumberOfFiles,
)
from raider_tpu_torch.wx.process import prepareWeatherModel

TIME_INTERPOLATION_METHODS = ['none', 'center_time', 'azimuth_time_grid']


def calcDelays(iargs: Optional[Sequence[str]] = None, *, device='cuda',
               nc_format: str = 'NETCDF4') -> list:
    """Run the full delay workflow from a YAML run config on ``device``;
    ``nc_format`` is the netCDF format written unless ``--nc_format`` is
    given. Returns the wet (or cube) output paths."""
    p = argparse.ArgumentParser(
        description='Download a weather model and calculate tropospheric delays',
    )
    p.add_argument('--download_only', action='store_true', default=False,
                   help='only download a weather model.')
    group = p.add_mutually_exclusive_group(required=False)
    group.add_argument(
        '--generate_config', '-g', nargs='?', const='template',
        choices=['template', 'example_LA_bbox', 'example_LA_GNSS', 'example_UK_isce'],
        default=None, help='Generate an example run configuration and exit',
    )
    group.add_argument('run_config_file', nargs='?',
                       type=lambda s: Path(s).absolute(),
                       help='a YAML file with arguments')
    p.add_argument('--nc_format', choices=NC_FORMATS, default=nc_format,
                   help='netCDF format of the processed weather models, the combined '
                        'weather files and the delay cubes (NETCDF4 needs h5py)')
    args = p.parse_args(args=iargs)
    nc_format = args.nc_format

    if args.generate_config is not None:
        ex_dir = Path(__file__).parent.parent / 'cli' / 'examples' / args.generate_config
        for filename in ex_dir.glob('*'):
            dest = Path.cwd() / filename.name
            if dest.exists():
                # ask before overwriting; without a tty never overwrite
                # silently: skip with a warning
                if not sys.stdin.isatty():
                    logger.warning('File %s already exists; not overwriting', dest)
                    continue
                print(f'File {dest} already exists. Overwrite? [y/n]')
                if input().lower() != 'y':
                    continue
            shutil.copy(str(filename), str(Path.cwd()))
            logger.info('Wrote: %s', filename.name)
        sys.exit()

    if args.run_config_file is None:
        default = Path('./raider.yaml')
        if not default.is_file():
            raise SystemExit(
                'ERROR: No run configuration file provided! Specify one or have a '
                "'raider.yaml' in the current directory."
            )
        args.run_config_file = default
    elif not args.run_config_file.exists():
        raise FileNotFoundError(str(args.run_config_file))

    run_config = read_run_config_file(args.run_config_file)
    run_config = checkArgs(run_config)
    dl_only = run_config.runtime_group.download_only or args.download_only

    los = run_config.los_group.los
    aoi = run_config.aoi_group.aoi
    model = run_config.weather_model

    # buffer the AOI by the model grid and define the output x/y grid
    aoi.add_buffer(model.getLLRes())
    aoi.set_output_xygrid(run_config.runtime_group.output_projection)

    if isinstance(los, Raytracing):
        wm_bounds = aoi.calc_buffer_ray(
            los.getSensorDirection(), lookDir=los.getLookDirection(), incAngle=30
        )
    else:
        wm_bounds = aoi.bounds()
    model.set_latlon_bounds(wm_bounds, output_spacing=aoi.get_output_spacing())

    interp_method = run_config.time_group.interpolate_time
    if interp_method is None:
        interp_method = 'none'
        logger.warning(
            "interp_method is not specified, defaulting to 'none', "
            'i.e. nearest datetime for delay calculation'
        )

    def acquire_weather(t: dt.datetime) -> tuple:
        """Weather acquisition for one date: epoch selection, download and
        processing on the device. Returns (times, wfiles); raises exactly
        like the serial loop (DatetimeFailed aborts, per-epoch failures
        keep going for center_time)."""
        if interp_method == 'azimuth_time_grid':
            from raider_tpu_torch.workflows.s1_timing import get_times_for_azimuth_interpolation

            step = model.dtime() or 6
            times = get_times_for_azimuth_interpolation(t, step)
        elif interp_method == 'center_time':
            times = get_nearest_wmtimes(t, model.dtime() if model.dtime() is not None else 6)
        elif interp_method == 'none':
            times = [t]
        else:
            raise NotImplementedError(
                'Only none, center_time, and azimuth_time_grid are accepted '
                'values for interp_method.'
            )

        wfiles = []
        for tt in times:
            try:
                wfile = prepareWeatherModel(
                    model, tt, aoi.bounds(),
                    makePlots=run_config.runtime_group.verbose,
                    device=device, nc_format=nc_format,
                )
                if wfile is not None:
                    wfiles.append(Path(wfile))
            except TryToKeepGoingError:
                if interp_method in ('azimuth_time_grid', 'none'):
                    raise DatetimeFailed(model.Model(), tt)
                continue
            except Exception as e:
                logger.error(e)
                logger.error('Weather model files are: %s', wfiles)
                logger.error('Downloading and/or preparation of %s failed.', model._Name)
                continue
        return times, wfiles

    # Acquisition/compute pipelining, as in the JAX package: while date k
    # runs tropo_delay (kernel B2) from this thread, date k+1's weather
    # download and processing (load, kernel B1) runs on a single background
    # worker. Results are consumed in date order, so failure semantics and
    # outputs are identical to the serial loop; the worker is 1-wide so
    # weather-model state is never touched concurrently (date k's compute
    # only reads the already written processed file, never the model
    # object). The processed-file cache makes shared epochs safe: a file
    # written during date k's acquisition is reused, not rewritten, by
    # date k+1's.
    # RAIDER_TPU_PREFETCH_WM=0 restores the serial loop.
    dates = list(zip(run_config.date_group.date_list,
                     run_config.wetFilenames, run_config.hydroFilenames))
    use_prefetch = (len(dates) > 1
                    and os.environ.get('RAIDER_TPU_PREFETCH_WM', '1') != '0')
    executor = (ThreadPoolExecutor(max_workers=1,
                                   thread_name_prefix='wm-prefetch')
                if use_prefetch else None)
    wet_paths = []
    try:
        pending = executor.submit(acquire_weather, dates[0][0]) if executor else None
        for i, (t, w, f) in enumerate(dates):
            logger.debug('Starting weather model calculation for %s', t)

            if executor is not None:
                times, wfiles = pending.result()
                pending = (executor.submit(acquire_weather, dates[i + 1][0])
                           if i + 1 < len(dates) else None)
            else:
                times, wfiles = acquire_weather(t)

            if dl_only:
                continue

            if len(wfiles) == 0:
                logger.error('No weather model data was successfully processed.')
                raise NoWeatherModelData('Weather model processing failed for all times')

            weather_model_file = getWeatherFile(wfiles, times, t, model._Name, interp_method,
                                                device=device, nc_format=nc_format)
            if weather_model_file is None:
                continue

            try:
                wet_delay, hydro_delay = tropo_delay(
                    t, str(weather_model_file), aoi, los,
                    height_levels=run_config.height_group.height_levels,
                    out_proj=run_config.runtime_group.output_projection,
                    zref=run_config.los_group.zref,
                    device=device,
                )
            except RuntimeError:
                logger.exception('Datetime %s failed', t)
                continue

            if los.is_Projected():
                out_filename = w.replace('_ztd', '_std')
                hydro_filename = f.replace('_ztd', '_std')
            elif los.ray_trace():
                out_filename = w.replace('_std', '_ray')
                hydro_filename = f.replace('_std', '_ray')
            else:
                out_filename = w
                hydro_filename = f

            if hydro_delay is None:
                # cube workflow: write the Dataset
                out_path = Path(out_filename.replace('wet', 'tropo'))
                ds = wet_delay
                times_str = [x.strftime('%Y%m%dT%H:%M:%S') for x in sorted(times)]
                ds.attrs['model_name'] = model._Name
                ds.attrs['model_times_used'] = times_str
                ds.attrs['interpolation_method'] = interp_method
                if out_path.suffix not in ('.nc', '.h5'):
                    out_path = out_path.with_suffix('.nc')
                write_nc(ds, out_path, nc_format=nc_format)
                logger.info('Successfully wrote delay cube to: %s', out_path)
            else:
                out_path = Path(out_filename)
                hydro_path = Path(hydro_filename) if hydro_filename else None
                if aoi.type() == 'station_file':
                    out_path = out_path.with_suffix('.csv')
                if aoi.type() in ('station_file', 'radar_rasters', 'geocoded_file'):
                    writeDelays(aoi, wet_delay, hydro_delay, out_path, hydro_path,
                                outformat=run_config.runtime_group.raster_format)

            wet_paths.append(out_path)

    finally:
        if executor is not None:
            # On an error escaping the loop, don't block propagation behind
            # an in-flight next-date download: cancel_futures drops any
            # QUEUED prefetch (an already-RUNNING acquisition still
            # completes — the thread can't be interrupted).
            executor.shutdown(wait=True, cancel_futures=True)

    return wet_paths


def writeDelays(aoi, wetDelay, hydroDelay, wet_path: Path,
                hydro_path: Optional[Path] = None, outformat: Optional[str] = None,
                ndv: float = 0.0) -> None:
    """Write delay arrays as CSV (stations: the station file's columns and
    the three delays) or rasters."""
    wetDelay = np.asarray(wetDelay).copy()
    hydroDelay = np.asarray(hydroDelay).copy()
    wetDelay[np.isnan(wetDelay)] = ndv
    hydroDelay[np.isnan(hydroDelay)] = ndv

    if aoi.type() == 'station_file':
        write_station_table(aoi._filename, str(wet_path),
                            extra={'wetDelay': wetDelay, 'hydroDelay': hydroDelay,
                                   'totalDelay': wetDelay + hydroDelay})
        logger.info('Wrote delays to: %s', Path(wet_path).absolute())
    else:
        if hydro_path is None:
            raise ValueError('Hydro delay file path must be specified if the AOI is not a station file')
        from raider_tpu_torch.io.rasters import writeArrayToRaster

        proj = aoi.projection()
        gt = aoi.geotransform()
        writeArrayToRaster(wetDelay, wet_path, noDataValue=ndv, fmt=outformat or 'ENVI', proj=proj, gt=gt)
        writeArrayToRaster(hydroDelay, hydro_path, noDataValue=ndv, fmt=outformat or 'ENVI', proj=proj, gt=gt)


def getWeatherFile(wfiles: list, times: list, time: dt.datetime, model: str,
                   interp_method: str = 'none', *, device='cuda',
                   nc_format: str = 'NETCDF4') -> Optional[Path]:
    """Select or combine weather files per the interpolation method."""
    expected = {'none': 1, 'center_time': 2, 'azimuth_time_grid': 3}
    n_files = len(wfiles)
    n_times = len(times)
    try:
        n_expected = expected[interp_method]
    except KeyError:
        raise ValueError(f'getWeatherFile: interp_method {interp_method} is not known')

    n_match = n_expected == n_files
    t_match = n_files == n_times

    if n_files == 0:
        logger.error('No weather model data was successfully processed.')
        return None

    if interp_method == 'none':
        return wfiles[0]
    if interp_method == 'center_time':
        if n_match:
            return combine_weather_files(wfiles, time, model, interp_method='center_time',
                                         device=device, nc_format=nc_format)
        if t_match:
            logger.warning('Time interpolation is not needed as exact time is available')
            return wfiles[0]
        if n_files == 1:
            logger.warning(
                'getWeatherFile: One datetime is not available to download, '
                'defaulting to nearest available date'
            )
            return wfiles[0]
        raise WrongNumberOfFiles(n_expected, n_files)
    if interp_method == 'azimuth_time_grid':
        if n_match or t_match:
            return combine_weather_files(wfiles, time, model, interp_method='azimuth_time_grid',
                                         device=device, nc_format=nc_format)
        raise WrongNumberOfFiles(n_expected, n_files)
    raise NotImplementedError(
        f'The {interp_method} with {n_files} retrieved weather model files '
        'was not well posed for the current workflow.'
    )


def combine_weather_files(wfiles: list, time: dt.datetime, model: str,
                          interp_method: str = 'center_time', *, device='cuda',
                          nc_format: str = 'NETCDF4') -> Path:
    """Weighted combination of 2-3 weather files, summed in float64 on
    ``device`` and written in ``nc_format``."""
    style = {'center_time': '_timeInterp_', 'azimuth_time_grid': '_timeInterpAziGrid_'}

    datasets = [read_nc(f) for f in wfiles]
    times = [dt.datetime.strptime(ds.attrs['datetime'], '%Y_%m_%dT%H_%M_%S') for ds in datasets]
    if len(times) == 0:
        raise NoWeatherModelData()

    if interp_method == 'center_time':
        wgts = get_weights_time_interp(times, time)
    elif interp_method == 'azimuth_time_grid':
        from raider_tpu_torch.workflows.s1_timing import get_inverse_weights_for_dates

        time_grid = get_time_grid_for_aztime_interp(datasets, time, model, device=device)
        wgts = get_inverse_weights_for_dates(time_grid, times)
    else:
        raise ValueError('Interpolating weather files is not available with interpolation method "none"')

    device = require_device(device)

    def _f64(a):
        # to the device in its own dtype, widened there (exact for float32)
        return torch.as_tensor(np.asarray(a), device=device).to(torch.float64)

    ds_out = datasets[0]
    for var in ('wet', 'hydro', 'wet_total', 'hydro_total'):
        combined = sum(_f64(w) * _f64(ds[var].data) for w, ds in zip(wgts, datasets))
        combined = combined.cpu().numpy()
        ds_out.variables[var] = type(ds_out.variables[var])(
            ds_out.variables[var].dims, combined, dict(ds_out.variables[var].attrs)
        )
    ds_out.attrs['Date1'] = 0
    ds_out.attrs['Date2'] = 0

    wfile0 = Path(wfiles[0])
    out = wfile0.parent / (
        wfile0.name.split('_')[0]
        + '_' + time.strftime('%Y_%m_%dT%H_%M_%S')
        + style[interp_method]
        + '_'.join(wfile0.name.split('_')[-4:])
    )
    write_nc(ds_out, out, nc_format=nc_format)
    return out


def get_weights_time_interp(times: list, time: dt.datetime) -> Optional[list]:
    """Inverse linear time weights."""
    date1, date2 = times
    wgts = [
        1 - get_dt(time, date1) / get_dt(date2, date1),
        1 - get_dt(date2, time) / get_dt(date2, date1),
    ]
    if not np.isclose(np.sum(wgts), 1):
        logger.error(
            'Time interpolation weights do not sum to one; something is off '
            'with query datetime: %s', time,
        )
        return None
    return wgts


def get_time_grid_for_aztime_interp(datasets: list, time: dt.datetime, model: str, *,
                                    device='cuda') -> np.ndarray:
    """Per-voxel azimuth acquisition time grid (HRRR only), computed on
    ``device``."""
    az_time_allowed = ('hrrr', 'hrrrak', 'hrrr-ak')
    if model.lower() not in az_time_allowed:
        raise NotImplementedError('Azimuth Time is currently only implemented for HRRR')

    from raider_tpu_torch.workflows.s1_timing import get_s1_azimuth_time_grid

    lat_2d = np.asarray(datasets[0]['latitude'].data, dtype=np.float64)
    lon_2d = np.asarray(datasets[0]['longitude'].data, dtype=np.float64)
    z_1d = np.asarray(datasets[0].coords['z'].data, dtype=np.float64)
    m, n, p = z_1d.shape[0], lat_2d.shape[0], lat_2d.shape[1]
    lat = np.broadcast_to(lat_2d, (m, n, p))
    lon = np.broadcast_to(lon_2d, (m, n, p))
    hgt = np.broadcast_to(z_1d[:, None, None], (m, n, p))

    time_grid = get_s1_azimuth_time_grid(lon, lat, hgt, time, device=device)
    if np.any(np.isnan(time_grid)):
        raise ValueError('The Time Grid return nans meaning no orbit was downloaded.')
    return time_grid
