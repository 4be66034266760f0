"""Post-parse argument validation and output filename generation.

The counterpart of ``raider_tpu/workflows/check_args.py``. The station
template CSV (and the station delay CSV of ``calc_delays.writeDelays``) is
written with the stdlib ``csv`` module to the semantics of the JAX
package's ``read_csv(f).drop_duplicates(subset=['Lat', 'Lon'])
.to_csv(index=False)`` in pandas: see :func:`write_station_table`.
"""

import csv
import datetime as dt
from pathlib import Path
from typing import Optional

import numpy as np

from raider_tpu_torch.geometry.aoi import BoundingBox, StationFile, read_station_csv
from raider_tpu_torch.geometry.los import LOS, Zenith
from raider_tpu_torch.logger import logger
from raider_tpu_torch.utils.table import NA_VALUES, column_kind, float_text
from raider_tpu_torch.workflows.config import RunConfig

_RASTER_EXTS = {
    'ENVI': '.dat',
    'ISCE': '.dat',
    'GTIFF': '.tiff',  # rasterio's driver->extension inversion yields 'tiff'
    'NC': '.nc',
    'NETCDF': '.nc',
    'HDF5': '.h5',
}


def get_raster_ext(fmt: str) -> str:
    try:
        return _RASTER_EXTS[fmt.upper().lstrip('.')]
    except KeyError:
        raise ValueError(f'{fmt} is not a valid raster file format')


def _field(kind: str, text: str) -> str:
    if kind == 'str':
        return '' if text in NA_VALUES else text
    text = text.strip()
    if text in NA_VALUES:
        return ''
    return str(int(text)) if kind == 'int' else float_text(float(text))


def write_station_table(station_file, out_path, extra: Optional[dict] = None) -> None:
    """Write ``station_file``'s rows, duplicates of (Lat, Lon) dropped (the
    first kept), as pandas would: ``read_csv`` -> ``drop_duplicates`` ->
    the ``extra`` columns (name -> a 1-d array, one value a kept row)
    appended -> ``to_csv(index=False)``. Columns keep their order, and
    strings (IDs) their text; an int column stays int unless it holds a
    blank (then it is float: ``1.0``); floats are written by their shortest
    repr in their dtype (float32 delays as float32), NaN as an empty
    field. The column types are inferred over all rows, duplicates
    included, as pandas infers them before it drops any."""
    with open(station_file, newline='') as f:
        rows = [r for r in csv.reader(f) if r]
    header, rows = rows[0], rows[1:]
    width = len(header)
    kinds = [column_kind([r[j] if j < len(r) else '' for r in rows]) for j in range(width)]
    _, kept, _, _ = read_station_csv(station_file)
    extra = {k: np.asarray(v) for k, v in (extra or {}).items()}
    with open(out_path, 'w', newline='') as f:
        w = csv.writer(f, lineterminator='\n')
        w.writerow(header + list(extra))
        for i, r in enumerate(kept):
            r = r + [''] * (width - len(r))
            w.writerow([_field(k, v) for k, v in zip(kinds, r)]
                       + [float_text(a[i], a.dtype.type) for a in extra.values()])


def makeDelayFileNames(date: Optional[dt.date], los: Optional[LOS], outformat: str,
                       weather_model_name: str, out: Path) -> tuple:
    """Wet/hydro delay output filenames."""
    fmt = '{model_name}_{{}}_{time}{los}.{ext}'.format(
        model_name=weather_model_name,
        time=date.strftime('%Y%m%dT%H%M%S_') if date is not None else '',
        los='ztd' if (isinstance(los, Zenith) or los is None) else 'std',
        ext=outformat.lstrip('.'),
    )
    hydroname, wetname = (fmt.format(d) for d in ('hydro', 'wet'))
    return str(Path(out) / wetname), str(Path(out) / hydroname)


def checkArgs(run_config: RunConfig) -> RunConfig:
    """Make the output directories, combine the dates with the time, and
    name each date's outputs (writing a station file's template CSV)."""
    run_config.runtime_group.output_directory.mkdir(exist_ok=True)
    run_config.runtime_group.weather_model_directory.mkdir(exist_ok=True)
    run_config.weather_model.set_wmLoc(str(run_config.runtime_group.weather_model_directory))

    run_config.date_group.date_list = [
        dt.datetime.combine(d, run_config.time_group.time)
        for d in run_config.date_group.date_list
    ]
    if len(run_config.date_group.date_list) > 1 and run_config.los_group.orbit_file is not None:
        logger.warning(
            'Only one orbit file is being used to get the look vectors for all requested '
            'times. If you want separate orbit files, run separately for each time.'
        )
    run_config.los_group.los.setTime(run_config.date_group.date_list[0])

    wet_names, hydro_names = [], []
    for d in run_config.date_group.date_list:
        aoi = run_config.aoi_group.aoi
        if not isinstance(aoi, BoundingBox):
            if isinstance(aoi, StationFile):
                wet = str(
                    run_config.runtime_group.output_directory /
                    f'{run_config.weather_model._dataset.upper()}_Delay_'
                    f'{d.strftime("%Y%m%dT%H%M%S")}_ztd.csv'
                )
                hydro = ''
                write_station_table(aoi._filename, wet)
            else:
                fmt = get_raster_ext(run_config.runtime_group.file_format)
                wet, hydro = makeDelayFileNames(
                    d, run_config.los_group.los, fmt,
                    run_config.weather_model._dataset.upper(),
                    run_config.runtime_group.output_directory,
                )
        else:
            ff = run_config.runtime_group.file_format
            if ff not in ('.nc', '.h5', 'h5', 'hdf5', '.hdf5', 'nc'):
                fmt = 'nc'
                logger.debug('Invalid extension %s for cube. Defaulting to .nc', ff)
            else:
                fmt = ff.strip('.').replace('df', '')
            wet, hydro = makeDelayFileNames(
                d, run_config.los_group.los, fmt,
                run_config.weather_model._dataset.upper(),
                run_config.runtime_group.output_directory,
            )
        wet_names.append(wet)
        hydro_names.append(hydro)

    run_config.wetFilenames = wet_names
    run_config.hydroFilenames = hydro_names
    return run_config
