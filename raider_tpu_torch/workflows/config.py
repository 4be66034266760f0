"""Run configuration: YAML schema, dataclasses, and validators.

The counterpart of ``raider_tpu/workflows/config.py``: the same schema (six
groups plus weather_model and look_dir) and the same validation. The YAML
is read and written by ``workflows.yaml_subset`` (no PyYAML), and a
station CSV's header by the port's stdlib reader (no pandas).
"""

import dataclasses
import datetime as dt
import itertools
import re
import time as _time
from pathlib import Path
from typing import Any, Optional, Union

import numpy as np

from raider_tpu_torch.constants import _CUBE_SPACING_IN_M
from raider_tpu_torch.geometry.aoi import (
    AOI,
    BoundingBox,
    Geocube,
    GeocodedFile,
    RasterRDR,
    StationFile,
    read_station_csv,
)
from raider_tpu_torch.geometry.los import LOS, Conventional, Raytracing, Zenith
from raider_tpu_torch.logger import logger
from raider_tpu_torch.utils.bbox import getBufferedExtent, isInside, isOutside  # noqa: F401 (validator API parity)
from raider_tpu_torch.wx.base import WeatherModel
from raider_tpu_torch.workflows import yaml_subset
from raider_tpu_torch.wx.registry import get_wm_by_name

_BUFFER_SIZE = 0.2  # degrees, DEM-coverage check buffer


# ------------------------------------------------------------------ dataclasses

@dataclasses.dataclass
class DateGroupUnparsed:
    date_start: Optional[Union[int, str]] = None
    date_end: Optional[Union[int, str]] = None
    date_step: Optional[Union[int, str]] = None
    date_list: Optional[Union[int, str, list]] = None


@dataclasses.dataclass
class DateGroup:
    date_list: list


class TimeGroup:
    """ISO-8601-ish time parsing."""

    _DEFAULT_ACQUISITION_WINDOW_SEC = 30
    TIME_FORMATS = (
        '', 'T%H:%M:%S.%f', 'T%H%M%S.%f', '%H%M%S.%f', 'T%H:%M:%S', '%H:%M:%S',
        'T%H%M%S', '%H%M%S', 'T%H:%M', 'T%H%M', '%H:%M', 'T%H',
    )
    TIMEZONE_FORMATS = ('', 'Z', '%z')

    def __init__(self, time=None, end_time=None, interpolate_time=None) -> None:
        self.interpolate_time = interpolate_time
        if time is None:
            raise ValueError('You must specify a "time" in the input config file')
        self.time = time if isinstance(time, dt.time) else TimeGroup.coerce_into_time(time)

        if end_time is not None:
            self.end_time = end_time if isinstance(end_time, dt.time) else TimeGroup.coerce_into_time(end_time)
            if self.end_time < self.time:
                raise ValueError(
                    f'Acquisition start time must be before end time. Provided start '
                    f'time {self.time} is later than end time {self.end_time}'
                )
        else:
            sentinel = dt.datetime.combine(dt.date(1900, 1, 1), self.time)
            self.end_time = (sentinel + dt.timedelta(seconds=self._DEFAULT_ACQUISITION_WINDOW_SEC)).time()
            if self.end_time < self.time:
                raise ValueError('Acquisition start time must be before end time.')

    @staticmethod
    def coerce_into_time(val) -> dt.time:
        val = str(val)
        for tf in map(''.join, itertools.product(TimeGroup.TIME_FORMATS, TimeGroup.TIMEZONE_FORMATS)):
            try:
                return dt.time(*_time.strptime(val, tf)[3:6])
            except ValueError:
                pass
        raise ValueError(f'Unable to coerce "{val}" to a time. Try T%H:%M:%S')


@dataclasses.dataclass
class AOIGroupUnparsed:
    bounding_box: Optional[Union[str, list]] = None
    geocoded_file: Optional[str] = None
    lat_file: Optional[str] = None
    lon_file: Optional[str] = None
    station_file: Optional[str] = None
    geo_cube: Optional[str] = None


@dataclasses.dataclass
class AOIGroup:
    aoi: AOI


@dataclasses.dataclass
class HeightGroupUnparsed:
    dem: Optional[str] = None
    use_dem_latlon: bool = False
    height_file_rdr: Optional[str] = None
    height_levels: Optional[Union[str, list]] = None


@dataclasses.dataclass
class HeightGroup:
    dem: Optional[str]
    use_dem_latlon: bool
    height_file_rdr: Optional[str]
    height_levels: Optional[list]


@dataclasses.dataclass
class LOSGroupUnparsed:
    ray_trace: bool = False
    los_file: Optional[str] = None
    los_convention: str = 'isce'
    los_cube: Optional[str] = None
    orbit_file: Optional[Union[str, list]] = None
    zref: Optional[float] = None


@dataclasses.dataclass
class LOSGroup:
    los: LOS
    ray_trace: bool = False
    los_file: Optional[str] = None
    los_convention: str = 'isce'
    los_cube: Optional[str] = None
    orbit_file: Optional[Union[str, list]] = None
    zref: Optional[float] = None


class RuntimeGroup:
    """Output/runtime options."""

    def __init__(
        self,
        raster_format: str = 'ENVI',
        file_format: str = 'ENVI',
        verbose: bool = True,
        output_projection: str = 'EPSG:4326',
        cube_spacing_in_m: float = _CUBE_SPACING_IN_M,
        download_only: bool = False,
        output_directory: str = '.',
        weather_model_directory: Optional[str] = None,
        nproc: int = 1,
    ) -> None:
        self.raster_format = raster_format
        self.file_format = file_format
        self.verbose = verbose
        self.output_projection = output_projection
        self.cube_spacing_in_m = cube_spacing_in_m
        self.download_only = download_only
        self.output_directory = Path(output_directory)
        if weather_model_directory is not None:
            self.weather_model_directory = Path(weather_model_directory)
        else:
            self.weather_model_directory = self.output_directory / 'weather_files'
        self.nproc = nproc


@dataclasses.dataclass
class RunConfig:
    weather_model: WeatherModel
    date_group: DateGroup
    time_group: TimeGroup
    aoi_group: AOIGroup
    height_group: HeightGroup
    los_group: LOSGroup
    runtime_group: RuntimeGroup
    look_dir: str = 'right'
    cube_spacing_in_m: Optional[float] = None  # deprecated
    wetFilenames: Optional[list] = None
    hydroFilenames: Optional[list] = None


# ------------------------------------------------------------------ validators

def parse_weather_model(weather_model_name: str, aoi: AOI) -> WeatherModel:
    name = weather_model_name.upper().replace('-', '')
    try:
        _, Model = get_wm_by_name(name)
    except ModuleNotFoundError:
        raise NotImplementedError(
            f'Model {weather_model_name} is not yet fully implemented, please contribute!'
        )
    model = Model()
    model.checkValidBounds(aoi.bounds())
    return model


def get_los(los_group: LOSGroupUnparsed) -> LOS:
    if los_group.orbit_file is not None:
        if los_group.ray_trace:
            return Raytracing(los_group.orbit_file)
        return Conventional(los_group.orbit_file)
    if los_group.los_file is not None:
        if los_group.ray_trace:
            return Raytracing(los_group.los_file, los_group.los_convention)
        return Conventional(los_group.los_file, los_group.los_convention)
    if los_group.los_cube is not None:
        raise NotImplementedError('LOS_cube is not yet implemented')
    return Zenith()


def get_heights(height_group: HeightGroupUnparsed, aoi_group: AOIGroupUnparsed,
                runtime_group: RuntimeGroup) -> HeightGroup:
    result = HeightGroup(
        dem=height_group.dem,
        use_dem_latlon=height_group.use_dem_latlon,
        height_file_rdr=height_group.height_file_rdr,
        height_levels=None,
    )

    if height_group.dem is not None:
        if aoi_group.station_file is not None:
            header = read_station_csv(aoi_group.station_file)[0]
            if 'Hgt_m' not in header:
                result.dem = str(runtime_group.output_directory / 'GLO30.dem')
        elif Path(height_group.dem).exists() and aoi_group.bounding_box is not None:
            from raider_tpu_torch.io.rasters import rio_extents, rio_profile

            dem_bounds = rio_extents(rio_profile(height_group.dem))
            s, n, w, e = parse_bbox(aoi_group.bounding_box)
            if (s < dem_bounds[0] - _BUFFER_SIZE or n > dem_bounds[1] + _BUFFER_SIZE
                    or w < dem_bounds[2] - _BUFFER_SIZE or e > dem_bounds[3] + _BUFFER_SIZE):
                raise ValueError(
                    'Existing DEM does not cover the area of the input lat/lon points; '
                    'either move the DEM, delete it, or change the input points.'
                )
    elif height_group.height_file_rdr is None:
        result.dem = str(runtime_group.output_directory / 'GLO30.dem')

    if height_group.height_levels is not None:
        if isinstance(height_group.height_levels, str):
            levels = re.findall('[-0-9]+', height_group.height_levels)
        else:
            levels = height_group.height_levels
        levels = np.array([float(level) for level in levels])
        if np.any(levels < 0):
            logger.warning(
                'Weather model only extends to the surface topography; height levels '
                'below the topography will be interpolated from the surface and may be inaccurate.'
            )
        result.height_levels = list(levels)

    return result


def get_query_region(aoi_group: AOIGroupUnparsed, height_group: HeightGroupUnparsed,
                     cube_spacing_in_m: float) -> AOI:
    if height_group.use_dem_latlon:
        return GeocodedFile(Path(height_group.dem), is_dem=True, cube_spacing_in_m=cube_spacing_in_m)

    if aoi_group.lat_file is not None or aoi_group.lon_file is not None:
        if aoi_group.lat_file is None or aoi_group.lon_file is None:
            raise ValueError('A lon_file must be specified if a lat_file is specified')
        return RasterRDR(
            aoi_group.lat_file, aoi_group.lon_file,
            height_group.height_file_rdr, height_group.dem,
            cube_spacing_in_m=cube_spacing_in_m,
        )

    if aoi_group.station_file is not None:
        return StationFile(aoi_group.station_file, cube_spacing_in_m=cube_spacing_in_m)

    if aoi_group.bounding_box is not None:
        bbox = parse_bbox(aoi_group.bounding_box)
        return BoundingBox(list(bbox), cube_spacing_in_m=cube_spacing_in_m)

    if aoi_group.geocoded_file is not None:
        path = Path(aoi_group.geocoded_file)
        is_dem = path.name.upper().startswith(('SRTM', 'GLO'))
        return GeocodedFile(path, is_dem=is_dem, cube_spacing_in_m=cube_spacing_in_m)

    if aoi_group.geo_cube is not None:
        return Geocube(aoi_group.geo_cube, cube_spacing_in_m)

    raise ValueError('No valid query points or bounding box found in the configuration file')


def parse_bbox(bbox) -> tuple:
    if isinstance(bbox, str):
        bbox = [float(d) for d in bbox.strip().split()]
    else:
        bbox = [float(d) for d in bbox]
    if len(bbox) != 4:
        raise ValueError('bounding box must have 4 elements!')
    S, N, W, E = bbox
    if N <= S or E <= W:
        raise ValueError('Bounding box has no size; make sure you use "S N W E"')
    for sn in (S, N):
        if sn < -90 or sn > 90:
            raise ValueError('Lats are out of S/N bounds (-90 to 90).')
    for we in (W, E):
        if we < -180 or we > 180:
            raise ValueError(
                'Lons are out of W/E bounds (-180 to 180); Lons in the format of '
                '(0 to 360) are not supported.'
            )
    return S, N, W, E


def coerce_into_date(val) -> dt.date:
    for yf in ('%Y-%m-%d', '%Y%m%d', '%d', '%j'):
        try:
            return dt.datetime.strptime(str(val), yf).date()
        except ValueError:
            pass
    raise ValueError(f'Unable to coerce {val} to a date. Try %Y-%m-%d')


def parse_dates(date_group: DateGroupUnparsed) -> DateGroup:
    if date_group.date_list is not None:
        if isinstance(date_group.date_list, str):
            unparsed = re.findall('[0-9]+', date_group.date_list)
        elif isinstance(date_group.date_list, int):
            unparsed = [date_group.date_list]
        else:
            unparsed = date_group.date_list
        date_list = [coerce_into_date(d) for d in unparsed]
    else:
        if date_group.date_start is None:
            raise ValueError('Inputs must include either date_list or date_start')
        start = coerce_into_date(date_group.date_start)
        end = coerce_into_date(date_group.date_end) if date_group.date_end is not None else start
        step = int(date_group.date_step) if date_group.date_step else 1
        date_list = [start + dt.timedelta(days=s) for s in range(0, (end - start).days + 1, step)]
    return DateGroup(date_list=date_list)


def drop_nans(d: dict) -> dict:
    out = {}
    for key, value in d.items():
        if value is None:
            continue
        if isinstance(value, dict):
            out[key] = {k: v for k, v in value.items() if v is not None}
        else:
            out[key] = value
    return out


def read_run_config_file(path) -> RunConfig:
    """YAML run config -> validated RunConfig"""
    path = Path(path)
    with path.open() as f:
        try:
            yaml_data: dict[str, Any] = yaml_subset.safe_load(f)
        except ValueError as exc:
            raise ValueError(f'Something is wrong with the yaml file {path}: {exc}')

    yaml_data = drop_nans(yaml_data)
    for key in ('date_group', 'time_group', 'aoi_group', 'height_group', 'los_group', 'runtime_group'):
        if key not in yaml_data or yaml_data[key] is None:
            yaml_data[key] = {}

    yaml_data.setdefault('look_dir', 'right')
    if not isinstance(yaml_data['look_dir'], str) or yaml_data['look_dir'].lower() not in ('right', 'left'):
        raise ValueError(f'Unknown look direction {yaml_data["look_dir"]}')

    if 'cube_spacing_in_m' in yaml_data:
        logger.warning(
            'Run config option cube_spacing_in_m is deprecated. '
            'Please use runtime_group.cube_spacing_in_m instead.'
        )
        yaml_data['runtime_group']['cube_spacing_in_m'] = yaml_data['cube_spacing_in_m']

    height_group_unparsed = HeightGroupUnparsed(**yaml_data['height_group'])
    aoi_group_unparsed = AOIGroupUnparsed(**yaml_data['aoi_group'])
    runtime_group = RuntimeGroup(**yaml_data['runtime_group'])
    aoi_group = AOIGroup(
        aoi=get_query_region(
            aoi_group_unparsed, height_group_unparsed,
            cube_spacing_in_m=runtime_group.cube_spacing_in_m,
        )
    )

    return RunConfig(
        look_dir=yaml_data['look_dir'].lower(),
        weather_model=parse_weather_model(yaml_data['weather_model'], aoi_group.aoi),
        date_group=parse_dates(DateGroupUnparsed(**yaml_data['date_group'])),
        time_group=TimeGroup(**yaml_data['time_group']),
        aoi_group=aoi_group,
        height_group=get_heights(
            height_group=height_group_unparsed,
            aoi_group=aoi_group_unparsed,
            runtime_group=runtime_group,
        ),
        los_group=LOSGroup(
            los=get_los(LOSGroupUnparsed(**yaml_data['los_group'])),
            **yaml_data['los_group'],
        ),
        runtime_group=runtime_group,
    )


def write_yaml(content: dict, dst) -> Path:
    """Write a run config derived from the template"""
    template = Path(__file__).parent.parent / 'cli' / 'examples' / 'template' / 'template.yaml'
    with template.open() as f:
        params = yaml_subset.safe_load(f)
    params = {**params, **content}
    dst = Path(dst)
    with dst.open('w') as fh:
        yaml_subset.dump(params, fh)
    logger.info('Wrote new cfg file: %s', str(dst))
    return dst
