"""GNSS zenith-delay acquisition: UNR archive download and SINEX-trop parsing.

The counterpart of ``raider_tpu/workflows/gnss.py``, without pandas: the
station lists and delay tables are column tables (``utils.table``: a dict
of 1-d numpy arrays) read and written with the stdlib ``csv`` module to
the semantics of the JAX package's pandas calls, so the CSVs are
text-identical to its own wherever pandas parses floats correctly rounded
(its default parser is now and then 1 ulp off Python's ``float()``). Network
IO (requests, imported in ``_retry_session`` and ``download_url`` only) runs
on a thread pool.
"""

import argparse
import datetime as dt
import gzip
import io
import itertools
import os
import zipfile
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path
from typing import List, Optional

import numpy as np

from raider_tpu_torch.logger import logger
from raider_tpu_torch.utils import table
from raider_tpu_torch.wx.exceptions import NoStationDataFoundError

_UNR_URL = 'https://geodesy.unr.edu/'
NEW_STATION_FILENAME = 'gnssStationList_overbbox'
_LAT_KEYS = ('lat', 'latitude', 'Lat', 'Latitude')
_LON_KEYS = ('lon', 'longitude', 'Lon', 'Longitude')


# ------------------------------------------------------------- station lists

def _read_whitespace_table(path) -> table.Table:
    """A whitespace-separated file: the first line's names, each row's
    fields as text (NaN past a short row's end)."""
    with open(path) as f:
        lines = [line.strip().split() for line in f]
    names, rows = lines[0], lines[1:]
    if any(len(r) > len(names) for r in rows):
        raise ValueError(f'{len(names)} columns passed, passed data had more columns')
    return {n: np.array([r[j] if j < len(r) else np.nan for r in rows], dtype=object)
            for j, n in enumerate(names)}


def get_station_list(bbox=None, stationFile=None, writeLoc=None,
                     name_appendix: str = '', writeStationFile: bool = True):
    """Stations within a bbox, from UNR holdings or a user file (a CSV; a
    file the CSV reader refuses is read as whitespace-separated columns,
    all text). Returns (IDs, path of the CSV written) with
    ``writeStationFile``, else (IDs, the station table)."""
    if stationFile is not None:
        try:
            station_data = table.read_csv(stationFile)
        except (ValueError, UnicodeDecodeError):
            station_data = _read_whitespace_table(stationFile)
    else:
        station_data = get_stats_by_llh(llhBox=bbox)

    if writeStationFile:
        output_file = os.path.join(writeLoc or os.getcwd(),
                                   NEW_STATION_FILENAME + name_appendix + '.csv')
        table.to_csv(station_data, output_file)
        return list(station_data['ID']), output_file
    return list(station_data['ID']), station_data


def _read_llh(text: str) -> table.Table:
    """UNR's llh.out: ``ID Lat Lon Hgt_m`` rows separated by whitespace."""
    rows = [line.split() for line in text.splitlines() if line.strip()]
    cols = [[r[j] if j < len(r) else '' for r in rows] for j in range(4)]
    return {name: table.parse_column(c) for name, c in zip(('ID', 'Lat', 'Lon', 'Hgt_m'), cols)}


def get_stats_by_llh(llhBox=None, baseURL: str = _UNR_URL) -> table.Table:
    """UNR's llh.out station holdings (from ``baseURL``: a URL, or a local
    directory holding ``NGLStationPages/llh.out``) filtered to a bbox."""
    if llhBox is None:
        llhBox = [-90, 90, 0, 360]
    S, N, W, E = llhBox
    if W < 0 or E < 0:
        raise ValueError('get_stats_by_llh: bounding box must be on lon range [0, 360]')
    url = f'{baseURL}NGLStationPages/llh.out'
    if url.startswith(('http://', 'https://')):
        r = _retry_session().get(url)
        r.raise_for_status()
        text = r.text
    else:
        text = Path(url).read_text()
    stations = _read_llh(text)
    stations['Lon'] = ((stations['Lon'] + 180) % 360) - 180
    return filterToBBox(stations, llhBox)


def filterToBBox(stations: table.Table, llhBox) -> table.Table:
    """The stations strictly inside a [S, N, W, E] box given on [0, 360]
    longitudes (mapped to [-180, 180) when the stations' are)."""
    S, N, W, E = llhBox
    if W < 0 or E < 0:
        raise ValueError('llhBox longitude format should 0-360')
    index = next((k for k, key in enumerate(_LAT_KEYS) if key in stations), None)
    if index is None:
        raise KeyError('filterToBBox: No valid column names found for latitude and longitude')
    lat, lon = stations[_LAT_KEYS[index]], stations[_LON_KEYS[index]]
    if np.nanmin(lon) < 0:
        W, E = (((d + 180) % 360) - 180 for d in (W, E))
    with np.errstate(invalid='ignore'):
        mask = (lat > S) & (lat < N) & (lon < E) & (lon > W)
    return table.take(stations, np.asarray(mask, dtype=bool))


# ------------------------------------------------------------------ download

def download_tropo_delays(stats, years, gps_repo: str = 'UNR', writeDir: str = '.',
                          numCPUs: int = 8, download: bool = False) -> None:
    """Check for (or download) each station-year's trop archive; writes
    ``<repo>gnssStationList_overbbox_withpaths.csv`` (ID, year, path)."""
    if not isinstance(stats, (list, str)):
        raise TypeError('stats should be a string or a list of strings')
    if not isinstance(years, (list, int)):
        raise TypeError('years should be an int or a list of ints')
    if isinstance(stats, str):
        stats = [stats]
    if isinstance(years, int):
        years = [years]
    if gps_repo != 'UNR':
        raise NotImplementedError(
            f'download_tropo_delays: gps_repo "{gps_repo}" not yet implemented')

    tups = list(itertools.product(stats, years))
    with ThreadPoolExecutor(max_workers=numCPUs) as pool:
        results = list(pool.map(lambda t: download_UNR(t[0], t[1], writeDir, download), tups))
    results = [r for r in results if r['path']]
    if len(results) == 0:
        raise NoStationDataFoundError(station_list=stats, years=years)
    stat_df = {k: np.array([r[k] for r in results],
                           dtype=np.int64 if k == 'year' else object)
               for k in ('ID', 'year', 'path')}
    table.to_csv(stat_df, os.path.join(writeDir, f'{gps_repo}{NEW_STATION_FILENAME}_withpaths.csv'))


def download_UNR(statID: str, year: int, writeDir: str = '.', download: bool = False,
                 baseURL: str = _UNR_URL) -> dict:
    if baseURL != _UNR_URL:
        raise NotImplementedError(f'Data repository {baseURL} has not yet been implemented')
    url = '{0}gps_timeseries/trop/{1}/{1}.{2}.trop.zip'.format(baseURL, statID.upper(), year)
    logger.debug('Currently checking station %s in %s', statID, year)
    if download:
        save_loc = os.path.abspath(os.path.join(writeDir, f'{statID.upper()}.{year}.trop.zip'))
        filepath = download_url(url, save_loc)
        if filepath == '':
            raise ValueError('Year or station ID does not exist')
    else:
        filepath = check_url(url)
    return {'ID': statID, 'year': year, 'path': filepath}


def _retry_session(retries: int = 10):
    import requests
    from requests.adapters import HTTPAdapter
    from urllib3.util.retry import Retry

    session = requests.Session()
    retry = Retry(total=retries, read=retries, connect=retries, backoff_factor=0.3,
                  status_forcelist=list(range(429, 505)))
    adapter = HTTPAdapter(max_retries=retry)
    session.mount('http://', adapter)
    session.mount('https://', adapter)
    return session


def download_url(url: str, save_path: str, chunk_size: int = 2048) -> str:
    session = _retry_session()
    r = session.get(url, stream=True)
    if r.status_code == 404:
        return ''
    with open(save_path, 'wb') as fd:
        for chunk in r.iter_content(chunk_size=chunk_size):
            fd.write(chunk)
    return save_path


def check_url(url: str) -> str:
    session = _retry_session()
    r = session.head(url)
    return '' if r.status_code == 404 else url


# -------------------------------------------------------------- SINEX parse

def get_date(tokens) -> tuple:
    """Date from a trop-file name split on '.'."""
    year = int(tokens[1])
    doy = int(tokens[2])
    return dt.datetime(year, 1, 1) + dt.timedelta(doy - 1), year, doy


def seconds_of_day(returnTime) -> Optional[int]:
    """Seconds of the day of ``HH:MM:SS`` or a ``datetime.time``; None
    passes through, meaning "all times"."""
    if returnTime is None:
        return None
    if isinstance(returnTime, dt.time):
        return returnTime.hour * 3600 + returnTime.minute * 60 + returnTime.second
    h, m, s = map(int, str(returnTime).split(':'))
    return h * 3600 + m * 60 + s


def get_delays_UNR(stationFile, filename, dateList: List[str], returnTime=None) -> None:
    """Parse a UNR SINEX-trop zip into a per-station CSV time series, one
    day's file at a time, appended to ``filename`` (with no header) when it
    exists. Delays in metres on the 300 s grid, epochs without data NaN;
    with ``returnTime`` (seconds of the day) only the epoch nearest to it
    that has data."""
    if str(stationFile).startswith('http'):
        r = _retry_session().get(stationFile)
        ziprepo = zipfile.ZipFile(io.BytesIO(r.content))
    else:
        ziprepo = zipfile.ZipFile(stationFile)

    with ziprepo:
        for j in sorted(ziprepo.namelist()):
            time, _, doy_from_file = get_date(os.path.basename(j).split('.'))
            if time.strftime('%Y-%m-%d') not in dateList:
                continue
            with gzip.open(ziprepo.open(j), 'rb') as f:
                lines = f.readlines()
            d, sig, dwet, dhydro, times_list = [], [], [], [], []
            site = None
            flag = False
            for line in lines:
                try:
                    line = line.decode('utf-8')
                except UnicodeDecodeError:
                    line = line.decode('latin-1')
                if flag:
                    if 'SITE' in line:
                        continue
                    try:
                        split_lines = line.split()
                        # units: mm, mm, mm, deg x4, mm, mm, K
                        trotot, trotot_sd, trwet = (float(t) for t in split_lines[2:5])
                    except (ValueError, IndexError):
                        continue
                    site = split_lines[0]
                    year, doy, seconds = (int(n) for n in split_lines[1].split(':'))
                    if doy != doy_from_file:
                        logger.warning(
                            'time %s from line in conflict with time %s from file %s',
                            doy, doy_from_file, j,
                        )
                        continue
                    d.append(trotot * 0.001)
                    sig.append(trotot_sd * 0.001)
                    dwet.append(trwet * 0.001)
                    dhydro.append((trotot - trwet) * 0.001)
                    times_list.append(seconds)
                if 'TROP/SOLUTION' in line:
                    flag = True
            if not d:
                logger.warning('file %s is empty, continuing', j)
                continue

            true_times = list(range(0, 86400, 300))
            if len(times_list) != len(true_times):
                mask = np.array([t not in times_list for t in true_times])
                delay = np.full((288,), np.nan)
                sig_a = np.full((288,), np.nan)
                wet_delay = np.full((288,), np.nan)
                hydro_delay = np.full((288,), np.nan)
                delay[~mask] = d
                sig_a[~mask] = sig
                wet_delay[~mask] = dwet
                hydro_delay[~mask] = dhydro
                times = np.array(true_times)
            else:
                delay = np.array(d)
                times = np.array(times_list)
                sig_a = np.array(sig)
                wet_delay = np.array(dwet)
                hydro_delay = np.array(dhydro)

            if returnTime is not None:
                # the nearest epoch WITH data in the (re-aligned) arrays
                t_arr = np.asarray(times, dtype=float)
                gap = np.abs(t_arr - returnTime)
                gap = np.where(np.isnan(np.asarray(delay, dtype=float)), np.inf, gap)
                index = int(np.argmin(gap))
                delay, wet_delay, hydro_delay, times, sig_a = (
                    a[index:index + 1] for a in (delay, wet_delay, hydro_delay, times, sig_a))
            n = len(delay)
            out = {
                'ID': np.array([site] * n, dtype=object),
                'Date': np.full(n, np.datetime64(time, 'ns')),
                'ZTD': np.asarray(delay, dtype=np.float64),
                'wet_delay': np.asarray(wet_delay, dtype=np.float64),
                'hydrostatic_delay': np.asarray(hydro_delay, dtype=np.float64),
                'times': np.asarray(times, dtype=np.int64),
                'sigZTD': np.asarray(sig_a, dtype=np.float64),
            }
            if Path(filename).exists():
                table.to_csv(out, filename, mode='a', header=False)
            else:
                table.to_csv(out, filename)


def _rename_latlon(t: table.Table) -> table.Table:
    lat_key = next(k for k in _LAT_KEYS if k in t)
    lon_key = next(k for k in _LON_KEYS if k in t)
    rename = {lat_key: 'Lat', lon_key: 'Lon'}
    return {rename.get(k, k): v for k, v in t.items()}


def get_station_data(inFile, dateList, gps_repo: Optional[str] = None, numCPUs: int = 8,
                     outDir: Optional[str] = None, returnTime=None) -> None:
    """Parse each station's archive (``inFile``'s ``path`` column) into
    ``GPS_delays/<ID>_ztd.csv``, then write the network's delays with the
    stations' Lat, Lon and Hgt_m, rows with a blank dropped, sorted by ID
    and date, to ``<repo>combinedGPS_ztd.csv``."""
    outDir = outDir or os.getcwd()
    pathbase = Path(outDir) / 'GPS_delays'
    pathbase.mkdir(exist_ok=True)

    returnTime = seconds_of_day(returnTime)
    if returnTime is not None and returnTime % 3 != 0:
        grid = np.array(list(range(0, 86400, 300)))
        returnTime = int(grid[np.argmin(np.abs(grid - returnTime))])

    station_files = list(table.read_csv(inFile)['path'])

    outputfiles = []
    if len(station_files) > 0 and gps_repo == 'UNR':
        args = []
        for sf in station_files:
            station_id = os.path.basename(sf).split('.')[0]
            name = pathbase / f'{station_id}_ztd.csv'
            args.append((sf, name, dateList, returnTime))
            outputfiles.append(name)
        with ThreadPoolExecutor(max_workers=numCPUs) as pool:
            list(pool.map(lambda a: get_delays_UNR(*a), args))

    outputfiles = [p for p in outputfiles if Path(p).exists()]
    if len(outputfiles) == 0:
        raise RuntimeError('No valid delays found for specified time/region.')

    name = Path(outDir) / f'{gps_repo}combinedGPS_ztd.csv'
    stats = table.drop_duplicates(table.concat([table.read_csv(p) for p in outputfiles]))
    table.to_csv(stats, name)

    origstats = _rename_latlon(table.read_csv(inFile))
    stats = table.merge(table.read_csv(name),
                        {k: origstats[k] for k in ('ID', 'Lat', 'Lon', 'Hgt_m')}, on=['ID'])
    stats = table.drop_duplicates(table.dropna(stats))
    table.to_csv(table.sort_values(stats, ['ID', 'Date']), name)


# ---------------------------------------------------------------- entrypoint

def downloadGNSS(iargs: Optional[list] = None) -> None:
    """Download GNSS ZTD archives over an AOI and parse them into the
    network's delay table (``<repo>combinedGPS_ztd.csv`` in ``--out``)."""
    from raider_tpu_torch.workflows.config import TimeGroup, coerce_into_date

    p = argparse.ArgumentParser(
        description='Check for and download tropospheric zenith delays for a set of GNSS stations',
    )
    p.add_argument('--out', default='.', help='Output directory')
    p.add_argument('--date', dest='dateList', nargs='+', required=True,
                   help='Date(s) YYYYMMDD or range YYYYMMDD YYYYMMDD [step]')
    p.add_argument('--returntime', dest='time', default=None,
                   help='Time of day HH:MM:SS to return delays for '
                        '(default: all times)')
    p.add_argument('-b', '--bounding_box', '--bbox', dest='bounding_box', default=None,
                   help='Bounding box "S N W E"')
    p.add_argument('--station_file', '-f', default=None,
                   help='CSV of station IDs/locations')
    p.add_argument('--gpsrepo', '-gr', dest='gps_repo', default='UNR')
    p.add_argument('--download', action='store_true', default=False,
                   help='Physically download the archives (virtual access otherwise)')
    p.add_argument('--cpus', default='all',
                   type=lambda v: os.cpu_count() if v == 'all' else int(v),
                   help='Worker count, or "all"')
    p.add_argument('--verbose', '-v', action='count', default=0)
    args = p.parse_args(iargs)

    # parse dates: single, list, or start/end[/step]
    toks = args.dateList
    if len(toks) == 1:
        dates = [coerce_into_date(toks[0])]
    elif len(toks) in (2, 3):
        start = coerce_into_date(toks[0])
        end = coerce_into_date(toks[1])
        step = int(toks[2]) if len(toks) == 3 else 1
        dates = [start + dt.timedelta(days=k) for k in range(0, (end - start).days + 1, step)]
    else:
        dates = [coerce_into_date(t) for t in toks]

    return_time = TimeGroup.coerce_into_time(args.time) if args.time else None
    out = args.out
    os.makedirs(out, exist_ok=True)

    if args.bounding_box:
        bbox, long_cross_zero = _parse_gnss_bbox(args.bounding_box)
    else:
        bbox = [-90, 90, 0, 360]
        long_cross_zero = 1

    stats, statdf = _get_stats(bbox, long_cross_zero, out, args.station_file)

    years = sorted({d.year for d in dates})
    download_tropo_delays(stats, years, gps_repo=args.gps_repo, writeDir=out,
                          numCPUs=args.cpus, download=args.download)

    paths_file = os.path.join(out, f'{args.gps_repo}{NEW_STATION_FILENAME}_withpaths.csv')
    table.to_csv(table.merge(table.read_csv(paths_file), statdf, on=['ID']), paths_file)

    date_strs = [d.strftime('%Y-%m-%d') for d in dates]
    get_station_data(paths_file, date_strs, gps_repo=args.gps_repo, numCPUs=args.cpus,
                     outDir=out, returnTime=return_time)
    logger.debug('Completed processing')


def _parse_gnss_bbox(bounding_box):
    """"S N W E" (or a list) -> ([S, N, W, E] on [0, 360] longitudes,
    whether the box crosses the prime meridian)."""
    if isinstance(bounding_box, str) and not os.path.isfile(bounding_box):
        bbox = [float(val) for val in bounding_box.split()]
    elif isinstance(bounding_box, list):
        bbox = [float(v) for v in bounding_box]
    else:
        raise Exception('Passing a file with a bounding box not yet supported.')
    long_cross_zero = 1 if bbox[2] * bbox[3] < 0 else 0
    if bbox[2] < 0:
        bbox[2] += 360
    if bbox[3] < 0:
        bbox[3] += 360
    return bbox, long_cross_zero


def _get_stats(bbox, long_cross_zero, out, station_file):
    """The station IDs and table over the box (split at 0/360 when it
    crosses the prime meridian); writes ``gnssStationList_overbbox.csv``."""
    if long_cross_zero == 1:
        bbox1 = bbox.copy()
        bbox2 = bbox.copy()
        bbox1[3] = 360.0
        bbox2[2] = 0.0
        stats1, statdata1 = get_station_list(bbox=bbox1, stationFile=station_file,
                                             writeStationFile=False)
        stats2, statdata2 = get_station_list(bbox=bbox2, stationFile=station_file,
                                             writeStationFile=False)
        stats = list(set(stats1 + stats2))
        statdata = table.drop_duplicates(table.concat([statdata1, statdata2]), subset=['ID'])
    else:
        if bbox[3] < bbox[2]:
            bbox[3] = 360.0
        stats, statdata = get_station_list(bbox=bbox, stationFile=station_file,
                                           writeStationFile=False)
    table.to_csv(statdata, os.path.join(out, NEW_STATION_FILENAME + '.csv'))
    return stats, statdata
