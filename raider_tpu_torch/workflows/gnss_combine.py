"""Combine model delay CSVs and merge them with GNSS ZTD observations.

The counterpart of ``raider_tpu/workflows/gnss_combine.py``, without
pandas. Where the JAX package passes DataFrames, this module passes column
tables (``raider_tpu_torch.utils.table.Table``): a ``dict`` from column
name to a 1-d numpy array, every column of one length, in column order;
numbers are ``int64`` or ``float64`` (NaN where blank), text is ``object``,
and datetimes (``Datetime``, ``Localtime``, a parsed ``Date``) are
``datetime64[ns]``. Each column holds the values of the JAX DataFrame's
column of that name, in its row order. The CSVs are written as pandas'
``to_csv(index=False)`` writes them.

    python -m raider_tpu_torch.workflows.gnss_combine --raider combined.csv [...]
"""

import argparse
import datetime as dt
import math
import os
import re
from pathlib import Path

import numpy as np

from raider_tpu_torch.utils import table

_ROT_RATE_DEG_PER_HR = 360.0 / 23.9333333333  # earth rotation for local time


def getDateTime(path) -> dt.datetime:
    match = re.compile(r'\d{8}T\d{6}').search(Path(path).name)
    return dt.datetime.strptime(match.group(), '%Y%m%dT%H%M%S')


def addDateTimeToFiles(file_paths, force: bool = False, verbose: bool = False) -> None:
    """Add a ``Datetime`` column (the date-time in each file's name) to each
    model delay CSV, rows with a blank and duplicate rows dropped."""
    for path in file_paths:
        data = table.read_csv(path)
        if 'Datetime' in data and not force:
            continue
        try:
            data['Datetime'] = np.full(table.n_rows(data), np.datetime64(getDateTime(path), 'ns'))
            data = table.drop_duplicates(table.dropna(data))
            table.to_csv(data, path)
        except (AttributeError, ValueError):
            print(f'File {path} does not contain datetime info, skipping')


def _timedeltas(seconds: np.ndarray) -> np.ndarray:
    """Whole or fractional seconds as timedelta64[ns], rounded to the
    microsecond like ``datetime.timedelta(seconds=x)``."""
    return np.array([np.timedelta64(dt.timedelta(seconds=float(s)), 'ns') for s in seconds],
                    dtype='timedelta64[ns]')


def readZTDFile(filename, col_name: str = 'ZTD') -> table.Table:
    """A GNSS delay CSV with a ``Datetime`` column (``Date`` + ``times``
    seconds, or its own), ``col_name`` renamed ``ZTD``."""
    try:
        data = table.read_csv(filename, parse_dates=['Date'])
        data['Datetime'] = data['Date'] + _timedeltas(data['times'])
    except (KeyError, ValueError):
        data = table.read_csv(filename, parse_dates=['Datetime'])
    return {('ZTD' if k == col_name else k): v for k, v in data.items()}


def _as_datetimes(col: np.ndarray) -> np.ndarray:
    if col.dtype.kind == 'M':
        return col
    return table.parse_datetimes([str(v) for v in col])


def _dates(col: np.ndarray) -> np.ndarray:
    return col.astype('datetime64[D]')


def pass_common_obs(reference: table.Table, target: table.Table, localtime=None) -> table.Table:
    """The target's rows whose date, ID (and ``localtime`` column) occur in
    the reference."""
    if table.n_rows(target) and isinstance(target['Datetime'][0], str):
        target = {**target, 'Datetime': _as_datetimes(target['Datetime'])}
    sel = (table.isin(_dates(target['Datetime']), _dates(reference['Datetime']))
           & table.isin(target['ID'], reference['ID']))
    if localtime:
        sel &= table.isin(target[localtime], reference[localtime])
    return table.take(target, sel)


def concatDelayFiles(fileList, sort_list=('ID', 'Datetime'), return_df: bool = False,
                     outName=None, source: str = 'model', ref=None, col_name: str = 'ZTD'):
    """Concatenate delay CSVs (model CSVs, or GNSS ones through
    :func:`readZTDFile`), duplicates dropped, sorted by ``sort_list``;
    returns the table, or writes it (rows with a blank dropped) to
    ``outName``."""
    df_list = []
    for f in fileList:
        if source == 'model':
            df_list.append(table.read_csv(f, parse_dates=['Datetime']))
        else:
            df_list.append(readZTDFile(f, col_name=col_name))
    if ref:
        dfr = table.read_csv(ref, parse_dates=['Datetime'])
        df_list = [pass_common_obs(dfr, df) for df in df_list]
    df_c = table.sort_values(table.drop_duplicates(table.concat(df_list)), list(sort_list))
    if return_df or outName is None:
        return df_c
    table.to_csv(table.drop_duplicates(table.dropna(df_c)), outName)
    return None


def combineDelayFiles(out_path, loc=Path.cwd(), source: str = 'model', ext: str = '.csv',
                      ref=None, col_name: str = 'ZTD') -> None:
    """Combine the delay CSVs of a directory into ``out_path``."""
    file_paths = list(Path(loc).glob('*' + ext))
    if source == 'model':
        addDateTimeToFiles(file_paths)
    if len(file_paths) == 1:
        if source == 'model':
            import shutil

            shutil.copy(file_paths[0], out_path)
        else:
            df = readZTDFile(file_paths[0], col_name=col_name)
            table.to_csv(table.drop_duplicates(table.dropna(df)), out_path)
        return
    try:
        concatDelayFiles(file_paths, sort_list=['ID', 'Datetime'], outName=out_path, source=source)
    except Exception:
        concatDelayFiles(file_paths, sort_list=['ID', 'Date'], outName=out_path,
                         source=source, ref=ref, col_name=col_name)


def update_time(row, localTime_hrs):
    """A row's local time: ``row`` maps Datetime (a ``datetime``),
    Localtime (hours east of Greenwich) and Lon."""
    local_estimate = row['Datetime'].replace(hour=localTime_hrs, minute=0, second=0)
    time_shift = dt.timedelta(days=0)
    days_diff = (
        row['Datetime'] - dt.timedelta(seconds=math.floor(row['Localtime']) * 3600)
    ).day - local_estimate.day
    if row['Lon'] < 0 and days_diff != 0:
        time_shift = dt.timedelta(days=1)
    if row['Lon'] > 0 and days_diff != 0:
        time_shift = -dt.timedelta(days=1)
    return local_estimate + dt.timedelta(seconds=row['Localtime'] * 3600) + time_shift


def _pydatetime(v: np.datetime64) -> dt.datetime:
    ns = int(v.astype('datetime64[ns]').astype(np.int64))
    return dt.datetime(1970, 1, 1) + dt.timedelta(microseconds=ns // 1000)


def local_time_filter(raiderFile, ztdFile, dfr, dfz, localTime):
    """Both tables' rows within ``thresh`` hours of ``hrs`` local time
    (``localTime`` is "<hrs> <thresh>"), each with its ``Localtime``."""
    hrs = int(localTime.split(' ')[0])
    thresh = int(localTime.split(' ')[1])
    out = []
    for df in (dfr, dfz):
        # local-time shift from 0-longitude: rotation rate 360 deg / 23.933 hr
        hours = df['Lon'] / _ROT_RATE_DEG_PER_HR
        local = [update_time({'Datetime': _pydatetime(t), 'Localtime': h, 'Lon': lon}, hrs)
                 for t, h, lon in zip(df['Datetime'], hours, df['Lon'])]
        local = np.array([np.datetime64(v, 'ns') for v in local], dtype='datetime64[ns]')
        df = {**df, 'Localtime': local}
        upper = local + np.timedelta64(thresh, 'h')
        lower = local - np.timedelta64(thresh, 'h')
        keep = (df['Datetime'] >= lower) & (df['Datetime'] <= upper)
        out.append(table.drop_duplicates(table.dropna(table.take(df, keep))))
    return out[0], out[1]


def main(raider_file, ztd_file, col_name: str = 'ZTD', raider_delay: str = 'totalDelay',
         out_path=None, local_time=None):
    """Merge combined model delays with GNSS ZTD and compute residuals
    ``ZTD_minus_RAiDER``; returns the merged table, or writes it (rows
    with a blank dropped) to ``out_path``."""
    print(f'Merging delay files {raider_file} and {ztd_file}')
    dfr = table.read_csv(raider_file, parse_dates=['Datetime'])
    expected = ['ID', 'Lat', 'Lon', 'Hgt_m', 'Datetime', 'wetDelay', 'hydroDelay', raider_delay]
    dfr = {k: v for k, v in dfr.items() if k in expected}
    # to the 5-minute floor
    dfr['Datetime'] = dfr['Datetime'].astype('datetime64[m]')
    dfr['Datetime'] = (dfr['Datetime'] - dfr['Datetime'].astype(np.int64) % 5).astype(
        'datetime64[ns]')

    dfz = table.read_csv(ztd_file, parse_dates=['Date'])
    if 'Datetime' not in dfz:
        if 'Date' in dfz:
            date = dfz['Date'].astype('datetime64[D]').astype('datetime64[ns]')
            if 'times' in dfz:
                dfz['Datetime'] = date + _timedeltas(dfz['times'])
            else:
                dfz['Datetime'] = date
        else:
            raise ValueError(
                f'Datetime key not found in {ztd_file}; please ensure that '
                '"Datetime" or "Date" plus "times" is included'
            )
    expected = ['ID', 'Datetime', 'wet_delay', 'hydrostatic_delay', 'times', 'sigZTD',
                'Lat', 'Lon', 'Hgt_m', col_name]
    dfz = {('ZTD' if k == col_name else k): v for k, v in dfz.items() if k in expected}

    dfz = pass_common_obs(dfr, dfz)
    dfr = pass_common_obs(dfz, dfr)

    common_keys = ['Datetime', 'ID']
    if local_time is not None:
        dfr, dfz = local_time_filter(raider_file, ztd_file, dfr, dfz, local_time)
        common_keys.append('Localtime')
        dfz = pass_common_obs(dfr, dfz, localtime='Localtime')
        dfr = pass_common_obs(dfz, dfr, localtime='Localtime')

    dfr = table.drop_duplicates(table.dropna(dfr))
    dfz = table.drop_duplicates(table.dropna(dfz))

    print('Beginning merge')
    dfc = table.merge(dfr, {k: dfz[k] for k in common_keys + ['ZTD', 'sigZTD']},
                      on=common_keys, sort=True)
    if 'Localtime' in dfc:
        diff = np.abs((dfc['Datetime'] - dfc['Localtime']) / np.timedelta64(1, 's') / 3600)
        # per (ID, Localtime) group, in the groups' sorted order, the first
        # row of least difference
        keys = table.row_keys(dfc, ['ID', 'Localtime'])
        best = {}
        for i, key in enumerate(keys):
            if not np.isnan(diff[i]) and (key not in best or diff[i] < diff[best[key]]):
                best[key] = i
        groups = {'ID': np.array([k[0] for k in best], dtype=object),
                  'Localtime': np.array([k[1] for k in best], dtype='datetime64[ns]')}
        dfc = table.take(dfc, np.array(list(best.values()), dtype=np.int64)[
            table.order(groups, ['ID', 'Localtime'])])

    dfc['ZTD_minus_RAiDER'] = dfc['ZTD'] - dfc[raider_delay]
    print('Merge finished')

    if out_path is None:
        return dfc
    table.to_csv(table.drop_duplicates(table.dropna(dfc)), out_path)
    return None


def file_choices(parser: argparse.ArgumentParser, choices, fname: str) -> Path:
    """Argparse type: require one of ``choices`` file extensions."""
    ext = os.path.splitext(fname)[1][1:]
    if ext not in [c.lstrip('.') for c in choices]:
        parser.error(f'File {fname} must end with one of {choices}')
    return Path(fname)


def parse_dir(parser: argparse.ArgumentParser, fname: str) -> Path:
    """Argparse type: require an existing directory."""
    if not os.path.isdir(fname):
        parser.error(f'{fname} is not a directory')
    return Path(fname)


def create_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        description='Combine delay files from a directory and merge with GNSS ZTD',
    )
    p.add_argument('--raider', dest='raider_file', required=True,
                   type=lambda s: file_choices(p, ('csv', '.csv'), s),
                   help='Combined RAiDER delay CSV (created from --raiderDir if missing)')
    p.add_argument('--raiderDir', '-d', dest='raider_folder', default=Path.cwd(),
                   type=lambda s: parse_dir(p, s))
    p.add_argument('--gnssDir', '-gd', dest='gnss_folder', default=Path.cwd(),
                   type=lambda s: parse_dir(p, s))
    p.add_argument('--gnss', dest='gnss_file', default=None,
                   type=lambda s: file_choices(p, ('csv', '.csv'), s))
    p.add_argument('--raider_column', '-r', dest='raider_column_name', default='totalDelay')
    p.add_argument('--column', '-c', dest='column_name', default='ZTD')
    p.add_argument('--out', '-o', dest='out_name', type=Path,
                   default=Path('Combined_delays.csv'))
    p.add_argument('--localtime', '-lt', dest='local_time', default=None,
                   help='"<hour> <threshold_hrs>"')
    p.add_argument('--verbose', '-v', action='store_true')
    return p


def combineZTDFiles(iargs=None) -> None:
    """CLI entry: combine the model (and GNSS) delay CSVs and merge them."""
    p = create_parser()
    args = p.parse_args(iargs)
    if not args.raider_file.exists():
        combineDelayFiles(args.raider_file, loc=args.raider_folder)
    if args.gnss_file is None:
        return
    if not args.gnss_file.exists():
        combineDelayFiles(args.gnss_file, loc=args.gnss_folder, source='GNSS',
                          ref=args.raider_file, col_name=args.column_name)
    main(
        args.raider_file, args.gnss_file,
        col_name=args.column_name,
        raider_delay=args.raider_column_name,
        out_path=args.out_name,
        local_time=args.local_time,
    )


if __name__ == '__main__':
    combineZTDFiles()
