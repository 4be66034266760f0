"""Model/GNSS delay combination: raider_tpu_torch.workflows.gnss_combine vs raider_tpu's (CPU).

Both packages run on copies of the same model delay CSVs (as calcDelays
writes them for a station file, several epochs a day) and the same GNSS
delay CSV (``get_station_data`` on synthetic UNR archives); the port runs
with pandas blocked. Each written CSV is held to the JAX package's text
(tests/test_torch_gnss.py's rule), and ``main``'s table column by column
to the JAX DataFrame: the same columns in order, datetimes equal, floats
equal (the merge copies values; ``ZTD_minus_RAiDER`` is one float64
subtraction in both) except where pandas' parser misrounds the text both
read.
"""

import csv
import datetime as dt
import os
import shutil

import numpy as np
import pytest

from raider_tpu.workflows import gnss_combine as j_gc
from raider_tpu_torch.scripts import gnss_inputs
from raider_tpu_torch.utils import table
from raider_tpu_torch.workflows import gnss as t_gnss
from raider_tpu_torch.workflows import gnss_combine as t_gc

from tests.test_torch_gnss import assert_csv_same, blocked, pandas_reads

DATES = (dt.date(2021, 6, 30), dt.date(2021, 7, 1))
HOURS = (12, 15, 18, 21)
N_STATIONS = 6
RESIDUAL = {'ZTD_minus_RAiDER': ('ZTD', 'totalDelay')}


@pytest.fixture(scope='module')
def inputs(tmp_path_factory):
    """The model delay CSVs (one per date and hour) in ``model/``, and the
    GNSS delay CSV of every epoch of both dates."""
    d = tmp_path_factory.mktemp('gnss_combine')
    rng = np.random.default_rng(11)
    lat, lon = rng.uniform(36.2, 38.8, N_STATIONS), rng.uniform(-99.8, -97.7, N_STATIONS)
    hgt = rng.uniform(200.0, 900.0, N_STATIONS)
    ids = [f'S{i:05d}' for i in range(N_STATIONS)]
    os.makedirs(d / 'model')
    for day in DATES:
        for h in HOURS:
            wet = rng.uniform(0.05, 0.25, N_STATIONS)
            hydro = rng.uniform(2.1, 2.3, N_STATIONS)
            with open(d / 'model' / f'HRRR_Delay_{day:%Y%m%d}T{h:02d}0000_ztd.csv', 'w',
                      newline='') as f:
                w = csv.writer(f, lineterminator='\n')
                w.writerow(['ID', 'Lat', 'Lon', 'Hgt_m', 'wetDelay', 'hydroDelay', 'totalDelay'])
                for row in zip(ids, lat, lon, hgt, wet, hydro, wet + hydro):
                    w.writerow([row[0]] + [repr(float(v)) for v in row[1:]])
    paths = d / 'paths.csv'
    with open(paths, 'w', newline='') as f:
        w = csv.writer(f, lineterminator='\n')
        w.writerow(['ID', 'path', 'Lat', 'Lon', 'Hgt_m'])
        for i, sid in enumerate(ids):
            z = d / f'{sid}.2021.trop.zip'
            gnss_inputs.write_trop_zip(z, sid, 2021, (181, 182), seed=i, n_gaps=5)
            w.writerow([sid, str(z), repr(float(lat[i])), repr(float(lon[i])),
                        repr(float(hgt[i]))])
    os.makedirs(d / 'gnss')
    t_gnss.get_station_data(str(paths), [f'{day:%Y-%m-%d}' for day in DATES], gps_repo='UNR',
                            numCPUs=1, outDir=str(d / 'gnss'))
    return {'dir': d, 'gnss': d / 'gnss' / 'UNRcombinedGPS_ztd.csv'}


def _copies(tmp_path, inputs):
    """The model directory, once for each package."""
    out = {}
    for tag in ('jax', 'port'):
        out[tag] = tmp_path / tag
        shutil.copytree(inputs['dir'] / 'model', out[tag] / 'model')
    return out


def assert_frame_same(t, df):
    """``main``'s table against the JAX DataFrame, column by column."""
    assert list(t) == list(df.columns)
    assert table.n_rows(t) == len(df) > 0
    for k, col in t.items():
        want = df[k].to_numpy()
        if k == 'ZTD_minus_RAiDER':
            # derived: equal where both inputs are, each package's own
            # float64 subtraction everywhere
            np.testing.assert_array_equal(want, df['ZTD'].to_numpy() - df['totalDelay'].to_numpy())
            np.testing.assert_array_equal(col, t['ZTD'] - t['totalDelay'])
            same_in = ((t['ZTD'] == df['ZTD'].to_numpy())
                       & (t['totalDelay'] == df['totalDelay'].to_numpy()))
            np.testing.assert_array_equal(col[same_in], want[same_in])
        elif col.dtype.kind == 'M':
            np.testing.assert_array_equal(col, want.astype('datetime64[ns]'))
        elif col.dtype.kind == 'f':
            want = want.astype(np.float64)
            same = (col == want) | (np.isnan(col) & np.isnan(want))
            if not same.all():
                # a value pandas read 1-3 times from the text both read
                texts = [repr(float(v)) for v in col[~same]]
                assert np.any([r == want[~same] for r in pandas_reads(texts)], axis=0).all(), k
        else:
            assert [str(v) for v in col] == [str(v) for v in want], k


def test_get_datetime():
    for name in ('HRRR_Delay_20210630T120000_ztd.csv', '/a/b/ERA5_x_20200101T000001.csv'):
        assert t_gc.getDateTime(name) == j_gc.getDateTime(name)


def test_add_datetime_to_files(tmp_path, inputs, capsys):
    dirs = _copies(tmp_path, inputs)
    for tag in dirs:
        shutil.copy(dirs[tag] / 'model' / 'HRRR_Delay_20210630T120000_ztd.csv',
                    dirs[tag] / 'model' / 'no_time_in_name.csv')
    for tag, mod in (('jax', j_gc), ('port', t_gc)):
        files = sorted((dirs[tag] / 'model').glob('*.csv'))
        with blocked(*(('pandas',) if tag == 'port' else ())):
            mod.addDateTimeToFiles(files)
            mod.addDateTimeToFiles(files[:1])               # has Datetime: skipped
            mod.addDateTimeToFiles(files[:1], force=True)
    out = capsys.readouterr().out
    assert out.count('does not contain datetime info, skipping') == 2
    for f in sorted(os.listdir(dirs['jax'] / 'model')):
        assert_csv_same(dirs['port'] / 'model' / f, dirs['jax'] / 'model' / f)


@pytest.mark.parametrize('n_files', [1, 8])
def test_combine_delay_files_model(tmp_path, inputs, n_files):
    dirs = _copies(tmp_path, inputs)
    for tag in dirs:
        for f in sorted(os.listdir(dirs[tag] / 'model'))[n_files:]:
            os.remove(dirs[tag] / 'model' / f)
    for tag, mod in (('jax', j_gc), ('port', t_gc)):
        with blocked(*(('pandas',) if tag == 'port' else ())):
            mod.combineDelayFiles(dirs[tag] / 'combined.csv', loc=dirs[tag] / 'model')
    assert_csv_same(dirs['port'] / 'combined.csv', dirs['jax'] / 'combined.csv')
    assert table.n_rows(table.read_csv(dirs['port'] / 'combined.csv')) == n_files * N_STATIONS


@pytest.mark.parametrize('n_files', [1, 2])
def test_combine_delay_files_gnss(tmp_path, inputs, n_files):
    """GNSS CSVs through ``readZTDFile`` (its Datetime from Date + times),
    one file copied through, or two concatenated and sorted by ID and
    Datetime."""
    src = table.read_csv(inputs['gnss'])
    for tag in ('jax', 'port'):
        os.makedirs(tmp_path / tag / 'gnss')
        for k in range(n_files):
            rows = np.arange(table.n_rows(src)) % n_files == k
            table.to_csv(table.take(src, rows), tmp_path / tag / 'gnss' / f'part{k}.csv')
    for tag, mod in (('jax', j_gc), ('port', t_gc)):
        with blocked(*(('pandas',) if tag == 'port' else ())):
            mod.combineDelayFiles(tmp_path / tag / 'combined.csv', loc=tmp_path / tag / 'gnss',
                                  source='GNSS')
    assert_csv_same(tmp_path / 'port' / 'combined.csv', tmp_path / 'jax' / 'combined.csv')


@pytest.mark.parametrize('local_time', [None, '23 3', '20 2'])
def test_main(tmp_path, inputs, local_time):
    """The merge, with and without the local-time filter: the table column
    by column against the JAX DataFrame, and the written CSV's text."""
    dirs = _copies(tmp_path, inputs)
    for tag, mod in (('jax', j_gc), ('port', t_gc)):
        mod.combineDelayFiles(dirs[tag] / 'combined.csv', loc=dirs[tag] / 'model')
    got = {}
    for tag, mod in (('jax', j_gc), ('port', t_gc)):
        with blocked(*(('pandas',) if tag == 'port' else ())):
            got[tag] = mod.main(dirs[tag] / 'combined.csv', inputs['gnss'], local_time=local_time)
            mod.main(dirs[tag] / 'combined.csv', inputs['gnss'], local_time=local_time,
                     out_path=dirs[tag] / 'merged.csv')
    assert_frame_same(got['port'], got['jax'])
    assert_csv_same(dirs['port'] / 'merged.csv', dirs['jax'] / 'merged.csv', derived=RESIDUAL)
    t = got['port']
    if local_time is None:
        assert table.n_rows(t) == len(DATES) * len(HOURS) * N_STATIONS


def test_combine_ztd_files_cli(tmp_path, inputs):
    """``combineZTDFiles``: the model directory combined, the GNSS one
    combined against it, then merged with the local-time filter."""
    dirs = _copies(tmp_path, inputs)
    for tag in dirs:
        os.makedirs(dirs[tag] / 'gnss')
        shutil.copy(inputs['gnss'], dirs[tag] / 'gnss' / 'UNR_ztd.csv')
    for tag, mod in (('jax', j_gc), ('port', t_gc)):
        d = dirs[tag]
        with blocked(*(('pandas',) if tag == 'port' else ())):
            mod.combineZTDFiles(['--raider', str(d / 'raider.csv'), '--raiderDir', str(d / 'model'),
                                 '--gnss', str(d / 'gnss.csv'), '--gnssDir', str(d / 'gnss'),
                                 '--out', str(d / 'out.csv'), '--localtime', '23 3'])
    for name in ('raider.csv', 'gnss.csv', 'out.csv'):
        assert_csv_same(dirs['port'] / name, dirs['jax'] / name,
                        derived=RESIDUAL if name == 'out.csv' else None)
    with pytest.raises(SystemExit):
        t_gc.create_parser().parse_args(['--raider', 'x.txt'])
