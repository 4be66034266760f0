"""GNSS download and parsing: raider_tpu_torch.workflows.gnss vs raider_tpu's (CPU).

Both packages parse the same synthetic UNR archives
(``raider_tpu_torch.scripts.gnss_inputs``: gzipped daily SINEX-trop files
with seeded gaps) and station lists; the port runs with pandas blocked
(``sys.modules['pandas'] = None``). Every CSV the port writes is
text-identical to the JAX package's wherever pandas parses floats
correctly rounded, and otherwise within 1 ulp (pandas' default float
parser is not correctly rounded). Where the texts differ, the JAX
package's value is what pandas' parser makes of the port's text, after
at most as many reads by pandas as the JAX path makes of that value (up
to three): pandas' default parser was measured up to 14 ulp off Python's
``float()`` on 17-digit values of 0.05-0.25 m (1 ulp at 0.5-2400), so a
fixed ulp bound would not hold.
"""

import contextlib
import csv
import datetime as dt
import io
import os
import shutil
import sys

import numpy as np
import pytest

from raider_tpu.workflows import gnss as j_gnss
from raider_tpu_torch.scripts import gnss_inputs, point_inputs
from raider_tpu_torch.utils import table
from raider_tpu_torch.workflows import gnss as t_gnss

YEAR = 2021
DOYS = (181, 182, 183)                      # 2021-06-30 .. 2021-07-02
DATES = ['2021-06-30', '2021-07-02']


@contextlib.contextmanager
def blocked(*modules):
    """Imports of ``modules`` raise inside the block (the card's machine
    has neither pandas nor h5py)."""
    saved = {m: sys.modules.get(m) for m in modules}
    for m in modules:
        sys.modules[m] = None
    try:
        yield
    finally:
        for m, mod in saved.items():
            if mod is None:
                sys.modules.pop(m, None)
            else:
                sys.modules[m] = mod


def pandas_reads(texts, times: int = 3) -> list:
    """What pandas' default parser makes of each float text after 1, 2, ...
    ``times`` reads (each read's value written back by its repr)."""
    import pandas as pd

    out = []
    for _ in range(times):
        col = pd.read_csv(io.StringIO('x\n' + '\n'.join(texts) + '\n'))['x'].to_numpy()
        out.append(col.astype(np.float64))
        texts = [repr(float(v)) for v in col]
    return out


def assert_csv_same(got, want, dirs=None, derived=None):
    """Equal text (with ``dirs`` = (port's, JAX's) output directory, the
    port's paths read as the JAX package's); where a field differs, the
    JAX package's value is pandas' parse of the port's text (after one to
    three reads). A ``derived`` column (name -> (a, b): the float64 a - b)
    is each file's own a - b, and equal text where a and b are."""
    with open(got, newline='') as f:
        text = f.read()
    if dirs:
        text = text.replace(str(dirs[0]), str(dirs[1]))
    g = list(csv.reader(io.StringIO(text)))
    with open(want, newline='') as f:
        w = list(csv.reader(f))
    assert g[0] == w[0] and len(g) == len(w), (got, g[:2], w[:2])
    skip = set()
    for name, (x, y) in (derived or {}).items():
        i, ia, ib = (g[0].index(n) for n in (name, x, y))
        skip.add(i)
        for rows in (g, w):
            for r in rows[1:]:
                assert float(r[i]) == float(r[ia]) - float(r[ib]), (name, r)
        for a, b in zip(g[1:], w[1:]):
            if a[ia] == b[ia] and a[ib] == b[ib]:
                assert a[i] == b[i], (name, a, b)
    differ = []
    for a, b in zip(g[1:], w[1:]):
        assert len(a) == len(b)
        differ += [(x, y) for k, (x, y) in enumerate(zip(a, b)) if x != y and k not in skip]
    if differ:
        reads = pandas_reads([x for x, _ in differ])
        want_vals = np.array([float(y) for _, y in differ])
        assert np.any([r == want_vals for r in reads], axis=0).all(), (got, differ[:5])


def assert_table_same(t, df):
    """A column table against a DataFrame: the same columns in order,
    floats within 1 ulp (pandas' parser), everything else equal."""
    assert list(t) == list(df.columns)
    for k, col in t.items():
        want = df[k].to_numpy()
        if col.dtype.kind == 'f':
            assert np.array_equal(np.isnan(col), np.isnan(want.astype(np.float64)))
            ok = ~np.isnan(col)
            np.testing.assert_array_max_ulp(col[ok], want.astype(np.float64)[ok], maxulp=1)
        elif col.dtype.kind == 'M':
            np.testing.assert_array_equal(col, want.astype('datetime64[ns]'))
        else:
            assert [str(v) for v in col] == [str(v) for v in want], k


@pytest.fixture(scope='module')
def archives(tmp_path_factory):
    """Five stations' archives (three days each, seeded gaps; one station
    without gaps) and their station CSV."""
    d = tmp_path_factory.mktemp('gnss_archives')
    rng = np.random.default_rng(7)
    lat, lon = rng.uniform(36.2, 38.8, 5), rng.uniform(-99.8, -97.7, 5)
    stations = point_inputs.write_station_csv(d / 'stations.csv', lat, lon,
                                              rng.uniform(200.0, 900.0, 5))
    ids = [f'S{i:05d}' for i in range(5)]
    paths = {}
    for i, sid in enumerate(ids):
        paths[sid] = str(d / f'{sid}.{YEAR}.trop.zip')
        gnss_inputs.write_trop_zip(paths[sid], sid, YEAR, DOYS, seed=i, n_gaps=0 if i == 0 else 4)
    return {'dir': d, 'stations': stations, 'ids': ids, 'paths': paths}


@pytest.mark.parametrize('return_time', [None, 0, 43200, 43350, 86100])
def test_get_delays_unr(tmp_path, archives, return_time):
    """Every epoch (None), on the grid, off it, at the day's ends; the gaps
    re-aligned to NaN, the nearest epoch with data returned; the second
    call appends without a header."""
    out = {}
    for tag, mod in (('jax', j_gnss), ('port', t_gnss)):
        out[tag] = tmp_path / f'{tag}.csv'
        with blocked(*(('pandas',) if tag == 'port' else ())):
            for sid in archives['ids'][:3]:
                mod.get_delays_UNR(archives['paths'][sid], out[tag], DATES, returnTime=return_time)
    assert_csv_same(out['port'], out['jax'])
    rows = table.read_csv(out['port'])
    n_days = len(DATES) * 3
    assert table.n_rows(rows) == n_days * (288 if return_time is None else 1)
    if return_time is not None:
        assert np.isfinite(rows['ZTD']).all()


def test_get_delays_unr_gap_picks_the_nearest_epoch_with_data(tmp_path):
    zpath = tmp_path / 'TORP.2020.trop.zip'
    text, *_ = gnss_inputs.trop_day('TORP', 2020, 30, np.random.default_rng(0))
    lines = [ln for ln in text.splitlines(True) if ':00300 ' not in ln]   # drop the 300 s epoch
    import gzip
    import zipfile

    with zipfile.ZipFile(zpath, 'w') as z:
        z.writestr('TORP.2020.030.trop.gz', gzip.compress(''.join(lines).encode()))
    out = {}
    for tag, mod in (('jax', j_gnss), ('port', t_gnss)):
        out[tag] = tmp_path / f'{tag}.csv'
        with blocked(*(('pandas',) if tag == 'port' else ())):
            mod.get_delays_UNR(str(zpath), out[tag], ['2020-01-30'], returnTime=400)
    assert_csv_same(out['port'], out['jax'])
    assert list(table.read_csv(out['port'])['times']) == [600]


def test_seconds_of_day_and_get_date():
    for v in (None, '01:00:00', '23:59:59', dt.time(12, 30, 15)):
        assert t_gnss.seconds_of_day(v) == j_gnss.seconds_of_day(v)
    toks = 'S00001.2021.182.trop.gz'.split('.')
    assert t_gnss.get_date(toks) == j_gnss.get_date(toks)


def test_station_list_from_a_csv(tmp_path, archives):
    for write in (True, False):
        got = {}
        for tag, mod in (('jax', j_gnss), ('port', t_gnss)):
            os.makedirs(tmp_path / tag, exist_ok=True)
            with blocked(*(('pandas',) if tag == 'port' else ())):
                got[tag] = mod.get_station_list(stationFile=archives['stations'],
                                                writeLoc=str(tmp_path / tag), name_appendix='_x',
                                                writeStationFile=write)
        assert list(got['port'][0]) == list(got['jax'][0]) == archives['ids']
        if write:
            assert os.path.basename(got['port'][1]) == os.path.basename(got['jax'][1])
            assert_csv_same(got['port'][1], got['jax'][1])
        else:
            assert_table_same(got['port'][1], got['jax'][1])


def test_station_list_from_a_whitespace_file(tmp_path):
    """A file the CSV reader takes (one column named 'ID Lat Lon Hgt_m')
    has no ID column in either package; one it refuses (a row with more
    fields than the header) is read as whitespace columns, all text."""
    plain = tmp_path / 'plain.txt'
    plain.write_text('ID Lat Lon Hgt_m\nTORP 33.8 -118.3 10.0\nHOOT 33.1 -116.8 617.2\n')
    for mod in (j_gnss, t_gnss):
        with pytest.raises(KeyError):
            mod.get_station_list(stationFile=str(plain), writeStationFile=False)
    odd = tmp_path / 'odd.txt'
    odd.write_text('ID Lat Lon Hgt_m\nTORP 33.8 -118.3 10.0\nHO,OT 33.1 -116.8 617.2\n'
                   'SLAC 37.4 -122.2\n')
    got = {}
    for tag, mod in (('jax', j_gnss), ('port', t_gnss)):
        os.makedirs(tmp_path / tag)
        with blocked(*(('pandas',) if tag == 'port' else ())):
            got[tag] = mod.get_station_list(stationFile=str(odd), writeLoc=str(tmp_path / tag))
    assert got['port'][0] == got['jax'][0] == ['TORP', 'HO,OT', 'SLAC']
    assert_csv_same(got['port'][1], got['jax'][1])


@pytest.mark.parametrize('bbox', ['36 39 -100 -97.5', '36 39 260 262.5', '-10 10 -5 5',
                                  '-10 10 355 5', '36 39 262.5 260', [36, 39, -100.0, -97.5]])
def test_parse_bbox_and_filter(tmp_path, bbox):
    """``_parse_gnss_bbox`` and ``filterToBBox`` on stations at [-180, 180)
    and [0, 360) longitudes, boxes across 0 and 360 degrees."""
    assert t_gnss._parse_gnss_bbox(bbox) == j_gnss._parse_gnss_bbox(
        list(bbox) if isinstance(bbox, list) else bbox)
    import pandas as pd

    rng = np.random.default_rng(3)
    lat = np.round(rng.uniform(-20, 45, 200), 3)
    lon = np.round(rng.uniform(-180, 180, 200), 3)
    lon[:20] = np.round(rng.uniform(-6, 6, 20), 3)
    box, cross = t_gnss._parse_gnss_bbox(bbox)
    for lons in (lon, np.mod(lon, 360)):
        for keys in (('Lat', 'Lon'), ('latitude', 'longitude')):
            t = {'ID': np.array([f'X{i}' for i in range(200)], dtype=object),
                 keys[0]: lat, keys[1]: lons}
            boxes = [box] if not cross else [[*box[:3], 360.0], [*box[:2], 0.0, box[3]]]
            for b in boxes:
                got = t_gnss.filterToBBox(t, b)
                want = j_gnss.filterToBBox(pd.DataFrame(t), b)
                assert list(got['ID']) == list(want['ID'])
    with pytest.raises(KeyError):
        t_gnss.filterToBBox({'ID': np.array(['a'], dtype=object), 'y': lat[:1]}, [0, 1, 2, 3])


def test_stats_by_llh_from_a_local_holdings_file(tmp_path):
    rng = np.random.default_rng(5)
    lines = [f'X{i:03d} {a:.6f} {b:.6f} {h:.3f}\n' for i, (a, b, h) in enumerate(zip(
        rng.uniform(30, 45, 60), rng.uniform(-130, 230, 60), rng.uniform(-50, 3000, 60)))]
    os.makedirs(tmp_path / 'NGLStationPages')
    (tmp_path / 'NGLStationPages' / 'llh.out').write_text(''.join(lines))
    base = str(tmp_path) + os.sep
    for box in ([30, 45, 200, 300], [30, 45, 0, 360]):
        got = t_gnss.get_stats_by_llh(box, baseURL=base)
        want = j_gnss.get_stats_by_llh(box, baseURL=base)
        assert list(got['ID']) == list(want['ID'])
        np.testing.assert_array_equal(got['Lon'], want['Lon'].to_numpy())
        # the box [0, 360] maps to (0, 0) on [-180, 180): empty in both
        assert table.n_rows(got) == (18 if box[2] else 0)


def _paths_csv(path, archives, ids):
    with open(path, 'w', newline='') as f:
        w = csv.writer(f)
        w.writerow(['ID', 'year', 'path', 'Lat', 'Lon', 'Hgt_m'])
        st = table.read_csv(archives['stations'])
        for sid in ids:
            i = list(st['ID']).index(sid)
            w.writerow([sid, YEAR, archives['paths'][sid],
                        *(repr(float(st[k][i])) for k in ('Lat', 'Lon', 'Hgt_m'))])
    return str(path)


@pytest.mark.parametrize('return_time', [None, '12:00:00'])
def test_get_station_data(tmp_path, archives, return_time):
    paths = _paths_csv(tmp_path / 'paths.csv', archives, archives['ids'])
    for tag, mod in (('jax', j_gnss), ('port', t_gnss)):
        os.makedirs(tmp_path / tag)
        with blocked(*(('pandas',) if tag == 'port' else ())):
            mod.get_station_data(paths, DATES, gps_repo='UNR', numCPUs=2,
                                 outDir=str(tmp_path / tag), returnTime=return_time)
    for name in ['UNRcombinedGPS_ztd.csv'] + [f'GPS_delays/{s}_ztd.csv' for s in archives['ids']]:
        assert_csv_same(tmp_path / 'port' / name, tmp_path / 'jax' / name)
    got = table.read_csv(tmp_path / 'port' / 'UNRcombinedGPS_ztd.csv')
    per_day = 1 if return_time else 288
    assert table.n_rows(got) <= len(archives['ids']) * len(DATES) * per_day
    assert not any(table.isnull(c).any() for c in got.values())


@pytest.mark.parametrize('argv', [
    ['--bbox', '36 39 -100 -97.5', '--returntime', '12:00:00'],
    ['--bbox', '36 39 -100 -97.5'],
    ['--bbox', '-10 10 -5 5', '--returntime', '00:00:00'],
])
def test_download_gnss(tmp_path, archives, monkeypatch, argv):
    """``downloadGNSS`` with ``download_UNR`` replaced in both packages by a
    copy of the local archive: every CSV it writes agrees."""
    def fake_download(statID, year, writeDir='.', download=False, baseURL=None):
        src = archives['paths'].get(statID)
        if src is None:
            return {'ID': statID, 'year': year, 'path': ''}
        dst = os.path.abspath(os.path.join(writeDir, f'{statID.upper()}.{year}.trop.zip'))
        shutil.copy(src, dst)
        return {'ID': statID, 'year': year, 'path': dst}

    for mod in (j_gnss, t_gnss):
        monkeypatch.setattr(mod, 'download_UNR', fake_download)
    common = ['--station_file', archives['stations'], '--date', '20210630', '20210702', '2',
              '--download', '--cpus', '2', *argv]
    for tag, mod in (('jax', j_gnss), ('port', t_gnss)):
        with blocked(*(('pandas',) if tag == 'port' else ())):
            mod.downloadGNSS(['--out', str(tmp_path / tag), *common])
    names = sorted(f for f in os.listdir(tmp_path / 'jax') if f.endswith('.csv'))
    assert names == sorted(f for f in os.listdir(tmp_path / 'port') if f.endswith('.csv'))
    assert 'UNRcombinedGPS_ztd.csv' in names
    for name in names + [f'GPS_delays/{s}_ztd.csv' for s in archives['ids']]:
        assert_csv_same(tmp_path / 'port' / name, tmp_path / 'jax' / name,
                        dirs=(tmp_path / 'port', tmp_path / 'jax'))
