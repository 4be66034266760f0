"""Run configs: raider_tpu_torch.workflows.{config,check_args} vs raider_tpu's (CPU).

``read_run_config_file`` and ``checkArgs`` of both packages agree field by
field and filename by filename on each example config and on the configs
of tests/test_check_args.py. The station template CSV (written with the
stdlib) is text-identical to the one pandas writes wherever pandas parses
correctly rounded, and otherwise within 1 ulp (pandas' default float
parser is now and then 1 ulp off Python's ``float()``).
"""

import datetime as dt
import os
import shutil

import numpy as np
import pandas as pd
import pytest
import yaml

from raider_tpu.workflows import check_args as j_check
from raider_tpu.workflows import config as j_config
from raider_tpu_torch.workflows import check_args as t_check
from raider_tpu_torch.workflows import config as t_config

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
T_EXAMPLES = os.path.join(REPO, 'raider_tpu_torch', 'cli', 'examples')
J_EXAMPLES = os.path.join(REPO, 'raider_tpu', 'cli', 'examples')


def _aoi_fields(aoi) -> dict:
    out = {'class': type(aoi).__name__, 'type': aoi.type(),
           'bounds': [float(v) for v in aoi.bounds()]}
    for k in ('_cube_spacing_m', '_filename', '_demfile', '_latfile', '_lonfile', '_hgtfile'):
        if hasattr(aoi, k):
            out[k] = getattr(aoi, k)
    return out


def _fields(rc) -> dict:
    """A RunConfig as plain values, for comparing the two packages'."""
    tg, hg, lg, rg = rc.time_group, rc.height_group, rc.los_group, rc.runtime_group
    return {
        'look_dir': rc.look_dir,
        'model': (type(rc.weather_model).__name__, rc.weather_model.Model(),
                  rc.weather_model._dataset),
        'dates': list(rc.date_group.date_list),
        'time': (tg.time, tg.end_time, tg.interpolate_time),
        'aoi': _aoi_fields(rc.aoi_group.aoi),
        'height': (hg.dem, hg.use_dem_latlon, hg.height_file_rdr,
                   None if hg.height_levels is None else [float(h) for h in hg.height_levels]),
        'los': (type(lg.los).__name__, lg.ray_trace, lg.los_file, lg.los_convention,
                lg.los_cube, lg.orbit_file, lg.zref),
        'runtime': (rg.raster_format, rg.file_format, rg.verbose, rg.output_projection,
                    rg.cube_spacing_in_m, rg.download_only, str(rg.output_directory),
                    str(rg.weather_model_directory), rg.nproc),
        'files': (rc.wetFilenames, rc.hydroFilenames),
    }


def _assert_same(j: dict, t: dict) -> None:
    """Equal, the AOI bounds to 1 ulp (a station file's come from pandas'
    parser in the JAX package)."""
    jb, tb = j['aoi'].pop('bounds'), t['aoi'].pop('bounds')
    np.testing.assert_array_max_ulp(np.array(tb), np.array(jb), maxulp=1)
    assert t == j


def _both(cfg_path, check=True):
    out = []
    for cfgmod, chk in ((j_config, j_check), (t_config, t_check)):
        rc = cfgmod.read_run_config_file(cfg_path)
        if check:
            rc = chk.checkArgs(rc)
        out.append(_fields(rc))
    return out


def test_examples_are_the_jax_packages():
    for name in ('template', 'example_LA_bbox', 'example_LA_GNSS', 'example_UK_isce'):
        for f in os.listdir(os.path.join(J_EXAMPLES, name)):
            with open(os.path.join(J_EXAMPLES, name, f), 'rb') as a, \
                    open(os.path.join(T_EXAMPLES, name, f), 'rb') as b:
                assert a.read() == b.read(), (name, f)


@pytest.mark.parametrize('name', ['example_LA_bbox', 'example_LA_GNSS'])
def test_example_configs_agree(tmp_path, monkeypatch, name):
    for f in os.listdir(os.path.join(T_EXAMPLES, name)):
        shutil.copy(os.path.join(T_EXAMPLES, name, f), tmp_path)
    monkeypatch.chdir(tmp_path)
    _assert_same(*_both(tmp_path / f'{name}.yaml'))


@pytest.mark.parametrize('name', ['template', 'example_UK_isce'])
def test_example_configs_that_need_more_fail_alike(tmp_path, monkeypatch, name):
    """The template has no weather model; the UK example's rasters are not
    there: both packages raise the same exception type."""
    shutil.copy(os.path.join(T_EXAMPLES, name, f'{name}.yaml'), tmp_path)
    monkeypatch.chdir(tmp_path)
    errors = []
    for cfgmod in (j_config, t_config):
        with pytest.raises(Exception) as exc:
            cfgmod.read_run_config_file(tmp_path / f'{name}.yaml')
        errors.append(type(exc.value).__name__)
    assert errors[0] == errors[1]


BASE = {'look_dir': 'right', 'date_group': {'date_start': 20180101},
        'time_group': {'time': '00:00:00'}, 'aoi_group': {'bounding_box': [36, 37, -92, -91]},
        'height_group': {}, 'los_group': {}, 'runtime_group': {}, 'weather_model': 'ERA5'}

# the configs of tests/test_check_args.py, and a few more groups
OVERRIDES = [
    {},
    {'runtime_group': {'file_format': 'h5'}, 'height_group': {'height_levels': [10, 100, 1000]}},
    {'runtime_group': {'file_format': 'GTiff'},
     'height_group': {'height_levels': [10, 100, 1000]}},
    {'runtime_group': {'output_directory': '{tmp}'}},
    {'runtime_group': {'output_directory': '{tmp}', 'weather_model_directory': 'weather_dir'}},
    {'height_group': {'height_levels': [0, 100]}},
    {'height_group': {'height_levels': '0 50 -100 1000'}},
    {'date_group': {'date_start': 20200101, 'date_end': 20200110, 'date_step': 3}},
    {'date_group': {'date_list': [20200103, 20200205]}},
    {'date_group': {'date_list': '20200103 20200205'}, 'weather_model': 'HRRR',
     'aoi_group': {'bounding_box': '36 37 -92 -91'}},
    {'time_group': {'time': 'T13:52:45', 'end_time': '13:53:10',
                    'interpolate_time': 'center_time'}},
    {'look_dir': 'LEFT', 'runtime_group': {'output_projection': 'EPSG:32615',
                                           'cube_spacing_in_m': 500.0, 'verbose': False,
                                           'raster_format': 'GTiff'}},
    {'cube_spacing_in_m': 1000, 'los_group': {'zref': 20000.0}},
]


@pytest.mark.parametrize('overrides', OVERRIDES)
def test_check_args_configs_agree(tmp_path, monkeypatch, overrides):
    monkeypatch.chdir(tmp_path)
    cfg = {k: (dict(v) if isinstance(v, dict) else v) for k, v in BASE.items()}
    for k, v in overrides.items():
        v = {kk: (vv.format(tmp=tmp_path) if isinstance(vv, str) else vv)
             for kk, vv in v.items()} if isinstance(v, dict) else v
        cfg[k] = {**cfg.get(k, {}), **v} if isinstance(v, dict) else v
    path = tmp_path / 'cfg.yaml'
    path.write_text(yaml.dump(cfg))
    _assert_same(*_both(path))


def test_bad_configs_fail_alike(tmp_path, monkeypatch):
    monkeypatch.chdir(tmp_path)
    for bad in ({'look_dir': 'up'}, {'aoi_group': {'bounding_box': [37, 36, -92, -91]}},
                {'date_group': {}}, {'time_group': {}}, {'weather_model': 'notamodel'},
                {'time_group': {'time': '10:00:00', 'end_time': '09:00:00'}},
                # an unquoted 13:52:45 is the base-60 int 49965, no time
                {'time_group': {'time': 49965}}):
        cfg = {**BASE, **bad}
        path = tmp_path / 'cfg.yaml'
        path.write_text(yaml.dump(cfg))
        errors = []
        for cfgmod in (j_config, t_config):
            with pytest.raises(Exception) as exc:
                cfgmod.read_run_config_file(path)
            errors.append(type(exc.value).__name__)
        assert errors[0] == errors[1], bad
    path.write_text('a: &x 1\nb: *x\n')
    with pytest.raises(ValueError, match='Something is wrong with the yaml file'):
        t_config.read_run_config_file(path)


def _ulp_equal(a: str, b: str) -> bool:
    if a == b:
        return True
    try:
        x, y = float(a), float(b)
    except ValueError:
        return False
    return y in (np.nextafter(x, np.inf), np.nextafter(x, -np.inf))


def _assert_csv_close(path_ours, path_pandas):
    with open(path_ours) as f:
        ours = f.read().splitlines()
    with open(path_pandas) as f:
        theirs = f.read().splitlines()
    assert len(ours) == len(theirs)
    for a, b in zip(ours, theirs):
        fa, fb = a.split(','), b.split(',')
        assert len(fa) == len(fb) and all(_ulp_equal(x, y) for x, y in zip(fa, fb)), (a, b)


STATIONS = '''ID,Lat,Lon,Hgt_m,Count,Gaps,Note
7ODM,34.116406899999994,-117.093191981,762.0717087,3,1,a
0123,33.849159884,-117.86247482200001,38.2203257,4,,
AVRY,34.468300825,-117.15396939799999,888.9170136,5,2,b c
7ODM,34.116406899999994,-117.093191981,1.0,6,3,dup
X1,,-117.5,10,7,4,NA
X2,,-117.5,11,8,5,nan lat again
Y,33.5,-117.25,nan,9,6,
'''


def test_station_table_matches_pandas(tmp_path):
    """``write_station_table`` vs read_csv -> drop_duplicates -> to_csv:
    duplicate pairs (NaN equal to NaN) dropped, IDs kept, an int column with
    a blank turned float, NaN written empty, and appended float32 and
    float64 delay columns."""
    src = tmp_path / 'st.csv'
    src.write_text(STATIONS)
    df = pd.read_csv(src).drop_duplicates(subset=['Lat', 'Lon'])
    df.to_csv(tmp_path / 'pd.csv', index=False)
    t_check.write_station_table(src, tmp_path / 'ours.csv')
    _assert_csv_close(tmp_path / 'ours.csv', tmp_path / 'pd.csv')
    rng = np.random.default_rng(0)
    wet = rng.uniform(0.0, 0.3, len(df)).astype(np.float32)
    hydro = rng.uniform(2.0, 2.4, len(df))
    hydro[1] = np.nan
    df['wetDelay'], df['hydroDelay'], df['totalDelay'] = wet, hydro, wet + hydro
    df.to_csv(tmp_path / 'pd2.csv', index=False)
    t_check.write_station_table(src, tmp_path / 'ours2.csv',
                                extra={'wetDelay': wet, 'hydroDelay': hydro,
                                       'totalDelay': wet + hydro})
    _assert_csv_close(tmp_path / 'ours2.csv', tmp_path / 'pd2.csv')


def test_station_template_csv_matches_the_jax_package(tmp_path, monkeypatch):
    """checkArgs' template CSV of the LA GNSS example, both packages."""
    monkeypatch.chdir(tmp_path)
    for f in os.listdir(os.path.join(T_EXAMPLES, 'example_LA_GNSS')):
        shutil.copy(os.path.join(T_EXAMPLES, 'example_LA_GNSS', f), tmp_path)
    out = {}
    for tag, cfgmod, chk in (('j', j_config, j_check), ('t', t_config, t_check)):
        os.makedirs(tmp_path / tag)
        cfg = yaml.safe_load((tmp_path / 'example_LA_GNSS.yaml').read_text())
        cfg['runtime_group']['output_directory'] = str(tmp_path / tag)
        (tmp_path / f'{tag}.yaml').write_text(yaml.dump(cfg))
        rc = chk.checkArgs(cfgmod.read_run_config_file(tmp_path / f'{tag}.yaml'))
        out[tag] = rc.wetFilenames[0]
    assert os.path.basename(out['t']) == os.path.basename(out['j']) == \
        'ERA5_Delay_20200130T135245_ztd.csv'
    _assert_csv_close(out['t'], out['j'])


def test_station_file_heights_decide_the_dem(tmp_path):
    """get_heights: a station file without Hgt_m needs the GLO30 DEM; the
    header is read by the stdlib, as pandas reads it."""
    for header, rows in (('ID,Lat,Lon,Hgt_m', 'A,34.0,-117.0,10.0'),
                         ('ID,Lat,Lon', 'A,34.0,-117.0')):
        path = tmp_path / 'st.csv'
        path.write_text(f'{header}\n{rows}\n')
        got = []
        for cfgmod in (j_config, t_config):
            rg = cfgmod.RuntimeGroup(output_directory=str(tmp_path))
            hg = cfgmod.get_heights(cfgmod.HeightGroupUnparsed(dem='x.dem'),
                                    cfgmod.AOIGroupUnparsed(station_file=str(path)), rg)
            got.append(hg.dem)
        assert got[0] == got[1]
    assert got[1].endswith('GLO30.dem')


def test_time_and_date_coercion_agree():
    for s in ('T23:00:01.000000', '230001', 'T2300', '23:00', '13:52:45Z', '13:52:45+0000'):
        assert t_config.TimeGroup.coerce_into_time(s) == j_config.TimeGroup.coerce_into_time(s)
    for d in ('2020-10-1', '2020101', 20200130, dt.date(2020, 1, 30)):
        assert t_config.coerce_into_date(d) == j_config.coerce_into_date(d)
