"""The port's run-config YAML (``workflows/yaml_subset.py``) vs PyYAML (CPU).

``safe_load`` must return exactly what ``yaml.safe_load`` returns on every
input it accepts (the example configs of both packages, ``yaml.dump`` of
drawn config dicts, each YAML 1.1 quirk PyYAML resolves) and raise
ValueError naming the line on every construct outside its subset. ``dump``
must write what ``yaml.safe_load`` reads back equal.
"""

import datetime as dt
import glob
import math
import os

import pytest
import yaml
from hypothesis import given, settings
from hypothesis import strategies as st

from raider_tpu_torch.workflows import yaml_subset

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
EXAMPLES = sorted(glob.glob(os.path.join(REPO, 'raider_tpu', 'cli', 'examples', '*', '*.yaml'))
                  + glob.glob(os.path.join(REPO, 'raider_tpu_torch', 'cli', 'examples', '*',
                                           '*.yaml')))


def same(a, b) -> bool:
    """Equal, NaN equal to NaN, and of the same types all the way down."""
    if type(a) is not type(b):
        return False
    if isinstance(a, float):
        return (math.isnan(a) and math.isnan(b)) or a == b
    if isinstance(a, dict):
        return list(a) == list(b) and all(same(a[k], b[k]) for k in a)
    if isinstance(a, list):
        return len(a) == len(b) and all(same(x, y) for x, y in zip(a, b))
    return a == b


def test_examples_of_both_packages():
    assert len(EXAMPLES) == 8
    for path in EXAMPLES:
        with open(path) as f:
            text = f.read()
        assert same(yaml_subset.safe_load(text), yaml.safe_load(text)), path


QUIRKS = [
    ('t: 13:52:45', {'t': 49965}),                      # base 60
    ('t: 190:20:30.15', {'t': 685230.15}),
    ('d: 2020-01-30', {'d': dt.date(2020, 1, 30)}),
    ('d: 2001-12-14t21:59:43.10-05:00', None),
    ('d: 2001-12-14 21:59:43.10', None),
    ('d: 2001-12-14 21:59:43Z', None),
    ('b: [yes, no, on, off, Yes, NO, On, OFF, true, False, TRUE]', None),
    ('x: 1e3', {'x': '1e3'}),
    ('x: 1.0e+3', {'x': 1000.0}),
    ('x: 1.0e3', {'x': '1.0e3'}),
    ('x: .5', {'x': 0.5}),
    ('x: -.5', {'x': '-.5'}),
    ('x: [.inf, -.inf, .NaN, 1_000, 1., +12, -0]', None),
    ('o: 017', {'o': 15}),
    ('o: 08', {'o': '08'}),
    ('o: 0o17', {'o': '0o17'}),
    ('h: 0x1F', {'h': 31}),
    ('b: 0b101', {'b': 5}),
    ('n: ~', {'n': None}),
    ('n:', {'n': None}),
    ('n: [null, Null, NULL, nULL]', None),
    ('f: {}', {'f': {}}),
    ('f: []', {'f': []}),
    ('g: [a, b]', {'g': ['a', 'b']}),
    ('g: {a: 1, b: [x, 2.5], c}', None),
    ('g: [1, 2, ]', None),
    ('l:\n- a\n- b', {'l': ['a', 'b']}),
    ('l:\n  - a\n  -\n  - [2, 3]', None),
    ('- - 1\n  - 2\n- a: 1\n  b: 2', None),
    ('# a comment\nk: v  # another\n\nk2: a#b', {'k': 'v', 'k2': 'a#b'}),
    ("q: 'it''s # not a comment'", None),
    ('q: "a\\tb\\u00e9\\x41 \\"\\\\ \\/"', None),
    ('q: "\\N\\_\\L\\P\\0\\e"', None),
    ('EPSG: EPSG:4326', None),
    ('bbox: 33 34 -118.25 -116.75', None),
    ('null: 1\n1: 2\nyes: no\n"x": 3', None),
    ('a:\n  b:\n    c: 1\n  d: 2\ne: 3', None),
    ('a:    \n  - 1\nb: x', None),
    ('key   : value', None),
    ('', None),
    ('# only a comment', None),
    ('just a scalar', None),
    ('[1, [2, {a: b}]]', None),
    ('{a: 1}', None),
]


@pytest.mark.parametrize('text,expected', QUIRKS)
def test_quirk(text, expected):
    want = yaml.safe_load(text)
    if expected is not None:
        assert same(want, expected)
    assert same(yaml_subset.safe_load(text), want)


UNSUPPORTED = [
    'a: &x 1\nb: *x',               # anchor, alias
    'a: *x',
    'a: !!str 1',                   # tags
    'a: !custom 1',
    'a: |\n  text',                 # block scalars
    'a: >\n  folded',
    'a: 1\n---\nb: 2',              # several documents
    '---\na: 1',
    'a: 1\n...',
    '%YAML 1.1\n---\na: 1',         # a directive
    '? complex\n: key',
    '<<: {a: 1}',                   # a merge key
    'a: =',
    'a: "open\n  quoted"',          # scalars over several lines
    "a: 'open\n  quoted'",
    'a: plain\n  continued',
    'a: [1,\n  2]',                 # flow over several lines
    'a:\n\t- 1',                    # a tab in the indentation
    'a: b: c',
    'a: @x',
    'a: `x`',
    'a: [x:1]',
    'a: [k: v]',
    'a:\n  - 1\n - 2',
    '- a\nb: 1',
]


@pytest.mark.parametrize('text', UNSUPPORTED)
def test_unsupported_raises_naming_the_line(text):
    with pytest.raises(ValueError, match=r'line \d+'):
        yaml_subset.safe_load(text)


_keys = st.text(alphabet='abcdefghijklmnopqrstuvwxyz_', min_size=1, max_size=12)
# printable ASCII, short: longer or escaped strings make yaml.dump fold a
# quoted scalar over several lines, which the subset does not read
_strings = st.text(alphabet=st.characters(min_codepoint=32, max_codepoint=126), max_size=20)
_scalars = (st.none() | st.booleans() | st.integers(-10**12, 10**12)
            | st.floats(allow_nan=False, width=64) | _strings
            | st.sampled_from(['13:52:45', '2020-01-30', 'yes', 'off', '1e3', '1.0e+3', '017',
                               '0x1F', '~', '', 'EPSG:4326', '33 34 -118.25 -116.75', 'a #b',
                               'a: b', '- x', "it's", 'null', '.nan', '-.5', '@x', '*x', '!x',
                               'Zürich', 'tab\there'])
            | st.dates(dt.date(1900, 1, 1), dt.date(2100, 1, 1)))
_values = st.recursive(_scalars, lambda inner: st.lists(inner, max_size=4)
                       | st.dictionaries(_keys, inner, max_size=4), max_leaves=10)
_configs = st.dictionaries(_keys, st.dictionaries(_keys, _values, max_size=6) | _scalars,
                           max_size=8)


@settings(max_examples=60, deadline=None)
@given(_configs)
def test_drawn_configs_read_as_pyyaml_reads_them(cfg):
    text = yaml.dump(cfg, default_flow_style=False)
    assert same(yaml_subset.safe_load(text), yaml.safe_load(text))


@settings(max_examples=60, deadline=None)
@given(_configs)
def test_writer_round_trips_through_pyyaml(cfg):
    text = yaml_subset.dump(cfg)
    want = yaml.safe_load(yaml.dump(cfg))
    assert same(yaml.safe_load(text), want)
    assert same(yaml_subset.safe_load(text), want)


def test_writer_escapes_what_a_line_cannot_hold():
    """Line breaks and control characters go double-quoted with escapes
    (yaml.dump would fold them over several lines)."""
    cfg = {'a': 'line\nbreak', 'b': '\x1f\x00bell\x07', 'c': 'é \U00010000', 'd': ' lead'}
    text = yaml_subset.dump(cfg)
    assert len(text.splitlines()) == 4
    assert same(yaml.safe_load(text), cfg) and same(yaml_subset.safe_load(text), cfg)


def test_write_yaml_matches_the_jax_package(tmp_path):
    """``write_yaml`` of both packages: the same config after a read back."""
    from raider_tpu.workflows.config import write_yaml as j_write
    from raider_tpu_torch.workflows.config import write_yaml as t_write

    content = {'weather_model': 'ERA5', 'date_group': {'date_list': [20200103, 20200205]},
               'aoi_group': {'bounding_box': '36 37 -92 -91'},
               'time_group': {'time': '00:00:00', 'interpolate_time': 'none'}}
    a, b = j_write(content, tmp_path / 'j.yaml'), t_write(content, tmp_path / 't.yaml')
    assert same(yaml.safe_load(b.read_text()), yaml.safe_load(a.read_text()))
    assert same(yaml_subset.safe_load(b.read_text()), yaml.safe_load(a.read_text()))
