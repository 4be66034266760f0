"""Column tables: the pandas DataFrame steps of the GNSS tools, without pandas.

The machine with the card has no pandas, so the port's CSV tools
(``workflows.gnss``, ``workflows.gnss_combine``, the station tables of
``workflows.check_args``) read, reshape and write their tables with the
stdlib ``csv`` module and numpy, to the semantics of the pandas calls the
JAX package makes.

A table is a ``dict`` from column name to a 1-d numpy array, every column
of one length, in column order. Column dtypes are the ones pandas'
``read_csv`` infers: ``int64`` (every field an integer), ``float64`` (every
field a number or empty: NaN), ``object`` (text; an empty field is NaN),
and ``datetime64[ns]`` for the columns named in ``parse_dates`` (NaT where
empty). pandas 3 keeps datetimes in microseconds; the values are the same.

Floats are parsed by Python's ``float()`` (correctly rounded; pandas'
default parser is now and then 1 ulp off) and written as pandas writes
them: the shortest repr in their dtype, NaN as an empty field. A datetime
column is written as dates (``2020-01-30``) when every value is at
midnight, else with the time (``2020-01-30 12:00:00``) and the fraction of
a second its finest value needs.
"""

import csv
import io
import math
from typing import Dict, Iterable, List, Optional, Sequence

import numpy as np

Table = Dict[str, np.ndarray]

# the strings pandas' read_csv reads as NaN by default
NA_VALUES = frozenset({'', '#N/A', '#N/A N/A', '#NA', '-1.#IND', '-1.#QNAN', '-NaN', '-nan',
                       '1.#IND', '1.#QNAN', '<NA>', 'N/A', 'NA', 'NULL', 'NaN', 'None', 'n/a',
                       'nan', 'null'})

_NS_PER_DAY = 86_400 * 10**9


def column_kind(values: list) -> str:
    """pandas' type for a CSV column: 'int' when every field is an integer,
    'float' when every field is a number or NaN (an int column with a blank
    turns float), else 'str'."""
    fields = [v.strip() for v in values]
    numbers = [v for v in fields if v not in NA_VALUES]
    if any('_' in v for v in numbers):   # Python's int() and float() take '1_000'
        return 'str'
    for kind, cast in (('int', int), ('float', float)):
        try:
            for v in numbers:
                cast(v)
        except ValueError:
            continue
        if kind == 'int' and len(numbers) < len(fields):
            return 'float'
        return kind
    return 'str'


def float_text(value, dtype=np.float64) -> str:
    """A float as pandas' to_csv writes it: the shortest repr in its dtype,
    NaN as an empty field."""
    value = dtype(value)
    return '' if math.isnan(value) else str(value)


def parse_datetimes(texts: Iterable[str]) -> np.ndarray:
    """ISO dates or date-times (``2020-01-30``, ``2020-01-30 12:00:00``) as
    datetime64[ns], NaT where empty."""
    texts = list(texts)
    try:
        # numpy's own parse of the whole column (an empty field is NaT);
        # any other missing-value text is left to the field-by-field parse
        return np.char.replace(np.char.strip(np.asarray(texts, dtype=str)), ' ', 'T').astype(
            'datetime64[ns]')
    except ValueError:
        pass
    out = [np.datetime64('NaT') if t.strip() in NA_VALUES
           else np.datetime64(t.strip().replace(' ', 'T'), 'ns') for t in texts]
    return np.array(out, dtype='datetime64[ns]')


def _parse_numbers(texts: List[str]) -> Optional[np.ndarray]:
    """A column of numbers without a missing value, parsed in one pass (by
    ``int()``, else ``float()``, as the field-by-field path parses); None
    for any other column."""
    if not texts or '_' in ''.join(texts):
        return None
    try:
        return np.fromiter(map(int, texts), np.int64, len(texts))
    except OverflowError:
        return None
    except ValueError:
        pass
    try:
        f = np.fromiter(map(float, texts), np.float64, len(texts))
    except ValueError:
        return None
    # 'nan' and 'NaN' parse, and are missing values: the field-by-field path
    return None if np.isnan(f).any() else f


def parse_column(texts: List[str]) -> np.ndarray:
    """A column's text fields as the array pandas' read_csv makes of them."""
    fast = _parse_numbers(texts)
    if fast is not None:
        return fast
    kind = column_kind(texts) if texts else 'str'
    if kind == 'int':
        return np.array([int(v.strip()) for v in texts], dtype=np.int64)
    if kind == 'float':
        return np.array([float('nan') if v.strip() in NA_VALUES else float(v) for v in texts],
                        dtype=np.float64)
    return np.array([float('nan') if v in NA_VALUES else v for v in texts], dtype=object)


def read_csv(path, parse_dates: Sequence[str] = ()) -> Table:
    """``pd.read_csv(path, parse_dates=...)``: a header row, blank lines
    skipped, short rows padded with NaN. A row with more fields than the
    header raises ``ValueError`` (pandas' ``ParserError`` is one), as does a
    ``parse_dates`` column the file lacks."""
    with open(path, newline='') as f:
        text = f.read()
    columns = _plain_columns(text)
    if columns is None:
        rows = [r for r in csv.reader(io.StringIO(text)) if r]
        if not rows:
            raise ValueError(f'No columns to parse from file {path}')
        header, rows = rows[0], rows[1:]
        width = len(header)
        for i, r in enumerate(rows):
            if len(r) > width:
                raise ValueError(f'Error tokenizing data. Expected {width} fields in line '
                                 f'{i + 2}, saw {len(r)}')
        rows = [r + [''] * (width - len(r)) for r in rows]
        columns = [header] + [list(c) for c in zip(*rows)] if rows else [header] + [[]] * width
    header, columns = columns[0], columns[1:]
    for name in parse_dates:
        if name not in header:
            raise ValueError(f"Missing column provided to 'parse_dates': '{name}'")
    return {name: parse_datetimes(texts) if name in parse_dates else parse_column(texts)
            for name, texts in zip(header, columns)}


def _plain_columns(text: str) -> Optional[list]:
    """[header, column, column, ...] of a CSV text without quotes, carriage
    returns or NULs whose every row has the header's field count (the
    csv module's reading of it); None for any other text."""
    if '"' in text or '\r' in text or '\0' in text:
        return None
    lines = [ln for ln in text.split('\n') if ln]
    if not lines:
        return None
    commas = lines[0].count(',')
    if any(ln.count(',') != commas for ln in lines):
        return None
    header = lines[0].split(',')
    fields = ','.join(lines[1:]).split(',') if len(lines) > 1 else []
    width = commas + 1
    return [header] + [fields[j::width] for j in range(width)]


def n_rows(t: Table) -> int:
    return len(next(iter(t.values()))) if t else 0


def isnull(col: np.ndarray) -> np.ndarray:
    """NaN, NaT or None, element by element."""
    if col.dtype.kind == 'f':
        return np.isnan(col)
    if col.dtype.kind == 'M':
        return np.isnat(col)
    if col.dtype.kind == 'O':
        return np.array([v is None or (isinstance(v, float) and math.isnan(v)) for v in col],
                        dtype=bool)
    return np.zeros(col.shape, dtype=bool)


def _datetime_texts(col: np.ndarray) -> List[str]:
    ns = col.astype('datetime64[ns]')
    valid = ~np.isnat(ns)
    ints = ns[valid].astype(np.int64)
    if np.all(ints % _NS_PER_DAY == 0):
        unit = 'D'
    elif np.any(ints % 1000):
        unit = 'ns'
    elif np.any(ints % 10**6):
        unit = 'us'
    elif np.any(ints % 10**9):
        unit = 'ms'
    else:
        unit = 's'
    text = np.datetime_as_string(ns, unit=unit)
    return [str(s).replace('T', ' ') if ok else '' for s, ok in zip(text, valid)]


def _texts(col: np.ndarray) -> List[str]:
    kind = col.dtype.kind
    if kind in 'iu':
        return [str(int(v)) for v in col]
    if kind == 'f':
        return [float_text(v, col.dtype.type) for v in col]
    if kind == 'b':
        return ['True' if v else 'False' for v in col]
    if kind == 'M':
        return _datetime_texts(col)
    out = []
    for v in col:
        if v is None or (isinstance(v, float) and math.isnan(v)):
            out.append('')
        elif isinstance(v, (float, np.floating)):
            out.append(float_text(v, type(v) if isinstance(v, np.floating) else np.float64))
        else:
            out.append(str(v))
    return out


def to_csv(t: Table, path, mode: str = 'w', header: bool = True) -> None:
    """``df.to_csv(path, index=False, mode=..., header=...)``."""
    cols = [_texts(c) for c in t.values()]
    with open(path, mode, newline='') as f:
        w = csv.writer(f, lineterminator='\n')
        if header:
            w.writerow(list(t))
        w.writerows(zip(*cols))


def take(t: Table, index) -> Table:
    """The rows at ``index`` (integer positions or a boolean mask)."""
    return {k: v[index] for k, v in t.items()}


def _missing(dtype: np.dtype, n: int) -> np.ndarray:
    if dtype.kind == 'M':
        return np.full(n, np.datetime64('NaT'), dtype='datetime64[ns]')
    if dtype.kind in 'iuf':
        return np.full(n, np.nan)
    return np.full(n, np.nan, dtype=object)


def _combine(parts: List[np.ndarray]) -> np.ndarray:
    kinds = {p.dtype.kind for p in parts}
    if kinds <= {'i', 'u'}:
        return np.concatenate(parts).astype(np.int64)
    if kinds <= {'i', 'u', 'f'}:
        return np.concatenate(parts).astype(np.float64)
    if kinds == {'M'}:
        return np.concatenate([p.astype('datetime64[ns]') for p in parts])
    return np.concatenate([p.astype(object) for p in parts])


def concat(tables: Sequence[Table]) -> Table:
    """``pd.concat(tables, ignore_index=True)``: the union of the columns in
    the order they first appear, a missing column NaN; int and float
    columns meet as float, anything else with text as object."""
    names = []
    for t in tables:
        names += [k for k in t if k not in names]
    out = {}
    for name in names:
        parts = [t[name] if name in t else None for t in tables]
        like = next(p for p in parts if p is not None)
        out[name] = _combine([p if p is not None else _missing(like.dtype, n_rows(t))
                              for p, t in zip(parts, tables)])
    return out


_NAN_KEY = ('NaN',)


def _keys(col: np.ndarray) -> list:
    """Hashable per-row values: NaN and NaT equal to each other (pandas'
    duplicates and join keys), 0.0 equal to -0.0."""
    null = isnull(col)
    vals = col.astype(np.int64) if col.dtype.kind == 'M' else col
    return [_NAN_KEY if n else (v.item() if isinstance(v, np.generic) else v)
            for v, n in zip(vals, null)]


def row_keys(t: Table, names: Sequence[str]) -> list:
    """Each row's values in the columns ``names``, as a hashable tuple."""
    return list(zip(*(_keys(t[n]) for n in names)))


def isin(values: np.ndarray, others: np.ndarray) -> np.ndarray:
    """``Series.isin``: whether each value occurs among ``others`` (NaN
    matching NaN)."""
    pool = set(_keys(others))
    return np.array([k in pool for k in _keys(values)], dtype=bool)


def drop_duplicates(t: Table, subset: Optional[Sequence[str]] = None) -> Table:
    """``df.drop_duplicates(subset)``: the first of equal rows kept."""
    seen, keep = set(), []
    for key in row_keys(t, list(subset or t)):
        keep.append(key not in seen)
        seen.add(key)
    return take(t, np.array(keep, dtype=bool))


def dropna(t: Table) -> Table:
    """``df.dropna(how='any')``."""
    bad = np.zeros(n_rows(t), dtype=bool)
    for col in t.values():
        bad |= isnull(col)
    return take(t, ~bad)


def _sort_codes(col: np.ndarray) -> np.ndarray:
    null = isnull(col)
    _, inv = np.unique(col[~null], return_inverse=True)
    codes = np.full(col.shape, inv.size and inv.max() + 1, dtype=np.int64)
    codes[~null] = inv
    return codes


def order(t: Table, by: Sequence[str]) -> np.ndarray:
    """A stable ascending order by the columns ``by``, NaN last."""
    return np.lexsort([_sort_codes(t[b]) for b in reversed(by)])


def sort_values(t: Table, by: Sequence[str]) -> Table:
    """``df.sort_values(by=[...])`` on two or more columns (pandas sorts
    those stably, NaN last)."""
    return take(t, order(t, by))


def merge(left: Table, right: Table, on: Sequence[str], sort: bool = False) -> Table:
    """``left.merge(right, how='left', on=on, sort=sort)``: each left row in
    order (with ``sort``, stably by its keys), once for every right row
    with equal keys in the right's order, or once with NaN where none has;
    the left's columns, then the right's other columns, a name in both
    suffixed ``_x`` / ``_y``."""
    matches: Dict[tuple, List[int]] = {}
    for j, key in enumerate(row_keys(right, on)):
        matches.setdefault(key, []).append(j)
    lkeys = row_keys(left, on)
    li, ri = [], []
    for i in (order(left, on) if sort else range(len(lkeys))):
        for j in matches.get(lkeys[i], (-1,)):
            li.append(i)
            ri.append(j)
    li, ri = np.array(li, dtype=np.int64), np.array(ri, dtype=np.int64)
    miss = ri < 0
    out = {}
    for name, col in left.items():
        out[name + '_x' if name in right and name not in on else name] = col[li]
    for name, col in right.items():
        if name in on:
            continue
        vals = col[np.where(miss, 0, ri)] if col.size else _missing(col.dtype, ri.size)
        if miss.any():
            vals = np.where(miss, _missing(col.dtype, ri.size), vals.astype(
                _missing(col.dtype, 0).dtype if col.dtype.kind in 'iub' else vals.dtype))
        out[name + '_y' if name in left else name] = vals
    return out
