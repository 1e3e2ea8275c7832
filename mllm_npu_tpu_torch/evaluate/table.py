"""CSV tables for the text benchmarks, read with the standard library's
``csv`` (the reference reads them with ``pandas.read_csv`` and its
defaults, ``text_benchmarks.py:92-143``; the port does not depend on
pandas). The benchmarks' bytes are ``str()`` of each cell, so the reader
gives every cell the value pandas' C parser gives it:

- each column's type is inferred over the whole file, in pandas' order:
  int64 (every cell an integer: ``"007"`` → 7, ``" 5"`` → 5), float64
  (every cell a float, an integer or NA: ``"1.50"`` → 1.5, ``"1"`` → 1.0,
  ``"inf"``, NA → nan), bool (every cell ``true`` or ``false`` in any
  case, or NA: → ``True`` / ``False``, NA → nan), else text (the cell as
  written, NA → nan);
- NA is exactly one of pandas' default NA strings (``""``, ``"NA"``,
  ``"N/A"``, ``"None"``, ``"null"``, ``"nan"``, …), unstripped;
- an integer past int64 (before any cell that is not an integer) makes
  its column text unless every cell is an integer in uint64's range;
- blank lines are skipped; with a header row (``header="infer"``) empty
  names become ``Unnamed: i`` and repeated ones ``A.1``, ``A.2``; a first
  data row one field longer than the header makes the first field an
  index, which is dropped; short rows are padded with NA.

A float cell is read by ``xstrtod``, pandas' own converter
(``precise_xstrtod``, the C parser's default) and not ``float()``: it keeps
17 digits, leading zeros among them, and scales by one power of ten, so
it is not always correctly rounded (``"3.16617e-64"`` →
``3.1661699999999995e-64``). Not reproduced: a uint64 column with an NA
cell.

``Table`` has what the benchmarks use of a DataFrame: ``shape``,
``columns``, ``iloc[i, j]``, ``iloc[i]`` (a row by column name, with
``get``), ``table[:k]`` (rows) and ``table[[names]]`` (columns).
"""

from __future__ import annotations

import csv
import math
import re
from typing import Optional

# pandas' default NA strings (pandas._libs.parsers.STR_NA_VALUES)
NA_VALUES = frozenset({
    "", "#N/A", "#N/A N/A", "#NA", "-1.#IND", "-1.#QNAN", "-NaN", "-nan",
    "1.#IND", "1.#QNAN", "<NA>", "N/A", "NA", "NULL", "NaN", "None", "n/a",
    "nan", "null"})
_WS = "[ \t\n\v\f\r]*"
_INT = re.compile(_WS + r"[+-]?[0-9]+" + _WS)
_SPACE = " \t\n\v\f\r"
_DIGITS = "0123456789"
_POW10 = [float(f"1e{i}") for i in range(309)]
_INF = {"inf": math.inf, "+inf": math.inf, "-inf": -math.inf,
        "infinity": math.inf, "+infinity": math.inf, "-infinity": -math.inf}
_BOOL = {"true": True, "false": False}
_I64 = (-2 ** 63, 2 ** 63 - 1)


def _ints(cells):
    """The column as ints; None (try floats) if it holds an NA or a cell
    that is not an integer before any integer past int64; past int64,
    ints if every cell is an integer in uint64's range, else "text"."""
    out, has_na = [], False
    for c in cells:
        if c in NA_VALUES:
            has_na = True
            continue
        if not _INT.fullmatch(c):
            return None
        v = int(c)
        if not _I64[0] <= v <= _I64[1]:
            ok = all(x not in NA_VALUES and _INT.fullmatch(x)
                     and 0 <= int(x) < 2 ** 64 for x in cells)
            return [int(x) for x in cells] if ok else "text"
        out.append(v)
    return None if has_na else out


def xstrtod(cell: str) -> Optional[float]:
    """pandas' float converter on one cell → its float, or None where the
    cell is no float to it: whitespace around, a sign, at most 17 digits
    kept (leading zeros count; later ones before the point scale by ten,
    after it are dropped), then ``e`` and a signed exponent (whitespace
    allowed after the ``e``); the digits as one float scaled by one
    correctly rounded power of ten, or two past 1e-308; an exponent past
    308 gives ±inf (0 stays +0), past -616 +0."""
    n, p = len(cell), 0
    while p < n and cell[p] in _SPACE:
        p += 1
    neg = p < n and cell[p] == "-"
    if p < n and cell[p] in "+-":
        p += 1
    number, exponent, digits = 0.0, 0, 0
    while p < n and cell[p] in _DIGITS:
        if digits < 17:
            number = number * 10.0 + (ord(cell[p]) - 48)
            digits += 1
        else:
            exponent += 1
        p += 1
    if p < n and cell[p] == ".":
        p += 1
        while p < n and cell[p] in _DIGITS:
            if digits < 17:
                number = number * 10.0 + (ord(cell[p]) - 48)
                digits += 1
                exponent -= 1
            p += 1
    if digits == 0:
        return None
    if neg:
        number = -number
    if p < n and cell[p] in "eE":
        p += 1
        while p < n and cell[p] in _SPACE:
            p += 1
        eneg = p < n and cell[p] == "-"
        if p < n and cell[p] in "+-":
            p += 1
        start = p
        while p < n and cell[p] in _DIGITS:
            p += 1
        if p == start:
            return None
        exponent += -int(cell[start:p]) if eneg else int(cell[start:p])
    while p < n and cell[p] in _SPACE:
        p += 1
    if p != n:
        return None
    if exponent > 308:
        return math.copysign(math.inf, number) if number else 0.0
    if exponent > 0:
        return number * _POW10[exponent]
    if exponent < -616:
        return 0.0
    if exponent < -308:
        return number / _POW10[-308 - exponent] / _POW10[308]
    return number / _POW10[-exponent]


def _floats(cells):
    out = []
    for c in cells:
        if c in NA_VALUES:
            out.append(math.nan)
        elif (v := xstrtod(c)) is not None:
            out.append(v)
        elif c.lower() in _INF:
            out.append(_INF[c.lower()])
        else:
            return None
    return out


def _bools(cells):
    out = []
    for c in cells:
        if c in NA_VALUES:
            out.append(math.nan)
        elif c.lower() in _BOOL:
            out.append(_BOOL[c.lower()])
        else:
            return None
    return out


def convert_column(cells: list) -> list:
    """Raw cell strings → the values pandas' C parser gives them (see the
    module's docstring)."""
    ints = _ints(cells)
    if isinstance(ints, list):
        return ints
    if ints is None:
        for conv in (_floats, _bools):
            got = conv(cells)
            if got is not None:
                return got
    return [math.nan if c in NA_VALUES else c for c in cells]


def _names(header: list) -> list:
    names, seen = [], {}
    for i, h in enumerate(header):
        name = h if h != "" else f"Unnamed: {i}"
        if name in seen:
            k = seen[name]
            while f"{name}.{k}" in seen:
                k += 1
            seen[name] = k + 1
            name = f"{name}.{k}"
        seen[name] = seen.get(name, 1)
        names.append(name)
    return names


class _Row:
    def __init__(self, names, values):
        self._d = dict(zip(names, values))

    def __getitem__(self, name):
        return self._d[name]

    def get(self, name, default=None):
        return self._d.get(name, default)


class _ILoc:
    def __init__(self, table):
        self._t = table

    def __getitem__(self, key):
        if isinstance(key, tuple):
            i, j = key
            return self._t._cols[j][i]
        return _Row(self._t.columns, [c[key] for c in self._t._cols])


class Table:
    """Columns of converted cells (see the module's docstring)."""

    def __init__(self, columns: list, cols: list):
        self.columns = list(columns)
        self._cols = [list(c) for c in cols]

    @property
    def shape(self):
        return (len(self._cols[0]) if self._cols else 0, len(self.columns))

    @property
    def iloc(self) -> _ILoc:
        return _ILoc(self)

    def __getitem__(self, key):
        if isinstance(key, slice):
            return Table(self.columns, [c[key] for c in self._cols])
        idx = [self.columns.index(k) for k in key]
        return Table(list(key), [self._cols[i] for i in idx])


def read_csv(path, header: Optional[str] = "infer") -> Table:
    """``pandas.read_csv(path)`` (``header=None``: no header row, columns
    0..n-1), as the text benchmarks see it."""
    with open(path, newline="", encoding="utf-8-sig") as f:
        rows = [r for r in csv.reader(f)
                if r and not (len(r) == 1 and not r[0].strip())]
    if header is None:
        names = list(range(len(rows[0]))) if rows else []
    else:
        names, rows = _names(rows[0]), rows[1:]
        if rows and len(rows[0]) == len(names) + 1:
            rows = [r[1:] for r in rows]
    n = len(names)
    for i, r in enumerate(rows):
        if len(r) > n:
            raise ValueError(f"{path}: expected {n} fields in data row {i}, "
                             f"saw {len(r)}")
    cols = [convert_column([r[j] if j < len(r) else "" for r in rows])
            for j in range(n)]
    return Table(names, cols)
