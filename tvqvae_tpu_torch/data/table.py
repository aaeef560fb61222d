"""Tables of numpy columns, and the CSV reading that the ADS-B loaders need.

A table is a dict of equal-length numpy columns. This module stands in for
the pandas calls of ``tvqvae_tpu/data/preprocess.py`` and
``tvqvae_tpu/scripts/preprocess_landing.py``: ``read_csv`` (whole or in
chunks), ``dropna``, ``sort_values``, ``groupby().first()/last()/size()``,
``duplicated`` and an inner ``merge``; ``groupby().diff()/shift(-1)`` are
written where they are used, on rows sorted by group.

``read_csv`` keeps every field as text; the loaders convert the columns they
use (``to_float``, ``to_ids``, ``parse_iso8601``, ``parse_day_month_year``).
Timestamps are ``datetime64[ns]`` in UTC. Sorts are stable, so rows with
equal keys keep their order, and group keys come out in sorted order, as
pandas' ``groupby`` gives them.
"""

import csv
import itertools
from typing import Dict, Iterator, List, Optional, Sequence, Tuple

import numpy as np

Table = Dict[str, np.ndarray]

# pandas' default missing-value markers (``read_csv``'s ``na_values``)
NA_VALUES = ("", "#N/A", "#N/A N/A", "#NA", "-1.#IND", "-1.#QNAN", "-NaN", "-nan", "1.#IND",
             "1.#QNAN", "<NA>", "N/A", "NA", "NULL", "NaN", "None", "n/a", "nan", "null")


def table_len(t: Table) -> int:
    return len(next(iter(t.values()))) if t else 0


def take(t: Table, idx) -> Table:
    """Rows ``idx`` (indices or a boolean mask) of every column."""
    return {k: v[idx] for k, v in t.items()}


def concat(tables: Sequence[Table]) -> Table:
    tables = [t for t in tables if t]
    if not tables:
        return {}
    return {k: np.concatenate([t[k] for t in tables]) for k in tables[0]}


def sort_rows(t: Table, keys: Sequence[str]) -> Table:
    """Rows sorted by ``keys`` (the first the primary key), ties kept in order."""
    return take(t, np.lexsort([t[k] for k in reversed(keys)]))


# --------------------------------------------------------------------------
# reading


def _columns(header: List[str], lines: List[str]) -> Table:
    """The fields of CSV ``lines`` as text columns named by ``header``;
    blank lines are skipped, as pandas skips them."""
    lines = [line for line in lines if line.strip()]
    n, ncols = len(lines), len(header)
    text = "".join(lines).replace("\r\n", "\n").rstrip("\n")
    fields = text.replace("\n", ",").split(",") if text else []
    if '"' in text or len(fields) != n * ncols:  # quoted fields, or a ragged row
        rows = list(csv.reader(lines))
        bad = [i for i, r in enumerate(rows) if len(r) != ncols]
        if bad:
            raise ValueError(f"row {bad[0]} has {len(rows[bad[0]])} fields, the header {ncols}")
        fields = [v for r in rows for v in r]
    # an empty header is pandas' "Unnamed: <position>" (an unnamed index column)
    names = [name or f"Unnamed: {i}" for i, name in enumerate(header)]
    return {name: np.array(fields[j::ncols], dtype=str) for j, name in enumerate(names)}


def read_csv(path: str) -> Table:
    """Every column of the CSV at ``path`` as text (numpy ``str``), the first
    line naming them."""
    return next(read_csv_chunks(path, None))


def read_csv_chunks(path: str, chunk_size: Optional[int]) -> Iterator[Table]:
    """The CSV at ``path`` as tables of ``chunk_size`` lines (one table of
    every line for ``None``), as ``pandas.read_csv(chunksize=)`` yields them.
    A quoted field may not hold a line break."""
    with open(path, newline="") as f:
        header = next(csv.reader([f.readline()]))
        if chunk_size is None:
            yield _columns(header, f.readlines())
            return
        while True:
            lines = list(itertools.islice(f, chunk_size))
            if not lines:
                return
            yield _columns(header, lines)


def is_missing(col: np.ndarray) -> np.ndarray:
    """Which text fields pandas reads as missing (the whole field one of
    ``NA_VALUES``); NaN for float columns."""
    if col.dtype.kind == "f":
        return np.isnan(col)
    if col.dtype.kind in "UO":
        return np.isin(col.astype(str), NA_VALUES)
    return np.zeros(len(col), bool)


def dropna(t: Table) -> Table:
    """The rows with no missing field."""
    missing = np.zeros(table_len(t), bool)
    for col in t.values():
        missing |= is_missing(col)
    return take(t, ~missing)


def to_float(col: np.ndarray) -> np.ndarray:
    """Text to float64, missing fields as NaN."""
    if col.dtype.kind in "fiu":
        return col.astype(np.float64)
    out = np.full(len(col), np.nan)
    ok = ~is_missing(col)
    out[ok] = col[ok].astype(np.float64)  # numpy's cast skips surrounding blanks
    return out


def to_ids(col: np.ndarray) -> np.ndarray:
    """An identifier column as pandas infers it: int64 where every field is
    an integer (EuroControl's ``ECTRL ID``), so that ids sort as numbers;
    else the text."""
    try:
        return col.astype(np.int64)
    except ValueError:
        return col


def _utc_offset_minutes(text: str) -> Tuple[str, int]:
    """(text without its UTC designator, the offset in minutes): a trailing
    ``Z``, or ``+HH:MM`` / ``-HH:MM`` after the time of day."""
    if text.endswith("Z"):
        return text[:-1], 0
    if len(text) > 16 and text[-6] in "+-" and text[-3] == ":":
        minutes = int(text[-5:-3]) * 60 + int(text[-2:])
        return text[:-6], -minutes if text[-6] == "-" else minutes
    return text, 0


def parse_iso8601(col: np.ndarray) -> np.ndarray:
    """ISO 8601 text (``2021-06-01 10:00:00+00:00``, ``2021-06-01T10:00:00Z``,
    fractional seconds, no designator meaning UTC) to ``datetime64[ns]`` in
    UTC. numpy parses the local time; an offset is subtracted here."""
    text = np.char.strip(col.astype(str))
    utc = np.char.replace(np.char.replace(text, "Z", ""), "+00:00", "")
    if not ((np.char.find(utc, "+") >= 0) | (np.char.rfind(utc, "-") > 7)).any():
        return utc.astype("datetime64[ns]")  # every stamp in UTC: one vectorised parse
    parts = [_utc_offset_minutes(s) for s in text.tolist()]
    local = np.array([p[0] for p in parts], dtype="datetime64[ns]")
    offset = np.array([p[1] for p in parts], dtype=np.int64)
    return local - offset.astype("timedelta64[m]").astype("timedelta64[ns]")


def parse_day_month_year(col: np.ndarray) -> np.ndarray:
    """EuroControl's ``%d-%m-%Y %H:%M:%S`` in UTC to ``datetime64[ns]``."""
    iso = []
    for s in col.tolist():
        s = s.strip()
        if len(s) != 19 or s[2] + s[5] + s[10] + s[13] + s[16] != "-- ::":
            raise ValueError(f"time {s!r} does not match %d-%m-%Y %H:%M:%S")
        iso.append(f"{s[6:10]}-{s[3:5]}-{s[0:2]}T{s[11:]}")
    return np.array(iso, dtype="datetime64[ns]")


# --------------------------------------------------------------------------
# groups


def group_first(key: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
    """(sorted unique keys, the row of each key's first occurrence)."""
    return np.unique(key, return_index=True)


def group_last(key: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
    """(sorted unique keys, the row of each key's last occurrence)."""
    uniq, rev = np.unique(key[::-1], return_index=True)
    return uniq, len(key) - 1 - rev


def duplicated(t: Table, subset: Sequence[str], keep="first") -> np.ndarray:
    """pandas' ``duplicated(subset, keep)``: with ``keep="first"`` every
    occurrence of a row's ``subset`` values after the first, with
    ``keep=False`` every occurrence of a repeated one."""
    n = table_len(t)
    if n == 0:
        return np.zeros(0, bool)
    order = np.lexsort([t[k] for k in reversed(subset)])
    same = np.ones(n - 1, bool)
    for k in subset:
        col = t[k][order]
        same &= col[1:] == col[:-1]
    dup = np.zeros(n, bool)
    dup[1:] = same  # equal to the row before in (stable) sorted order
    if keep is False:
        dup[:-1] |= same
    elif keep != "first":
        raise ValueError(f"keep={keep!r}: only 'first' and False are supported")
    out = np.zeros(n, bool)
    out[order] = dup
    return out


def inner_join(left: Table, right: Table, on: str) -> Table:
    """pandas' ``left.merge(right, on=on)`` (inner): each left row in order,
    once for each right row with its key, in right order; the right table's
    other columns added."""
    r_order = np.argsort(right[on], kind="stable")
    r_keys = right[on][r_order]
    lo = np.searchsorted(r_keys, left[on], side="left")
    hi = np.searchsorted(r_keys, left[on], side="right")
    counts = hi - lo
    rows = np.repeat(np.arange(table_len(left)), counts)
    starts = np.repeat(lo - np.cumsum(counts) + counts, counts)
    matched = r_order[starts + np.arange(len(rows))]
    out = take(left, rows)
    for k, v in right.items():
        if k != on:
            out[k] = v[matched]
    return out
