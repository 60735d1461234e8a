"""Column tables without pandas: what the drivers and the reporting layer
need of a data frame.

A frame is a dict of column name -> 1-D numpy array, all of one length.
:func:`read_csv` parses a CSV file as ``pandas.read_csv`` would type it
(integers as int64, numbers as float64 with empty cells NaN, anything
else as strings; an unnamed first column is ``Unnamed: 0``),
:func:`write_csv` writes rows (a list of dicts) as ``DataFrame.to_csv``
would, and :func:`group_mean` is a sorted group-by with per-group
statistics.
"""

from __future__ import annotations

import csv
import datetime
import os

import numpy as np


def _column(cells):
    try:
        return np.array([int(c) for c in cells], dtype=np.int64)
    except ValueError:
        pass
    try:
        return np.array([float(c) if c != "" else np.nan for c in cells],
                        dtype=np.float64)
    except ValueError:
        return np.array([c if c != "" else np.nan for c in cells],
                        dtype=object)


def read_csv(path):
    """The CSV at ``path`` as a frame, or None when there is no file."""
    if not os.path.exists(path):
        return None
    # A fixed-runtime row carries its whole loss history in one cell,
    # past the csv module's default field limit of 128 KiB.
    csv.field_size_limit(max(csv.field_size_limit(), 2 ** 31 - 1))
    with open(path, newline="") as f:
        rows = list(csv.reader(f))
    header = [name or f"Unnamed: {i}" for i, name in enumerate(rows[0])]
    body = rows[1:]
    return {name: _column([r[i] for r in body])
            for i, name in enumerate(header)}


def length(frame) -> int:
    return len(next(iter(frame.values())))


def select(frame, mask):
    """The rows of ``frame`` where the boolean array ``mask`` is True."""
    return {k: v[mask] for k, v in frame.items()}


def _cell(value):
    """One cell as ``DataFrame.to_csv`` writes it: None and NaN empty, a
    duration as ``D days HH:MM:SS.ffffff``."""
    if value is None:
        return ""
    if isinstance(value, datetime.timedelta):
        seconds = value.seconds
        return (f"{value.days} days {seconds // 3600:02d}:"
                f"{seconds // 60 % 60:02d}:{seconds % 60:02d}."
                f"{value.microseconds:06d}")
    if isinstance(value, (bool, np.bool_)):
        return str(bool(value))
    if isinstance(value, (int, np.integer)):
        return str(int(value))
    if isinstance(value, (float, np.floating)):
        return "" if np.isnan(value) else repr(float(value))
    if isinstance(value, (list, tuple)):
        return str([float(x) if isinstance(x, np.floating) else x
                    for x in value])
    return value


def write_csv(path, rows, index=True):
    """Write ``rows`` (dicts) to ``path`` with the columns in order of
    first appearance; with ``index``, an unnamed first column numbers
    the rows from 0."""
    columns = []
    for row in rows:
        columns += [k for k in row if k not in columns]
    with open(path, "w", newline="") as f:
        w = csv.writer(f)
        w.writerow(([""] if index else []) + columns)
        for i, row in enumerate(rows):
            w.writerow(([i] if index else [])
                       + [_cell(row.get(c)) for c in columns])


def _mean(values):
    """pandas' mean: NaN cells skipped."""
    values = np.asarray(values, dtype=np.float64)
    values = values[~np.isnan(values)]
    return float(np.mean(values)) if values.size else float("nan")


def _std(values):
    """pandas' std: the sample deviation (ddof=1), NaN cells skipped."""
    values = np.asarray(values, dtype=np.float64)
    values = values[~np.isnan(values)]
    return (float(np.std(values, ddof=1)) if values.size > 1
            else float("nan"))


STATS = {"mean": _mean, "std": _std}


def group_mean(frame, keys, columns):
    """Group ``frame`` by the ``keys`` columns in sorted key order (as
    ``DataFrame.groupby``), and give each group its key values and, for
    each (column, statistic) of ``columns``, the statistic: a frame with
    the keys' columns and one ``column`` (a bare column name means its
    mean) or ``column_statistic`` column per entry."""
    key_rows = list(zip(*(frame[k].tolist() for k in keys)))
    groups = sorted(set(key_rows))
    out = {k: [] for k in keys}
    names = []
    for entry in columns:
        col, stat = entry if isinstance(entry, tuple) else (entry, None)
        names.append((col, stat, col if stat is None else f"{col}_{stat}"))
    for _, _, name in names:
        out[name] = []
    for g in groups:
        mask = np.array([r == g for r in key_rows])
        for k, v in zip(keys, g):
            out[k].append(v)
        for col, stat, name in names:
            out[name].append(STATS[stat or "mean"](frame[col][mask]))
    return {k: np.array(v, dtype=frame[k].dtype if k in keys else np.float64)
            for k, v in out.items()}
