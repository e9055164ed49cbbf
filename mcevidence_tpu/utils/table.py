"""Labelled column tables for the grid driver's outputs.

The per-dataset and aggregate evidence tables are a row index (model or
dataset names) and named columns of floats, ints or strings.  This module
holds them as numpy arrays and writes them as csv (the layout pandas'
``to_csv`` produces: an unnamed index column, shortest round-trip floats,
empty cells for NaN) and as aligned text, so the grid driver needs nothing
beyond numpy and the standard library.
"""

from __future__ import annotations

import csv
import math
from typing import Dict, Iterable, List, Optional

import numpy as np


def _as_column(values, n: int) -> np.ndarray:
    arr = np.asarray(values)
    if arr.ndim == 0:
        arr = np.full(n, arr[()])
    if arr.shape != (n,):
        raise ValueError(f"column of length {arr.shape} for {n} rows")
    if arr.dtype.kind not in "biuf":
        arr = np.array([str(v) for v in arr], dtype=object)
    return arr


class Table:
    """Row index plus named columns (numpy arrays, one value per row)."""

    def __init__(self, index: Iterable[str],
                 columns: Optional[Dict[str, Iterable]] = None):
        self.index: List[str] = [str(i) for i in index]
        self._cols: Dict[str, np.ndarray] = {}
        for name, values in (columns or {}).items():
            self[name] = values

    @property
    def columns(self) -> List[str]:
        return list(self._cols)

    def __contains__(self, name) -> bool:
        return name in self._cols

    def __getitem__(self, name: str) -> np.ndarray:
        return self._cols[name]

    def __setitem__(self, name: str, values) -> None:
        self._cols[name] = _as_column(values, len(self.index))

    def at(self, row: str, col: str):
        """The value in row ``row`` of column ``col``."""
        return self._cols[col][self.index.index(row)]

    def rows(self) -> List[list]:
        return [[label] + [self._cols[c][i] for c in self._cols]
                for i, label in enumerate(self.index)]

    def to_csv(self, path: str) -> None:
        with open(path, "w", newline="") as fh:
            out = csv.writer(fh, lineterminator="\n")
            out.writerow([""] + self.columns)
            for row in self.rows():
                out.writerow([row[0]] + [_csv_cell(v) for v in row[1:]])

    def to_text(self) -> str:
        """Aligned text table, floats to two decimals (the layout of
        ``tabulate``'s psql format when that package is installed)."""
        try:
            from tabulate import tabulate
        except ImportError:
            return self._plain_text()
        return tabulate(self.rows(), headers=[""] + self.columns,
                        tablefmt="psql", floatfmt=".2f", numalign="left")

    def _plain_text(self) -> str:
        cols = [[""] + self.index]
        for name, values in self._cols.items():
            cols.append([name] + [_text_cell(v) for v in values])
        widths = [max(len(s) for s in col) for col in cols]
        lines = []
        for r in range(len(self.index) + 1):
            cells = [cols[0][r].ljust(widths[0])]
            cells += [col[r].rjust(w) for col, w in zip(cols[1:], widths[1:])]
            lines.append("  ".join(cells).rstrip())
        return "\n".join(lines)


def _csv_cell(v) -> str:
    if isinstance(v, (float, np.floating)):
        return "" if math.isnan(v) else repr(float(v))
    if isinstance(v, (int, np.integer)):
        return str(int(v))
    return str(v)


def _text_cell(v) -> str:
    if isinstance(v, (float, np.floating)):
        return "NaN" if math.isnan(v) else f"{float(v):.2f}"
    return str(v)


def _parse_column(cells: List[str]):
    try:
        return np.array([float(c) if c else math.nan for c in cells])
    except ValueError:
        return np.array(cells, dtype=object)


def read_csv(path: str) -> Table:
    """Read a table written by :meth:`Table.to_csv`: numeric columns come
    back as float arrays (empty cells NaN), the others as strings."""
    with open(path, newline="") as fh:
        rows = list(csv.reader(fh))
    header, body = rows[0], rows[1:]
    cols = {name: _parse_column([r[j + 1] for r in body])
            for j, name in enumerate(header[1:])}
    return Table([r[0] for r in body], cols)
