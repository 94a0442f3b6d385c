"""A small column table: the annotation table of the port's data layer.

The JAX package keeps its annotations in pandas DataFrames. The port does
not import pandas; this table stands in for the operations its data layer
uses: a column by name (`t["start"]`), adding or replacing one
(`t["end"] = ...`), a row as a dict (`df.loc[i, :]`), a boolean mask
(`df[keep].reset_index(drop=True)`), `take` (`iloc`), `concat`
(`pd.concat(...).reset_index(drop=True)`), `isin`, `get_indexer`
(`pd.Index(...).get_indexer`) and `sort_values`. Every column is a 1-D
numpy array; strings and other Python objects sit in object arrays. Rows
are always numbered 0..n-1, as after pandas' `reset_index(drop=True)`.
"""
from __future__ import annotations

from typing import Any, Dict, List, Mapping, Sequence

import numpy as np


def as_column(values: Any, n: int = None) -> np.ndarray:
    """`values` as a 1-D column: numbers keep numpy's type (Python ints
    become int64, floats float64, as in pandas), strings and other objects
    go into an object array; a scalar is repeated `n` times."""
    if np.isscalar(values) or values is None or not hasattr(values, "__len__"):
        if n is None:
            raise ValueError("a scalar column needs a length")
        values = [values] * n
    if isinstance(values, np.ndarray) and values.dtype.kind not in "USO":
        arr = values
    else:
        arr = np.asarray(list(values) if not isinstance(values, np.ndarray) else values)
        if arr.dtype.kind in "US" or arr.ndim != 1:
            arr = np.empty(len(values), dtype=object)
            arr[:] = list(values)
    if arr.ndim != 1:
        raise ValueError(f"a column must be 1-D, got shape {arr.shape}")
    if n is not None and len(arr) != n:
        raise ValueError(f"column of {len(arr)} rows in a table of {n}")
    return arr


class Table:
    """Named 1-D numpy columns of one length, in insertion order."""

    def __init__(self, columns: Mapping[str, Any] = None):
        self._cols: Dict[str, np.ndarray] = {}
        self._n = 0
        for name, values in (columns or {}).items():
            self[name] = values

    @classmethod
    def from_records(cls, records: Sequence[Mapping[str, Any]]) -> "Table":
        """One row per dict; the columns are the union of the keys in first
        appearance order, a missing value is NaN (pd.DataFrame(records))."""
        names: List[str] = []
        for r in records:
            names.extend(k for k in r if k not in names)
        return cls({k: [r.get(k, np.nan) for r in records] for k in names})

    # ------------------------------------------------------------ columns
    @property
    def columns(self) -> List[str]:
        return list(self._cols)

    def __contains__(self, name: str) -> bool:
        return name in self._cols

    def __getitem__(self, name: str) -> np.ndarray:
        return self._cols[name]

    def __setitem__(self, name: str, values: Any) -> None:
        col = as_column(values, self._n if self._cols else None)
        self._cols[name] = col
        self._n = len(col)

    def __len__(self) -> int:
        return self._n

    def copy(self) -> "Table":
        return Table({k: v.copy() for k, v in self._cols.items()})

    # --------------------------------------------------------------- rows
    def row(self, i: int) -> Dict[str, Any]:
        """Row i as a dict (df.loc[i, :] on a reset index)."""
        if not -self._n <= i < self._n:
            raise IndexError(f"row {i} of a table of {self._n}")
        return {k: v[i] for k, v in self._cols.items()}

    def take(self, indices) -> "Table":
        """The rows at `indices`, renumbered (df.iloc[indices])."""
        idx = np.asarray(indices, dtype=np.int64)
        out = Table()
        out._n = len(idx)
        out._cols = {k: v[idx] for k, v in self._cols.items()}
        return out

    def mask(self, keep) -> "Table":
        """The rows where `keep` is true, renumbered (df[keep])."""
        keep = np.asarray(keep, dtype=bool)
        if keep.shape != (self._n,):
            raise ValueError(f"mask of shape {keep.shape} on {self._n} rows")
        return self.take(np.flatnonzero(keep))

    def isin(self, name: str, values) -> np.ndarray:
        """Boolean mask: column `name`'s value is one of `values`."""
        allowed = set(values)
        return np.fromiter((v in allowed for v in self._cols[name]), dtype=bool,
                           count=self._n)

    def sort_values(self, by: str) -> "Table":
        """Rows ordered by column `by` as pandas' sort_values orders them:
        numpy's argsort with its default kind 'quicksort', which is not
        stable, on the same values, so equal keys land in pandas' order."""
        col = self._cols[by]
        if col.dtype.kind == "f" and np.isnan(col).any():
            raise NotImplementedError("sort_values over NaN keys")
        return self.take(col.argsort(kind="quicksort"))

    def get_indexer(self, name: str, targets) -> np.ndarray:
        """Row of each target in column `name`, -1 where absent
        (pd.Index(column).get_indexer(targets)); the column must hold unique
        values, as pandas requires."""
        pos: Dict[Any, int] = {}
        for i, v in enumerate(self._cols[name].tolist()):
            if v in pos:
                raise ValueError(f"get_indexer needs unique values; {v!r} repeats in {name!r}")
            pos[v] = i
        return np.asarray([pos.get(t, -1) for t in targets], dtype=np.int64)

    @staticmethod
    def concat(tables: Sequence["Table"]) -> "Table":
        """Rows of every table in turn, renumbered; a column missing from a
        table is NaN there, so an integer column widens to float, as
        pd.concat(...).reset_index(drop=True) does."""
        tables = [t for t in tables if t.columns]
        if not tables:
            return Table()
        names: List[str] = []
        for t in tables:
            names.extend(k for k in t.columns if k not in names)
        cols = {}
        for k in names:
            parts = [t[k] if k in t else np.full(len(t), np.nan) for t in tables]
            if any(p.dtype == object for p in parts):
                parts = [p.astype(object) for p in parts]
            cols[k] = np.concatenate(parts)
        return Table(cols)

    def to_dict(self) -> Dict[str, list]:
        """Column name -> list of values (df.to_dict('list'))."""
        return {k: v.tolist() for k, v in self._cols.items()}

    def __repr__(self) -> str:
        return f"Table({self._n} rows: {', '.join(self._cols)})"
