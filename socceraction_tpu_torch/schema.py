"""Lightweight columnar schema validation (port of ``socceraction_tpu/schema.py``).

The reference validates every DataFrame that crosses a layer boundary
with ``pandera`` models (reference ``socceraction/spadl/schema.py:10-33``);
this dependency-free core does the same:

- :class:`Field` declares per-column constraints (dtype, bounds, allowed
  values, nullability).
- :class:`Schema` validates a :class:`pandas.DataFrame`: the column set,
  coercion to declared dtypes and the canonical column order.

pandas is never imported here: the methods take the frames they are given.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import TYPE_CHECKING, Any, Dict, Iterable, Optional, Sequence

import numpy as np

if TYPE_CHECKING:  # the methods take frames; pandas is never imported here
    import pandas as pd

__all__ = ['Field', 'Schema', 'SchemaError']


class SchemaError(ValueError):
    """Raised when a DataFrame does not satisfy a :class:`Schema`."""


@dataclass
class Field:
    """Constraints for a single column.

    Parameters
    ----------
    dtype : str, optional
        Target numpy dtype the column is coerced to (e.g. ``'int64'``,
        ``'float64'``, ``'object'``, ``'str'``). ``None`` leaves the column
        dtype untouched.
    ge, le : float, optional
        Inclusive lower/upper bounds (checked on non-null values).
    isin : sequence, optional
        Set of allowed values (checked on non-null values).
    nullable : bool
        Whether nulls are allowed. Default ``False``.
    required : bool
        Whether the column must be present. Default ``True``.
    """

    dtype: Optional[str] = None
    ge: Optional[float] = None
    le: Optional[float] = None
    isin: Optional[Sequence[Any]] = None
    nullable: bool = False
    required: bool = True

    def validate(self, name: str, col: 'pd.Series') -> 'pd.Series':
        """Coerce and validate a single column, returning the coerced column."""
        if self.dtype is not None:
            try:
                if self.dtype in ('str', 'object'):
                    col = col.astype('object')
                else:
                    col = col.astype(self.dtype)
            except (TypeError, ValueError) as exc:
                raise SchemaError(f'column {name!r}: cannot coerce to {self.dtype}: {exc}')
        nulls = col.isna()
        if not self.nullable and nulls.any():
            raise SchemaError(f'column {name!r}: contains {int(nulls.sum())} null values')
        valid = col[~nulls]
        if self.ge is not None and len(valid) and (valid < self.ge).any():
            raise SchemaError(f'column {name!r}: values below minimum {self.ge}')
        if self.le is not None and len(valid) and (valid > self.le).any():
            raise SchemaError(f'column {name!r}: values above maximum {self.le}')
        if self.isin is not None and len(valid):
            bad = ~valid.isin(list(self.isin))
            if bad.any():
                raise SchemaError(
                    f'column {name!r}: {int(bad.sum())} values outside allowed set'
                )
        return col


@dataclass
class Schema:
    """An ordered collection of :class:`Field` constraints for a DataFrame.

    Parameters
    ----------
    fields : dict(str, Field)
        Mapping of column name to its constraints, in canonical column order.
    strict : bool
        When True, columns not declared in ``fields`` are rejected.
    """

    fields: Dict[str, Field] = field(default_factory=dict)
    strict: bool = True

    def columns(self, required_only: bool = False) -> Iterable[str]:
        """Return the declared column names in canonical order."""
        return [n for n, f in self.fields.items() if f.required or not required_only]

    def validate(self, df: 'pd.DataFrame') -> 'pd.DataFrame':
        """Validate ``df``, returning a copy with columns coerced and ordered.

        Raises
        ------
        SchemaError
            If a required column is missing, an unknown column is present
            (``strict``), or any field constraint is violated.
        """
        missing = [n for n, f in self.fields.items() if f.required and n not in df.columns]
        if missing:
            raise SchemaError(f'missing required columns: {missing}')
        if self.strict:
            unknown = [c for c in df.columns if c not in self.fields]
            if unknown:
                raise SchemaError(f'unexpected columns: {unknown}')
        out = df.copy()
        for name, fld in self.fields.items():
            if name in out.columns:
                out[name] = fld.validate(name, out[name])
        # Canonical ordering: declared columns first (present ones), then extras.
        ordered = [n for n in self.fields if n in out.columns]
        extras = [c for c in out.columns if c not in self.fields]
        return out[ordered + extras]

    def is_valid(self, df: 'pd.DataFrame') -> bool:
        """Return whether ``df`` satisfies the schema."""
        try:
            self.validate(df)
            return True
        except SchemaError:
            return False


def numeric_dtype_kind(dtype: Any) -> str:
    """Classify a dtype as 'int', 'float', 'bool' or 'other' (packing helper)."""
    dt = np.dtype(dtype) if not isinstance(dtype, np.dtype) else dtype
    if dt.kind in 'iu':
        return 'int'
    if dt.kind == 'f':
        return 'float'
    if dt.kind == 'b':
        return 'bool'
    return 'other'
