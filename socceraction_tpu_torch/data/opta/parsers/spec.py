"""Declarative field-spec engine for Opta-family feed parsers.

The Opta/StatsPerform feeds are complementary files that all reduce to
the same job: walk a tree-shaped record (JSON mapping or XML attribute
dict), pull out named leaves, cast them, and assemble an output dict
keyed by the unified column names (reference behavior:
``socceraction/data/opta/parsers/*.py`` — each parser there hand-writes
the walk). Here the walk is data: a feed declares a tuple of
:class:`Field` rows (output name → source path + cast + default) and one
shared engine does the rest. New feeds are spec tables, not code.

Missing-key semantics follow the reference's ``assertget``: a source
that resolves to ``None`` (absent key anywhere along the path, or an
explicit JSON null) raises ``AssertionError`` unless the field declares
a ``default``. Defaults are **output-domain** values — they are emitted
as-is, never fed through the cast — which covers both reference idioms
(``attr.get('outcome', 1)`` → declare ``default=True``;
``int(attr['player_id']) if 'player_id' in attr else None`` → declare
``default=None``).

Port of ``socceraction_tpu/data/opta/parsers/spec.py``.
"""

from __future__ import annotations

from dataclasses import dataclass
from datetime import datetime
from typing import Any, Callable, Dict, Mapping, Optional, Sequence, Tuple, Union

__all__ = [
    'Field',
    'derived',
    'extract_record',
    'flag',
    'ref_id',
    'ts',
]


class _Required:
    """Sentinel: the field has no fallback; missing source is an error."""

    def __repr__(self) -> str:  # pragma: no cover - debug aid
        return '<REQUIRED>'


REQUIRED = _Required()


@dataclass(frozen=True)
class Field:
    """One output column of a feed record.

    Parameters
    ----------
    out : str
        Output field name (unified schema column).
    src : str or tuple of str, optional
        Key, or path of keys, into the source mapping. ``None`` only for
        derived fields.
    cast : callable, optional
        Applied to the resolved source value (``int``, ``float``,
        :func:`ts`, :func:`flag`, ...). Identity when omitted.
    default : any
        Output-domain fallback when the source is missing. When left at
        ``REQUIRED`` a missing source raises ``AssertionError`` (the
        reference's ``assertget`` contract).
    derive : callable, optional
        ``derive(record, raw) -> value`` computed from the fields
        extracted so far plus the raw source; used for cross-field
        output such as qualifier-driven end coordinates.
    """

    out: str
    src: Optional[Union[str, Tuple[str, ...]]] = None
    cast: Optional[Callable[[Any], Any]] = None
    default: Any = REQUIRED
    derive: Optional[Callable[[Dict[str, Any], Mapping[str, Any]], Any]] = None


def derived(out: str, fn: Callable[[Dict[str, Any], Mapping[str, Any]], Any]) -> Field:
    """A field computed from already-extracted fields (and the raw source)."""
    return Field(out, derive=fn)


def _resolve(raw: Mapping[str, Any], path: Union[str, Tuple[str, ...]]) -> Any:
    """Walk ``path`` into ``raw``; ``None`` when any hop is absent/null."""
    node: Any = raw
    for key in (path,) if isinstance(path, str) else path:
        if not isinstance(node, Mapping):
            return None
        node = node.get(key)
        if node is None:
            return None
    return node


def extract_record(
    raw: Mapping[str, Any],
    fields: Sequence[Field],
    seed: Optional[Dict[str, Any]] = None,
) -> Dict[str, Any]:
    """Run a spec table over one source record.

    ``seed`` pre-populates the output (context such as ``game_id`` or a
    prebuilt ``qualifiers`` dict) so spec rows and ``derive`` hooks can
    reference it.
    """
    record: Dict[str, Any] = dict(seed) if seed else {}
    for field in fields:
        if field.derive is not None:
            record[field.out] = field.derive(record, raw)
            continue
        assert field.src is not None, f'field {field.out!r} has no src and no derive'
        value = _resolve(raw, field.src)
        if value is None:
            if isinstance(field.default, _Required):
                raise AssertionError(
                    'KeyError: ' + str(field.src) + ' not found in ' + str(raw)
                )
            record[field.out] = field.default
        else:
            record[field.out] = field.cast(value) if field.cast else value
    return record


def ts(*formats: str) -> Callable[[str], datetime]:
    """Timestamp cast trying each strptime format; tz info is dropped.

    Several feeds mix sub-second and whole-second stamps in one file
    (StatsPerform MA3), hence the fallback chain. Offset-carrying
    formats (Opta F9's ``%z``) are normalized to naive datetimes, the
    reference's convention.
    """

    def parse(value: str) -> datetime:
        last: Optional[ValueError] = None
        for fmt in formats:
            try:
                return datetime.strptime(value, fmt).replace(tzinfo=None)
            except ValueError as e:
                last = e
        raise last  # type: ignore[misc]

    return parse


def flag(value: Any) -> bool:
    """Opta boolean attribute: ``'1'``/``1`` truthy, ``'0'``/``0`` falsy."""
    return bool(int(value))


def ref_id(value: str) -> int:
    """Typed Opta reference (``g1234``, ``t56``, ``p789``) → numeric id."""
    return int(value[1:])
