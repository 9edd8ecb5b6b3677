"""Cross-process snapshot wire format: versioned encode/decode + merge.

A copy of the JAX package's ``socceraction_tpu/obs/wire.py``: a document
either package encodes, the other decodes and merges, so one aggregator
can watch replicas of both side by side. Every other telemetry surface
describes ONE process (the registry snapshot, the SLO windows, the parity
histograms); a deployment that runs one replica process per card needs
their telemetry as one fleet picture. This module is the wire half of
that plane:

- :func:`encode_snapshot` — wrap a typed registry snapshot (or an
  already-rendered :func:`~socceraction_tpu_torch.obs.export.snapshot_dict`)
  into a **versioned, self-describing** wire document: format version,
  replica id, capture time, and the metrics payload. The payload is
  exactly ``snapshot_dict(snapshot)``, so a wire round trip can never
  drift from the run-log rendering.
- :func:`decode_snapshot` — validate a wire document (JSON text or
  dict). The version policy is minimum-reader style, like the
  checkpoint format: a document stamped **newer** than
  :data:`WIRE_VERSION` fails with an actionable "newer than this
  library" error; older same-shape versions keep decoding.
- :func:`merge_wires` — merge N replica documents into one fleet
  snapshot with **per-kind semantics**:

  - *counters* sum exactly (count and total — a fleet request total is
    the sum of the replicas' totals, to the unit);
  - *gauges* are levels, which do not sum — each series instead gains a
    ``replica`` label, so the fleet snapshot holds every replica's
    level side by side. Replica ids come from the bounded
    :class:`ReplicaRegistry`, never free-form strings;
  - *histograms* merge bucket-wise with exact count/sum preservation
    (identical bucket boundaries are required — they are fixed by
    construction, and equal in both packages — and a mismatch is a loud
    error); quantile estimates are recomputed over the merged buckets
    with the same estimator a single series uses
    (:func:`~socceraction_tpu_torch.obs.metrics.quantile_estimate`), so
    the merged p99 equals the estimate over the concatenated raw stream;
  - *exemplars* keep the newest by timestamp (the most recent request
    id anywhere in the fleet is the one an operator wants to trace).

- :func:`typed_snapshot_from_dict` — rebuild a typed
  :class:`~socceraction_tpu_torch.obs.metrics.RegistrySnapshot` from a
  snapshot dict, so snapshot-typed consumers (the SLO burn-rate engine)
  can evaluate over a *merged fleet* snapshot exactly as they do over a
  live registry.

Stdlib only: the module imports neither torch nor jax.
"""

from __future__ import annotations

import json
import math
import re
import threading
import time
from typing import Any, Dict, List, Mapping, Optional, Sequence, Tuple, Union

from .export import snapshot_dict
from .metrics import (
    _QUANTILES,
    InstrumentSnapshot,
    RegistrySnapshot,
    SeriesSnapshot,
    quantile_estimate,
)

__all__ = [
    'REPLICAS',
    'ReplicaRegistry',
    'WIRE_VERSION',
    'WireError',
    'decode_snapshot',
    'encode_snapshot',
    'merge_wires',
    'typed_snapshot_from_dict',
]

#: Wire format version, minimum-reader style (the checkpoint-format
#: policy): bump it ONLY when a change breaks existing readers; readers
#: accept documents stamped <= their own version and refuse newer ones
#: with an actionable error. Additive fields ride along un-bumped.
WIRE_VERSION = 1

#: replica-id shape: short, lowercase, Prometheus-label-safe — an id is
#: a *name* for a process slot, never a free-form string
_REPLICA_RE = re.compile(r'^[a-z0-9][a-z0-9_.-]{0,63}$')


class WireError(ValueError):
    """A malformed, version-incompatible or unmergeable wire document."""


class ReplicaRegistry:
    """Bounded registry of known replica ids — the cardinality contract.

    The merged fleet snapshot labels gauge series by ``replica``; an
    unbounded id space (a pod hash, a timestamp) would mint unbounded
    series exactly the way the metric cardinality guard exists to
    prevent. Every id that enters a wire document must be registered
    here first: :meth:`register` validates the shape and enforces the
    budget, so a leaked free-form string fails loudly at encode/merge
    time instead of flooding the fleet exposition.
    """

    def __init__(self, max_replicas: int = 64) -> None:
        self.max_replicas = int(max_replicas)
        self._lock = threading.Lock()
        self._ids: Dict[str, None] = {}

    def register(self, replica_id: str) -> str:
        """Validate and admit one replica id (idempotent); returns it."""
        if not isinstance(replica_id, str) or not _REPLICA_RE.match(replica_id):
            raise WireError(
                f'invalid replica id {replica_id!r} (want lowercase '
                '[a-z0-9][a-z0-9_.-]*, at most 64 chars — a stable slot '
                'name, not a free-form string)'
            )
        with self._lock:
            if replica_id not in self._ids:
                if len(self._ids) >= self.max_replicas:
                    raise WireError(
                        f'replica registry full ({self.max_replicas} ids); '
                        f'{replica_id!r} rejected — replica ids must be a '
                        'bounded set of process slots, not per-instance '
                        'strings'
                    )
                self._ids[replica_id] = None
        return replica_id

    def known(self) -> Tuple[str, ...]:
        """The registered ids, in registration order."""
        with self._lock:
            return tuple(self._ids)

    def __contains__(self, replica_id: object) -> bool:
        with self._lock:
            return replica_id in self._ids


#: The process-default replica-id registry (encode/merge use it unless
#: a caller passes an explicit one).
REPLICAS = ReplicaRegistry()


def encode_snapshot(
    snapshot: Union[RegistrySnapshot, Mapping[str, Any]],
    *,
    replica: str,
    registry: Optional[ReplicaRegistry] = None,
    time_unix: Optional[float] = None,
) -> Dict[str, Any]:
    """One replica's registry snapshot as a versioned wire document.

    ``snapshot`` is a typed :class:`RegistrySnapshot` (rendered through
    :func:`snapshot_dict`, buckets included — the merge needs them) or
    an already-rendered snapshot dict (the post-mortem path: a run
    log's embedded ``metrics`` event). The document is plain JSON.
    """
    reg = registry if registry is not None else REPLICAS
    reg.register(replica)
    if isinstance(snapshot, RegistrySnapshot):
        metrics = snapshot_dict(snapshot, buckets=True)
    else:
        metrics = {name: dict(inst) for name, inst in snapshot.items()}
    return {
        'wire_version': WIRE_VERSION,
        'replica': replica,
        'time_unix': time.time() if time_unix is None else float(time_unix),
        'metrics': metrics,
    }


def decode_snapshot(wire: Union[str, bytes, Mapping[str, Any]]) -> Dict[str, Any]:
    """Validate a wire document; returns it as a plain dict.

    Accepts JSON text/bytes or an already-parsed mapping. The decoded
    document's ``metrics`` payload is bit-exact ``snapshot_dict``
    output — ``decode_snapshot(encode_snapshot(snap, ...))['metrics']
    == snapshot_dict(snap)`` is pinned.
    """
    if isinstance(wire, (str, bytes)):
        try:
            wire = json.loads(wire)
        except json.JSONDecodeError as e:
            raise WireError(f'wire document is not valid JSON: {e}') from None
    if not isinstance(wire, Mapping):
        raise WireError(
            f'wire document must be a mapping, got {type(wire).__name__}'
        )
    version = wire.get('wire_version')
    if not isinstance(version, int):
        raise WireError(
            "wire document carries no integer 'wire_version' (not a "
            'telemetry snapshot?)'
        )
    if version > WIRE_VERSION:
        raise WireError(
            f'wire document version {version} is newer than this library '
            f'(reads <= {WIRE_VERSION}); upgrade the reader'
        )
    for key in ('replica', 'metrics'):
        if key not in wire:
            raise WireError(f'wire document is missing {key!r}')
    if not isinstance(wire['metrics'], Mapping):
        raise WireError("wire 'metrics' must be a snapshot mapping")
    return dict(wire)


# -- merge ------------------------------------------------------------------


def _label_key(labels: Mapping[str, Any]) -> Tuple[Tuple[str, str], ...]:
    return tuple(sorted((str(k), str(v)) for k, v in labels.items()))


def _merge_minmax(a: Optional[float], b: Optional[float], fn: Any) -> Optional[float]:
    if a is None:
        return b
    if b is None:
        return a
    return fn(a, b)


def _newer_exemplar(
    a: Optional[Mapping[str, Any]], b: Optional[Mapping[str, Any]]
) -> Optional[Dict[str, Any]]:
    """The newest-by-``ts`` exemplar of the two (None-tolerant)."""
    if a is None:
        return dict(b) if b is not None else None
    if b is None:
        return dict(a)
    return dict(b) if float(b.get('ts') or 0.0) >= float(a.get('ts') or 0.0) else dict(a)


def _merge_buckets(
    name: str,
    into: Optional[List[Dict[str, Any]]],
    add: Optional[Sequence[Mapping[str, Any]]],
) -> Optional[List[Dict[str, Any]]]:
    """Sum two cumulative bucket lists positionally (boundaries must match).

    Bucket counts are cumulative per the snapshot shape; the sum of
    cumulative counts IS the cumulative count of the summed streams, so
    the merge is exact. Boundaries are fixed by construction
    (``DEFAULT_BUCKETS``, or one shared explicit tuple per instrument);
    two replicas disagreeing on them means skewed code, which must be a
    loud error, never a silently re-binned histogram.
    """
    if add is None:
        return into
    if into is None:
        return [dict(b) for b in add]
    if len(into) != len(add) or any(
        a['le'] != b['le'] for a, b in zip(into, add)
    ):
        raise WireError(
            f'{name}: bucket boundaries differ between replicas — '
            'histograms only merge bucket-wise over identical bounds '
            '(are the replicas running the same code?)'
        )
    for a, b in zip(into, add):
        a['count'] = int(a['count']) + int(b['count'])
    return into


def _series_quantiles(series: Dict[str, Any]) -> Optional[Dict[str, float]]:
    """Recompute quantile estimates from a merged series' buckets."""
    buckets = series.get('buckets')
    count = int(series.get('count') or 0)
    if not buckets or not count:
        return None
    bounds = tuple(
        float(b['le']) for b in buckets if b['le'] != '+Inf'
    )
    cums = [int(b['count']) for b in buckets]
    counts = tuple(
        c - (cums[i - 1] if i else 0) for i, c in enumerate(cums)
    )
    min_v = series.get('min')
    max_v = series.get('max')
    min_v = math.nan if min_v is None else float(min_v)
    max_v = math.nan if max_v is None else float(max_v)
    return {
        f'p{int(q * 100)}': quantile_estimate(
            bounds, counts, count, min_v, max_v, q
        )
        for q in _QUANTILES
    }


def merge_wires(
    wires: Sequence[Mapping[str, Any]],
    *,
    registry: Optional[ReplicaRegistry] = None,
) -> Dict[str, Any]:
    """Merge N replica wire documents into one fleet snapshot dict.

    Returns a snapshot-dict-shaped mapping (the same shape
    :func:`snapshot_dict` renders, consumable by
    :func:`typed_snapshot_from_dict` and the exporters) where counters
    summed, gauges carry a ``replica`` label, histograms merged
    bucket-wise and exemplars kept the newest. Instruments appearing on
    only some replicas merge from those replicas alone. ``last`` comes
    from the newest document (by ``time_unix``) carrying the series.

    Compact payloads (a run log's embedded ``buckets=False`` snapshot)
    merge count/total/min/max exactly but drop the quantile estimates —
    there is nothing exact to recompute them from; divergence and
    staleness still work, and the live scrape path always ships full
    buckets.
    """
    reg = registry if registry is not None else REPLICAS
    docs = [decode_snapshot(w) for w in wires]
    for doc in docs:
        reg.register(str(doc['replica']))
    # oldest -> newest so later assignments ('last', gauge re-ingest of a
    # re-merged doc) deterministically favor the newest document
    docs.sort(key=lambda d: float(d.get('time_unix') or 0.0))
    merged: Dict[str, Dict[str, Any]] = {}
    kinds: Dict[str, Tuple[str, str, str]] = {}  # name -> (kind, unit, replica)
    for doc in docs:
        replica = str(doc['replica'])
        for name, inst in doc['metrics'].items():
            kind = str(inst.get('kind') or 'gauge')
            unit = str(inst.get('unit') or '')
            seen = kinds.get(name)
            if seen is None:
                kinds[name] = (kind, unit, replica)
            elif (kind, unit) != seen[:2]:
                raise WireError(
                    f'{name}: replica {replica!r} reports '
                    f'{kind}(unit={unit!r}) but replica {seen[2]!r} '
                    f'reported {seen[0]}(unit={seen[1]!r}) — the fleet '
                    'cannot merge conflicting instrument definitions'
                )
            out = merged.setdefault(
                name, {'kind': kind, 'unit': unit, '_series': {}}
            )
            for series in inst.get('series', ()):
                labels = dict(series.get('labels') or {})
                if kind == 'gauge' and 'replica' not in labels:
                    # levels do not sum: one series per replica instead
                    labels['replica'] = replica
                key = _label_key(labels)
                entry = out['_series'].get(key)
                if entry is None:
                    entry = out['_series'][key] = {
                        'labels': labels,
                        'count': 0,
                        'total': 0.0,
                        'min': None,
                        'max': None,
                        'last': None,
                        '_exemplar': None,
                        '_buckets': None,
                        '_has_buckets': True,
                    }
                entry['count'] += int(series.get('count') or 0)
                entry['total'] += float(series.get('total') or 0.0)
                entry['min'] = _merge_minmax(entry['min'], series.get('min'), min)
                entry['max'] = _merge_minmax(entry['max'], series.get('max'), max)
                if series.get('last') is not None:
                    entry['last'] = series['last']
                entry['_exemplar'] = _newer_exemplar(
                    entry['_exemplar'], series.get('exemplar')
                )
                if kind == 'histogram':
                    if series.get('buckets') is None:
                        entry['_has_buckets'] = False
                    else:
                        entry['_buckets'] = _merge_buckets(
                            name, entry['_buckets'], series['buckets']
                        )
    out_snapshot: Dict[str, Any] = {}
    for name in sorted(merged):
        inst = merged[name]
        series_rows = []
        for key in sorted(inst['_series']):
            entry = inst['_series'][key]
            row: Dict[str, Any] = {
                'labels': entry['labels'],
                'count': entry['count'],
                'total': entry['total'],
                'mean': entry['total'] / entry['count'] if entry['count'] else 0.0,
                'min': entry['min'],
                'max': entry['max'],
                'last': entry['last'],
            }
            if inst['kind'] == 'histogram' and entry['_has_buckets']:
                row['buckets'] = entry['_buckets'] or []
                quantiles = _series_quantiles(row)
                if quantiles is not None:
                    row['quantiles'] = quantiles
            if entry['_exemplar'] is not None:
                row['exemplar'] = entry['_exemplar']
            series_rows.append(row)
        out_snapshot[name] = {
            'kind': inst['kind'],
            'unit': inst['unit'],
            'series': series_rows,
        }
    return out_snapshot


# -- typed reconstruction ---------------------------------------------------


def _series_from_dict(row: Mapping[str, Any]) -> SeriesSnapshot:
    buckets = row.get('buckets')
    typed_buckets = None
    if buckets is not None:
        typed_buckets = tuple(
            (
                math.inf if b['le'] == '+Inf' else float(b['le']),
                int(b['count']),
            )
            for b in buckets
        )
    quantiles = row.get('quantiles')

    def _num(value: Any) -> float:
        return math.nan if value is None else float(value)

    return SeriesSnapshot(
        labels=dict(row.get('labels') or {}),
        count=int(row.get('count') or 0),
        total=float(row.get('total') or 0.0),
        min=_num(row.get('min')),
        max=_num(row.get('max')),
        last=_num(row.get('last')),
        buckets=typed_buckets,
        quantiles=dict(quantiles) if quantiles is not None else None,
        exemplar=(
            dict(row['exemplar']) if row.get('exemplar') is not None else None
        ),
    )


def typed_snapshot_from_dict(
    snapshot: Mapping[str, Any],
) -> RegistrySnapshot:
    """Rebuild a typed :class:`RegistrySnapshot` from a snapshot dict.

    The inverse of :func:`snapshot_dict` up to the lossy bits the dict
    never carried (``help`` text is empty; a ``buckets=False`` compact
    dict rebuilds bucket-less series). This is how snapshot-typed
    consumers — the SLO burn-rate engine above all — evaluate over a
    merged *fleet* snapshot with the same code that reads a live
    process registry.
    """
    return RegistrySnapshot(
        instruments={
            name: InstrumentSnapshot(
                name=name,
                kind=str(inst.get('kind') or 'gauge'),
                unit=str(inst.get('unit') or ''),
                help='',
                series=tuple(
                    _series_from_dict(row) for row in inst.get('series', ())
                ),
            )
            for name, inst in sorted(snapshot.items())
        }
    )
