"""Exposition formats for a :class:`~socceraction_tpu_torch.obs.metrics.RegistrySnapshot`.

A copy of the JAX package's ``socceraction_tpu/obs/export.py``: for the
same snapshot both packages render the same strings.

- :func:`prometheus_text` — Prometheus text exposition (version 0.0.4):
  ``# HELP``/``# TYPE`` headers, counters suffixed ``_total``, histograms
  as cumulative ``_bucket{le=...}`` rows plus ``_sum``/``_count``. Metric
  names translate from the registry's ``area/stage`` convention by
  ``/ → _`` with the unit appended per Prometheus naming practice
  (``pipeline/stage_seconds`` stays ``pipeline_stage_seconds``;
  ``pipeline/feed_queue_depth`` (unit ``chunks``) becomes
  ``pipeline_feed_queue_depth_chunks``).
- :func:`snapshot_dict` — a plain-JSON rendering of the typed snapshot
  (for artifacts and the ``obs.jsonl`` ``metrics`` events).
- :func:`timer_report_compat` — the legacy ``timer_report()`` shape
  (``{name: {count, total, mean, max, unit, total_s, mean_s, max_s}}``);
  the ``*_s`` keys are deprecated aliases that are only unit-correct for
  seconds series.

Both renderings emit deterministically in sorted ``(name, labels)``
order — instruments are name-sorted by the registry snapshot, series
label-sorted here — so scrape diffs and golden tests are stable across
runs and dict-ordering changes.
"""

from __future__ import annotations

import math
from typing import Any, Dict, List, Mapping, Optional, Tuple

from .metrics import (
    InstrumentSnapshot,
    RegistrySnapshot,
    SeriesSnapshot,
)

__all__ = ['prometheus_text', 'snapshot_dict', 'timer_report_compat']


def _sorted_series(inst: InstrumentSnapshot) -> Tuple[SeriesSnapshot, ...]:
    """An instrument's series in sorted ``labels`` order.

    Series are stored in first-use order, which depends on runtime
    arrival — two runs of the same workload (or one run before/after a
    dict-ordering change) would otherwise emit the same series in
    different orders, making scrape diffs and golden tests flap.
    Together with the registry snapshot's name-sorted instruments, this
    makes both expositions deterministic in (name, labels).
    """
    return tuple(
        sorted(inst.series, key=lambda s: sorted(s.labels.items()))
    )

#: units already spelled out by the convention's trailing name segment —
#: appending them again would produce ``_seconds_seconds``
_UNIT_SUFFIXES = {
    's': 'seconds',
    'count': 'total',  # counters get _total via the kind rule instead
    'value': '',  # dimensionless gauges carry no unit suffix
}


def _prom_name(name: str, unit: str, kind: str) -> str:
    base = name.replace('/', '_')
    suffix = _UNIT_SUFFIXES.get(unit, unit.replace('/', '_per_'))
    if suffix and unit != 'count' and not base.endswith('_' + suffix):
        base += '_' + suffix
    if kind == 'counter' and not base.endswith('_total'):
        base += '_total'
    return base


def _prom_unit(unit: str) -> str:
    """The exposition unit token of a registry unit ('' when unitless)."""
    if unit in ('count', 'value', ''):
        return ''  # event counts and dimensionless gauges carry no unit
    return _UNIT_SUFFIXES.get(unit, unit.replace('/', '_per_'))


def _prom_header(
    pname: str,
    name: str,
    unit: str,
    kind: str,
    help_text: str = '',
    type_token: Optional[str] = None,
) -> List[str]:
    """``# HELP`` / ``# TYPE`` / ``# UNIT`` comment lines for one metric.

    The ``# UNIT`` line (OpenMetrics) is derived from the instrument's
    unit metadata, so scrapers see the declared unit even when a name
    predates the unit-suffix convention; unitless instruments emit none.
    Shared by the full live exposition and ``obsctl prom``'s compact
    re-rendering (which passes ``type_token='summary'`` for histograms:
    no bucket rows survive snapshot embedding) so the two cannot drift.
    """
    lines = [
        f'# HELP {pname} {help_text or f"{name} ({unit})"}',
        f'# TYPE {pname} '
        + (type_token or ('histogram' if kind == 'histogram' else kind)),
    ]
    unit_token = _prom_unit(unit)
    if unit_token:
        lines.append(f'# UNIT {pname} {unit_token}')
    return lines


def _prom_escape(value: str) -> str:
    """Label-value escaping per the text-format spec: ``\\``, ``"``, LF."""
    return (
        value.replace('\\', '\\\\').replace('"', '\\"').replace('\n', '\\n')
    )


def _prom_labels(labels: Mapping[str, str], extra: str = '') -> str:
    parts = [
        f'{k}="{_prom_escape(v)}"' for k, v in sorted(labels.items())
    ]
    if extra:
        parts.append(extra)
    return '{' + ','.join(parts) + '}' if parts else ''


def _prom_float(v: float) -> str:
    if math.isinf(v):
        return '+Inf' if v > 0 else '-Inf'
    if math.isnan(v):
        return 'NaN'
    return repr(float(v))


def prometheus_text(snapshot: RegistrySnapshot) -> str:
    """Render the snapshot as Prometheus text exposition."""
    lines: List[str] = []
    for name, inst in snapshot.instruments.items():
        pname = _prom_name(name, inst.unit, inst.kind)
        lines.extend(
            _prom_header(pname, name, inst.unit, inst.kind, inst.help)
        )
        for s in _sorted_series(inst):
            labels = _prom_labels(s.labels)
            if inst.kind == 'histogram':
                for le, cum in s.buckets or ():
                    lines.append(
                        f'{pname}_bucket'
                        + _prom_labels(s.labels, f'le="{_prom_float(le)}"')
                        + f' {cum}'
                    )
                lines.append(f'{pname}_sum{labels} {_prom_float(s.total)}')
                lines.append(f'{pname}_count{labels} {s.count}')
            elif inst.kind == 'counter':
                lines.append(f'{pname}{labels} {_prom_float(s.total)}')
            else:  # gauge: the level is the last sample
                value = s.last if s.count else 0.0
                lines.append(f'{pname}{labels} {_prom_float(value)}')
    return '\n'.join(lines) + '\n'


def _series_dict(s: SeriesSnapshot, buckets: bool) -> Dict[str, Any]:
    out: Dict[str, Any] = {
        'labels': dict(s.labels),
        'count': s.count,
        'total': s.total,
        'mean': s.mean,
        'min': None if math.isnan(s.min) else s.min,
        'max': None if math.isnan(s.max) else s.max,
        'last': None if math.isnan(s.last) else s.last,
    }
    if s.quantiles is not None:
        out['quantiles'] = dict(s.quantiles)
    if s.exemplar is not None:
        out['exemplar'] = dict(s.exemplar)
    if buckets and s.buckets is not None:
        out['buckets'] = [
            {'le': ('+Inf' if math.isinf(le) else le), 'count': cum}
            for le, cum in s.buckets
        ]
    return out


def snapshot_dict(
    snapshot: RegistrySnapshot, *, buckets: bool = True
) -> Dict[str, Any]:
    """JSON-serializable rendering of the typed snapshot.

    ``buckets=False`` drops the per-bucket rows (keeping count/sum/max
    and the quantile estimates) for compact artifact embedding.
    """
    return {
        name: {
            'kind': inst.kind,
            'unit': inst.unit,
            'series': [
                _series_dict(s, buckets) for s in _sorted_series(inst)
            ],
        }
        for name, inst in snapshot.instruments.items()
    }


def timer_report_compat(
    snapshot: RegistrySnapshot,
    names: Optional[Mapping[str, Any]] = None,
) -> Dict[str, Dict[str, float]]:
    """The legacy flat ``timer_report()`` shape from a typed snapshot.

    ``names`` maps report keys to either an instrument name (unlabeled
    series) or a ``(instrument, labels_dict)`` pair; omitted, every
    unlabeled series reports under its instrument name. Entries carry the
    unit-correct ``count/total/mean/max`` keys plus a ``unit`` field; the
    old ``total_s``/``mean_s``/``max_s`` keys ride along as deprecated
    aliases (only actually seconds when ``unit == 's'``).
    """
    out: Dict[str, Dict[str, float]] = {}

    def add(key: str, unit: str, s: Optional[SeriesSnapshot]) -> None:
        if s is None or s.count == 0:
            return
        mx = 0.0 if math.isnan(s.max) else s.max
        out[key] = {
            'count': s.count,
            'total': s.total,
            'mean': s.mean,
            'max': mx,
            'unit': unit,
            # deprecated aliases (pre-obs key names)
            'total_s': s.total,
            'mean_s': s.mean,
            'max_s': mx,
        }

    if names is None:
        for name, inst in snapshot.instruments.items():
            add(name, inst.unit, inst.series_for())
        return dict(sorted(out.items()))

    for key, spec in names.items():
        if isinstance(spec, tuple):
            inst_name, labels = spec
        else:
            inst_name, labels = spec, {}
        inst = snapshot.get(inst_name)
        if inst is None:
            continue
        add(key, inst.unit, inst.series_for(**labels))
    return dict(sorted(out.items()))
