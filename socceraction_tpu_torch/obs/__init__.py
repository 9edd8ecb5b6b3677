"""Observability of the port: metrics, spans, run logs, guards and exporters.

Copies and ports of the JAX package's ``socceraction_tpu/obs`` (metric
names, label keys, event types and file formats are that package's, so
one dashboard and one run-log reader serve both):

- :mod:`.metrics` — typed ``Counter``/``Gauge``/``Histogram`` instruments
  with low-cardinality labels in a thread-safe registry
  (:data:`REGISTRY`), plus the typed snapshot API.
- :mod:`.trace` — nestable :func:`span` timing contexts (under
  ``torch.profiler.record_function``) and the :class:`RunLog` JSONL sink
  (manifest, span events, metric snapshots, rotation).
- :mod:`.context` — request-scoped trace contexts for the serving layer.
- :mod:`.slo` — the SLO engine: objectives, multi-window burn rates and
  the ``should_shed`` verdict.
- :mod:`.export` — Prometheus-text and JSON exposition, and the legacy
  ``timer_report`` shape.
- :mod:`.dispatch` — the dispatch observatory (the JAX package's
  ``obs/xla.py``): :func:`instrument` wrappers that account each new
  argument signature, ``nvcc`` builds and analytic FLOPs/bytes, with a
  retrace-storm detector.
- :mod:`.memory` — the card's allocator gauges, span watermarks and a
  live-tensor census.
- :mod:`.recorder` — the flight recorder: a bounded event ring plus
  :func:`dump_debug_bundle`.
- :mod:`.numerics` — in-dispatch numeric guards, drained into ``num/*``
  metrics without waiting for the card.
- :mod:`.parity` — :class:`ParityProbe`, sampled re-rating through the
  reference path on a worker thread and its own CUDA stream.
- :mod:`.perf` — the live roofline against the card's peaks
  (:func:`record_dispatch`) and the device-idle detector.
- :mod:`.residency` — named-owner byte claims, reconciled against the
  census by :func:`residency_report`.
- :mod:`.coldstart` — the cold-start timeline.
- :mod:`.wire`, :mod:`.endpoint`, :mod:`.fleet` — the cross-process
  telemetry plane: the versioned snapshot document and its exact merge,
  each replica's scrape surface on a unix socket, and the aggregator that
  merges a fleet's documents, flags stale replicas and evaluates the SLO
  mesh-wide. Their names load lazily, on first access, so importing this
  package starts no HTTP machinery.

Every module imports with the standard library and numpy alone; torch is
touched only where a caller asks for device work.
"""

from typing import Any

from .coldstart import ColdstartTimeline, coldstart_report, process_start_unix
from .context import DeadlineExceeded, RequestContext, new_request_context
from .dispatch import InstrumentedFn, fn_cost, instrument, observatory_snapshot
from .export import prometheus_text, snapshot_dict, timer_report_compat
from .memory import MemorySampler, device_memory_stats, live_array_census, sample_device_memory
from .metrics import (
    NAME_RE,
    REGISTRY,
    CardinalityError,
    Counter,
    Gauge,
    Histogram,
    MetricRegistry,
    RegistrySnapshot,
    counter,
    gauge,
    histogram,
    timed_labels,
)
from .numerics import (
    GuardEvent,
    drain_guards,
    guards_enabled,
    nonfinite_count,
    note_guard,
    overflow_count,
    record_nonfinite,
    record_overflow,
)
from .parity import ParityProbe
from .perf import IdleTracker, perf_snapshot, record_dispatch
from .recorder import RECORDER, FlightRecorder, default_debug_dir, dump_debug_bundle
from .residency import Claim, claim_bytes, owned_bytes, residency_report
from .slo import SLOConfig, SLOEngine, SLOObjective
from .trace import RunLog, Span, current_runlog, current_span, run_manifest, span

#: The cross-process plane's names, by module, loaded by ``__getattr__``
#: (the JAX package's lazy homes for them).
_LAZY = {
    'wire': (
        'REPLICAS', 'ReplicaRegistry', 'WireError', 'decode_snapshot',
        'encode_snapshot', 'merge_wires', 'typed_snapshot_from_dict',
    ),
    'endpoint': (
        'Telemetry', 'TelemetryEndpoint', 'scrape', 'scrape_health',
        'serve_telemetry',
    ),
    'fleet': ('FleetAggregator', 'FleetSnapshot'),
}
_LAZY_HOME = {name: module for module, names in _LAZY.items() for name in names}

__all__ = [
    'NAME_RE',
    'CardinalityError',
    'Claim',
    'ColdstartTimeline',
    'Counter',
    'DeadlineExceeded',
    'FleetAggregator',
    'FleetSnapshot',
    'FlightRecorder',
    'Gauge',
    'Histogram',
    'IdleTracker',
    'InstrumentedFn',
    'GuardEvent',
    'MemorySampler',
    'MetricRegistry',
    'ParityProbe',
    'RECORDER',
    'REGISTRY',
    'REPLICAS',
    'RegistrySnapshot',
    'ReplicaRegistry',
    'RequestContext',
    'RunLog',
    'SLOConfig',
    'SLOEngine',
    'SLOObjective',
    'Span',
    'Telemetry',
    'TelemetryEndpoint',
    'WireError',
    'claim_bytes',
    'coldstart_report',
    'counter',
    'current_runlog',
    'current_span',
    'decode_snapshot',
    'default_debug_dir',
    'device_memory_stats',
    'drain_guards',
    'dump_debug_bundle',
    'encode_snapshot',
    'fn_cost',
    'gauge',
    'guards_enabled',
    'histogram',
    'instrument',
    'live_array_census',
    'merge_wires',
    'new_request_context',
    'nonfinite_count',
    'note_guard',
    'observatory_snapshot',
    'overflow_count',
    'owned_bytes',
    'perf_snapshot',
    'process_start_unix',
    'prometheus_text',
    'record_dispatch',
    'record_nonfinite',
    'record_overflow',
    'residency_report',
    'run_manifest',
    'sample_device_memory',
    'scrape',
    'scrape_health',
    'serve_telemetry',
    'snapshot_dict',
    'span',
    'timed_labels',
    'timer_report_compat',
    'typed_snapshot_from_dict',
]


def __getattr__(name: str) -> Any:
    module = _LAZY_HOME.get(name)
    if module is None:
        raise AttributeError(f'module {__name__!r} has no attribute {name!r}')
    import importlib

    return getattr(importlib.import_module(f'{__name__}.{module}'), name)
