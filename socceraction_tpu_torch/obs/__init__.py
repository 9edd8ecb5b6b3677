"""Telemetry of the port: typed metrics, spans and the residency ledger.

Copies and ports of the JAX package's ``socceraction_tpu/obs``:
:mod:`.metrics` (the registry, stdlib only), :mod:`.trace` (spans) and
the ledger half of :mod:`.residency`. Metric names are the JAX
package's (``pipeline/stage_seconds`` with its ``stage`` label,
``pipeline/feed_queue_depth``, ``resil/*``, ``scenario/*``,
``mem/owned_bytes``).
"""

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
from .residency import Claim, claim_bytes, owned_bytes
from .trace import Span, current_span, span

__all__ = [
    'NAME_RE',
    'REGISTRY',
    'CardinalityError',
    'Claim',
    'Counter',
    'Gauge',
    'Histogram',
    'MetricRegistry',
    'RegistrySnapshot',
    'Span',
    'claim_bytes',
    'counter',
    'current_span',
    'gauge',
    'histogram',
    'owned_bytes',
    'span',
    'timed_labels',
]
