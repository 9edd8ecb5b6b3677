"""In-dispatch numeric health guards: finite checks as runtime signals.

Port of the JAX package's ``socceraction_tpu/obs/numerics.py``. A NaN in
a served head, or a diverging retrain, gives wrong answers with healthy
telemetry unless something counts it. This module makes numeric health a
measured runtime signal:

- **in-dispatch guard reductions** — :func:`nonfinite_count` /
  :func:`overflow_count` reduce tensors the dispatch already produced to
  a 0-d int32 count on the card, on the dispatch's own stream. The
  guarded values are untouched.
- **deferred, sync-free recording** — a hot path never waits for a
  guard: :func:`note_guard` stores the device count in a bounded pending
  ring together with a CUDA event recorded after it, and returns at
  once. :func:`drain_guards` converts only the entries whose event has
  completed (``query()``), leaving the rest pending, so a drain never
  blocks on the card; nonzero counts land in the governed ``num/*``
  metrics plus a ``nonfinite_detected`` event (run log + flight
  recorder). Call it where the dispatch's results have reached the host
  (after ``values.cpu()``): the stream is in order, so every entry is
  ready by then.
- **host-side recording** — :func:`record_nonfinite` /
  :func:`record_overflow` for paths whose outputs are already on the
  host (the xT fit's certificate, the trainer's health scalars).

Metrics (area ``num``; the JAX package's names and labels):

| metric | kind | labels | meaning |
|---|---|---|---|
| ``num/nonfinite_total`` | counter | ``fn``, ``output`` | nonfinite values detected per guarded output |
| ``num/overflow_guard_total`` | counter | ``fn`` | finite values past the magnitude guard (logits beyond f32 ``exp`` saturation) |
| ``num/guard_drops`` | counter | — | pending guards evicted before a drain |

``SOCCERACTION_TPU_NUM_GUARDS=0`` turns the guards of the fused pair
dispatch off, as in the JAX package (whose sequence-head dispatch counts
whatever the flag says, as this one's does).
"""

from __future__ import annotations

import os
import threading
from collections import deque
from typing import Any, Dict, List, NamedTuple, Optional

from .metrics import REGISTRY

__all__ = [
    'GuardEvent',
    'LOGIT_OVERFLOW_LIMIT',
    'clear_pending',
    'drain_guards',
    'guards_enabled',
    'nonfinite_count',
    'nonfinite_total',
    'note_guard',
    'overflow_count',
    'pending_guards',
    'record_health_event',
    'record_nonfinite',
    'record_overflow',
]

#: Environment flag: ``0`` disables the in-dispatch guards.
NUM_GUARDS_ENV = 'SOCCERACTION_TPU_NUM_GUARDS'

#: Magnitude guard for pre-sigmoid logits: past ``exp(±88)`` an f32
#: sigmoid saturates to exactly 0/1 — still finite, but a red flag for
#: blown-up weights that :func:`overflow_count` makes visible before the
#: probabilities go NaN.
LOGIT_OVERFLOW_LIMIT = 88.0


def guards_enabled() -> bool:
    """Whether the in-dispatch guards run."""
    return os.environ.get(NUM_GUARDS_ENV, '1') != '0'


# -- in-dispatch reductions ----------------------------------------------------


def nonfinite_count(*tensors: Any) -> Any:
    """Total count of non-finite elements across ``tensors``: a 0-d int32
    tensor on their device, computed on the current stream (no host read)."""
    import torch

    counts = [(~torch.isfinite(x)).sum(dtype=torch.int32) for x in tensors]
    return torch.stack(counts).sum(dtype=torch.int32)


def overflow_count(*tensors: Any, limit: float = LOGIT_OVERFLOW_LIMIT) -> Any:
    """Count of elements with ``|x| > limit`` (0-d int32, on the device).

    ``±Inf`` counts — it is the saturation signal's terminal case — while
    NaN does not (``|NaN| > limit`` is False by IEEE comparison; NaN is
    the *nonfinite* guard's signal).
    """
    import torch

    counts = [(x.abs() > limit).sum(dtype=torch.int32) for x in tensors]
    return torch.stack(counts).sum(dtype=torch.int32)


# -- pending ring + recording --------------------------------------------------


class GuardEvent(NamedTuple):
    """One drained nonzero guard observation."""

    fn: str
    output: str
    kind: str  # 'nonfinite' | 'overflow'
    count: int

    def to_dict(self) -> Dict[str, Any]:
        """JSON-ready payload (the ``nonfinite_detected`` event body).

        ``guard_kind``, not ``kind``: the payload rides into
        ``FlightRecorder.record(kind=...)``, whose event-type key a
        field named ``kind`` would collide with.
        """
        return {
            'fn': self.fn,
            'output': self.output,
            'guard_kind': self.kind,
            'count': self.count,
        }


class _PendingGuards:
    """Bounded ring of ``(fn, output, kind, count, ready event)`` entries.

    The hot path appends (no host read); a drain converts the entries
    whose event has completed and records them. The bound keeps
    unharvested guards (``rate_batch`` users who never drain) from
    holding device memory without limit: a full ring evicts its oldest
    entry and counts the drop.
    """

    def __init__(self, capacity: int = 256) -> None:
        self._lock = threading.Lock()
        self._ring: 'deque' = deque(maxlen=int(capacity))
        self.dropped = 0

    def note(self, fn: str, output: str, kind: str, value: Any) -> None:
        event = None
        device = getattr(value, 'device', None)
        if device is not None and device.type == 'cuda':
            import torch

            event = torch.cuda.Event()
            event.record(torch.cuda.current_stream(device))
        with self._lock:
            if len(self._ring) == self._ring.maxlen:
                self.dropped += 1
                REGISTRY.counter('num/guard_drops', unit='count').inc(1)
            self._ring.append((fn, output, kind, value, event))

    def drain(self) -> List[GuardEvent]:
        ready, waiting = [], []
        with self._lock:
            for entry in self._ring:
                event = entry[4]
                (ready if event is None or event.query() else waiting).append(entry)
            self._ring = deque(waiting, maxlen=self._ring.maxlen)
        events: List[Optional[GuardEvent]] = []
        for (fn, output, kind, _value, _event), n in zip(ready, _host_counts(ready)):
            if n <= 0:
                continue
            if kind == 'overflow':
                events.append(record_overflow(fn, n, output=output))
            else:
                events.append(record_nonfinite(fn, output, n))
        return [e for e in events if e is not None]

    def clear(self) -> None:
        with self._lock:
            self._ring.clear()
            self.dropped = 0

    def __len__(self) -> int:
        with self._lock:
            return len(self._ring)


_READ_STREAMS: Dict[Any, Any] = {}


def _host_counts(entries: List[tuple]) -> List[int]:
    """The counts of ready ring entries as host ints.

    Card counts are copied on a stream of the drain's own: their events
    have completed, so the copy waits for nothing else, where a read on
    the current stream would wait for whatever was queued there since.
    """
    counts: List[Any] = [entry[3] for entry in entries]
    on_card: Dict[Any, List[int]] = {}
    for i, value in enumerate(counts):
        device = getattr(value, 'device', None)
        if device is not None and device.type == 'cuda':
            on_card.setdefault(device, []).append(i)
        else:
            counts[i] = int(value)
    if on_card:
        import torch

        for device, idx in on_card.items():
            stream = _READ_STREAMS.get(device)
            if stream is None:
                stream = _READ_STREAMS[device] = torch.cuda.Stream(device)
            with torch.cuda.stream(stream):
                host = torch.stack([counts[i] for i in idx]).cpu().tolist()
            for i, n in zip(idx, host):
                counts[i] = int(n)
    return counts


_PENDING = _PendingGuards()


def note_guard(fn: str, output: str, value: Any, kind: str = 'nonfinite') -> None:
    """Store one dispatch's guard count for a later :func:`drain_guards`.

    ``value`` is the (device or host) integer count a guarded dispatch
    produced beside its real outputs. Never reads the device.
    """
    _PENDING.note(fn, output, kind, value)


def drain_guards() -> List[GuardEvent]:
    """Convert the pending guard counts that are ready; record and return
    the nonzero ones. Entries whose dispatch has not finished stay
    pending: a drain never blocks on the card."""
    return _PENDING.drain()


def pending_guards() -> int:
    """Guard counts noted but not yet drained (introspection/tests)."""
    return len(_PENDING)


def clear_pending() -> None:
    """Discard pending guards without recording (test isolation)."""
    _PENDING.clear()


def record_health_event(event_type: str, payload: Dict[str, Any]) -> None:
    """Land one numeric-health event in the flight recorder and the run log.

    The one fan-out both numeric-health producers share (guard drains
    record ``nonfinite_detected``, the parity probe
    ``parity_exceeded``). Never raises into a hot path.
    """
    from .recorder import RECORDER
    from .trace import current_runlog

    try:
        RECORDER.record(event_type, **payload)
        log = current_runlog()
        if log is not None:
            log.event(event_type, **payload)
    except Exception:
        pass  # telemetry of telemetry must never raise into a hot path


def _record_event(event: GuardEvent) -> None:
    record_health_event('nonfinite_detected', event.to_dict())


def record_nonfinite(fn: str, output: str, n: int) -> Optional[GuardEvent]:
    """Record ``n`` nonfinite values observed in ``fn``'s ``output``.

    ``n <= 0`` is a no-op (healthy dispatches cost nothing). Returns the
    recorded event, or None.
    """
    n = int(n)
    if n <= 0:
        return None
    REGISTRY.counter('num/nonfinite_total', unit='count').inc(
        n, fn=fn, output=output
    )
    event = GuardEvent(fn=fn, output=output, kind='nonfinite', count=n)
    _record_event(event)
    return event


def record_overflow(
    fn: str, n: int, output: str = 'logits'
) -> Optional[GuardEvent]:
    """Record ``n`` finite-but-overflowing values observed in ``fn``."""
    n = int(n)
    if n <= 0:
        return None
    REGISTRY.counter('num/overflow_guard_total', unit='count').inc(n, fn=fn)
    event = GuardEvent(fn=fn, output=output, kind='overflow', count=n)
    _record_event(event)
    return event


def nonfinite_total() -> float:
    """Process-lifetime total of detected nonfinite values (all guards)."""
    snap = REGISTRY.snapshot().get('num/nonfinite_total')
    if snap is None:
        return 0.0
    return float(sum(s.total for s in snap.series))
