"""Live roofline: achieved FLOPs/bytes per dispatch + a device-idle detector.

Port of the JAX package's ``socceraction_tpu/obs/perf.py``. The dispatch
observatory (:mod:`socceraction_tpu_torch.obs.dispatch`) knows what every
hot function should cost — the analytic FLOPs and bytes of one dispatch,
worked out from its operands at its first call — and the hot paths time
their dispatches. This module connects the two:

- :func:`record_dispatch` — called with one dispatch's *host-synced*
  wall (the epoch trainer, the xT solve), it divides the function's
  cost by the measured wall into governed ``perf/*`` gauges and feeds
  the per-function idle detector:

  | metric | kind (unit) | meaning |
  |---|---|---|
  | ``perf/dispatches`` | counter (count) | dispatches seen (sampled or not) |
  | ``perf/dispatch_seconds`` | histogram (s) | sampled dispatch walls |
  | ``perf/achieved_flops`` | gauge (flops/s) | cost FLOPs / measured wall |
  | ``perf/achieved_bytes`` | gauge (bytes/s) | cost bytes / measured wall |
  | ``perf/roofline_frac`` | gauge (ratio) | achieved / the card's peak (binding wall) |
  | ``perf/device_idle_frac`` | gauge (ratio) | idle fraction of the dispatch loop |

  All labeled ``fn`` (the :func:`~socceraction_tpu_torch.obs.dispatch.instrument`
  name, so the cost lookup and the roofline read the same books) plus an
  optional bounded ``bucket``.

- :class:`IdleTracker` — the device-idle detector: each ``observe`` is
  one dispatch completion with its busy wall; the tracker estimates the
  fraction of the recent window the loop spent NOT dispatching.

:data:`DEVICE_PEAKS` is the port's one table of card peaks, keyed by the
prefix of ``torch.cuda.get_device_name()``. It holds the published H100
SXM figures (NVIDIA H100 Tensor Core GPU datasheet, dense rates, 700 W):
3.35e12 B/s of HBM3, 67e12 FLOP/s f32 outside the tensor cores and
495e12 FLOP/s TF32 on them. The roofline divides FLOPs by the f32 rate:
the port's products run with TF32 off. There is no CPU entry, so no
``roofline_frac`` is recorded on the CPU (``achieved_flops`` /
``achieved_bytes`` still are: they need only the cost).

Caveats, as in the JAX package: the cost is of the function's *last
first-called signature*, so a smaller dispatch divided by a bigger
signature's cost over-reads, and walls must be host-synced to mean
anything. A ``roofline_frac`` above 1 is a wrong cost, not a fast card.

Sampling: ``SOCCERACTION_TPU_PERF_SAMPLE_N`` records the full gauge set
on every Nth dispatch per function (default 1). ``perf/dispatches`` and
the idle detector always run. ``0`` disables the module.
"""

from __future__ import annotations

import os
import sys
import threading
import time
from collections import deque
from typing import Any, Callable, Dict, Optional

from .metrics import REGISTRY, MetricRegistry

__all__ = [
    'DEVICE_PEAKS',
    'IdleTracker',
    'device_peaks',
    'idle_tracker',
    'perf_snapshot',
    'record_dispatch',
    'reset_perf',
]

#: Peaks per ``torch.cuda.get_device_name()`` prefix: HBM bytes/s, f32
#: FLOP/s outside the tensor cores, dense TF32 FLOP/s on them. Source:
#: NVIDIA's H100 Tensor Core GPU datasheet, SXM5 part (the 80 GB HBM3
#: card), at its 700 W limit. No CPU entry on purpose: a CPU "roofline
#: fraction" against a card's peak would be noise presented as signal.
DEVICE_PEAKS: Dict[str, Dict[str, float]] = {
    'NVIDIA H100 80GB HBM3': {
        'bytes_per_s': 3.35e12,
        'flops_f32': 67e12,
        'flops_tf32': 495e12,
    },
}


def device_peaks(device_kind: Optional[str]) -> Optional[Dict[str, float]]:
    """The peak entry whose prefix matches ``device_kind``, or None."""
    if not device_kind:
        return None
    for prefix, peaks in DEVICE_PEAKS.items():
        if device_kind.startswith(prefix):
            return peaks
    return None


def _device_kind() -> Optional[str]:
    """The current card's name, when torch is loaded and a card is present."""
    torch = sys.modules.get('torch')
    if torch is None or not torch.cuda.is_available():
        return None
    return torch.cuda.get_device_name()


def _sample_n() -> int:
    try:
        return int(os.environ.get('SOCCERACTION_TPU_PERF_SAMPLE_N', '1'))
    except ValueError:
        return 1


class IdleTracker:
    """Device-idle estimator over one dispatch loop's completions.

    Each :meth:`observe` call is "one dispatch just completed; it was
    busy for ``busy_s``". Over the retained window (default 60 s) the
    idle fraction is ``1 - busy / elapsed`` where ``elapsed`` spans the
    oldest to the newest completion and ``busy`` sums the walls of the
    dispatches *completing inside* that span (the oldest sample anchors
    the span; its own wall ran before it). Needs at least two samples
    in the window; returns None (recording nothing) before that.
    Overlapping dispatches would double-count busy time (clamped at 0
    idle). ``clock`` is injectable for tests.
    """

    def __init__(
        self,
        window_s: float = 60.0,
        *,
        clock: Callable[[], float] = time.monotonic,
    ) -> None:
        self.window_s = float(window_s)
        self._clock = clock
        self._lock = threading.Lock()
        #: (completion_t, busy_s) pairs, oldest first
        self._samples: 'deque[tuple]' = deque()

    def observe(self, busy_s: float) -> Optional[float]:
        """Record one completed dispatch; returns the idle fraction or None."""
        now = self._clock()
        with self._lock:
            self._samples.append((now, float(busy_s)))
            cutoff = now - self.window_s
            while self._samples and self._samples[0][0] < cutoff:
                self._samples.popleft()
            if len(self._samples) < 2:
                return None
            t_oldest = self._samples[0][0]
            elapsed = now - t_oldest
            if elapsed <= 0:
                return None
            busy = sum(b for t, b in self._samples if t > t_oldest)
            return min(max(1.0 - busy / elapsed, 0.0), 1.0)

    @property
    def n_samples(self) -> int:
        """Completions currently retained in the window."""
        with self._lock:
            return len(self._samples)


_LOCK = threading.Lock()
_TRACKERS: Dict[str, IdleTracker] = {}
_STATS: Dict[str, Dict[str, Any]] = {}


def idle_tracker(fn: str, *, window_s: float = 60.0) -> IdleTracker:
    """The process-wide :class:`IdleTracker` of one dispatch loop."""
    with _LOCK:
        tracker = _TRACKERS.get(fn)
        if tracker is None:
            tracker = _TRACKERS[fn] = IdleTracker(window_s)
        return tracker


def record_dispatch(
    fn: str,
    wall_s: float,
    *,
    bucket: Any = None,
    flops: Optional[float] = None,
    bytes_accessed: Optional[float] = None,
    device_kind: Optional[str] = None,
    registry: Optional[MetricRegistry] = None,
) -> Optional[Dict[str, Any]]:
    """Account one host-synced dispatch of ``fn`` into the ``perf/*`` area.

    ``wall_s`` is the measured dispatch wall. ``bucket`` (optional) is a
    bounded shape label. ``flops``/``bytes_accessed`` default to the
    dispatch observatory's cost for ``fn``
    (:func:`socceraction_tpu_torch.obs.dispatch.fn_cost`); pass them
    explicitly to decouple from it. ``device_kind`` defaults to the
    current card's name.

    Returns the computed record (the ``perf_snapshot()`` entry) for the
    sampled dispatches, None when sampling skipped this one or the
    module is disabled (``SOCCERACTION_TPU_PERF_SAMPLE_N=0``). The
    per-function idle detector and the ``perf/dispatches`` counter run
    on every call regardless — the idle estimate needs every gap.
    """
    n = _sample_n()
    if n <= 0:
        return None
    reg = registry if registry is not None else REGISTRY
    labels: Dict[str, str] = {'fn': fn}
    if bucket is not None:
        labels['bucket'] = str(bucket)
    reg.counter('perf/dispatches', unit='count').inc(1, **labels)
    idle = idle_tracker(fn).observe(wall_s)
    if idle is not None:
        reg.gauge('perf/device_idle_frac', unit='ratio').set(idle, fn=fn)

    with _LOCK:
        stats = _STATS.setdefault(fn, {'fn': fn, 'dispatches': 0, 'sampled': 0})
        stats['dispatches'] += 1
        sampled = (stats['dispatches'] - 1) % n == 0
        if sampled:
            stats['sampled'] += 1
        if idle is not None:
            stats['idle_frac'] = round(idle, 4)
    if not sampled:
        return None

    wall_s = float(wall_s)
    reg.histogram('perf/dispatch_seconds', unit='s').observe(wall_s, **labels)
    if flops is None and bytes_accessed is None:
        from .dispatch import fn_cost

        cost = fn_cost(fn)
        if cost is not None:
            flops, bytes_accessed = cost
    record: Dict[str, Any] = {'last_wall_s': round(wall_s, 6)}
    achieved_flops = achieved_bytes = None
    if wall_s > 0:
        if flops is not None:
            achieved_flops = float(flops) / wall_s
            reg.gauge('perf/achieved_flops', unit='flops/s').set(
                achieved_flops, **labels
            )
            record['cost_flops'] = float(flops)
            record['achieved_flops'] = achieved_flops
        if bytes_accessed is not None:
            achieved_bytes = float(bytes_accessed) / wall_s
            reg.gauge('perf/achieved_bytes', unit='bytes/s').set(
                achieved_bytes, **labels
            )
            record['cost_bytes'] = float(bytes_accessed)
            record['achieved_bytes'] = achieved_bytes
    peaks = device_peaks(device_kind if device_kind is not None else _device_kind())
    if peaks is not None:
        fracs = []
        if achieved_flops is not None:
            fracs.append(achieved_flops / peaks['flops_f32'])
        if achieved_bytes is not None:
            fracs.append(achieved_bytes / peaks['bytes_per_s'])
        if fracs:
            # the BINDING wall: whichever resource the dispatch is closer
            # to saturating under the cost model
            roofline = max(fracs)
            reg.gauge('perf/roofline_frac', unit='ratio').set(
                roofline, **labels
            )
            record['roofline_frac'] = roofline
    with _LOCK:
        stats = _STATS[fn]
        stats.update(record)
    return dict(stats)


def perf_snapshot() -> Dict[str, Dict[str, Any]]:
    """Every tracked function's latest perf entry, by ``fn``: dispatch
    counts, the last sampled wall/achieved/roofline record and the last
    idle fraction."""
    with _LOCK:
        return {fn: dict(s) for fn, s in sorted(_STATS.items())}


def reset_perf() -> None:
    """Forget every tracker and stat (tests; metrics reset separately)."""
    with _LOCK:
        _TRACKERS.clear()
        _STATS.clear()
