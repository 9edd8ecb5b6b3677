"""Tracing and profiling hooks (façade over :mod:`socceraction_tpu_torch.obs`).

Port of the JAX package's ``socceraction_tpu/utils/profiling.py``:

1. :func:`profile_trace` -- context manager around ``torch.profiler`` that
   captures a trace of the enclosed region (CPU activity, and the card's
   kernels where there is one) and writes it as a Chrome trace JSON.
2. :func:`annotate` -- names a region for the profiler
   (``torch.profiler.record_function``).
3. :class:`Timer` / :func:`timed` / :func:`record_value` /
   :func:`timer_report` -- the legacy wall-clock timer API, a thin
   façade over the typed metric registry: ``timed(name)`` records into a
   seconds histogram, ``record_value`` into a gauge, and
   ``timer_report()`` renders the legacy flat report from the registry's
   snapshot, translating the labeled pipeline stage histogram
   (``pipeline/stage_seconds{stage=...}``) back to the flat names
   (``pipeline/read_actions``, ``pipeline/pack``, ...). Entries carry
   ``count/total/mean/max`` plus a ``unit``; the ``total_s``/``mean_s``/
   ``max_s`` keys remain as deprecated aliases.

torch is imported only by the paths that need it (device
synchronization, profiler traces): the registry façade stays importable
by processes that never load torch.
"""

from __future__ import annotations

import contextlib
import itertools
import os
import sys
import threading
import time
from typing import Any, Callable, ContextManager, Dict, Iterator, Optional, Union

from ..obs import metrics as _metrics
from ..obs.export import timer_report_compat

__all__ = [
    'Timer',
    'annotate',
    'profile_trace',
    'record_value',
    'timed',
    'timer_report',
]

#: the labeled stage histogram the pipeline records into, and the legacy
#: flat names ``timer_report()`` keeps publishing them under
STAGE_SECONDS = 'pipeline/stage_seconds'
LEGACY_STAGE_NAMES: Dict[str, str] = {
    'read': 'pipeline/read_actions',
    'read_io': 'pipeline/read_io',
    'decode': 'pipeline/decode',
    'pack': 'pipeline/pack',
    'transfer': 'pipeline/transfer',
    'read_cache': 'pipeline/read_cache',
    'cache_write': 'pipeline/cache_write',
    'pack_cache_build': 'pipeline/pack_cache_build',
    'load_events': 'pipeline/load_events',
    'convert': 'pipeline/convert',
    'feed_wait': 'pipeline/feed_wait',
}
_FEED_QUEUE_DEPTH = 'pipeline/feed_queue_depth'

# names created through this façade (timed / record_value): the report
# publishes exactly these plus the pipeline mappings above
_legacy_lock = threading.Lock()
_legacy_names: set = set()

_trace_seq = itertools.count(1)


def _wait_for(targets: Any) -> None:
    """Wait for the card's work producing ``targets`` (tensors, or trees
    of them): one event on each of their devices' current streams, so
    only those streams' queued work is waited for. CPU values need none."""
    from ..obs.residency import _iter_leaves

    torch = sys.modules.get('torch')
    if torch is None:
        return
    devices = {
        leaf.device for leaf in _iter_leaves(targets)
        if isinstance(leaf, torch.Tensor) and leaf.device.type == 'cuda'
    }
    for device in devices:
        event = torch.cuda.Event()
        event.record(torch.cuda.current_stream(device))
        event.synchronize()


class Timer:
    """Legacy accumulating timer view over one histogram series."""

    def __init__(self, name: str, _series: Optional[_metrics.Series] = None) -> None:
        self.name = name
        self._series = (
            _series
            if _series is not None
            else _metrics.histogram(name, unit='s').labels()
        )
        self._sync_targets: list = []

    def add(self, elapsed_s: float) -> None:
        """Record one timed interval of ``elapsed_s`` seconds."""
        self._series.observe(elapsed_s)

    def sync(self, value: Any) -> Any:
        """Register device output(s) produced in the timed region: at
        context exit the timer waits for them, so the stage is charged
        for its own device work. Returns ``value`` unchanged for inline
        use: ``out = t.sync(kernel(x))``."""
        self._sync_targets.append(value)
        return value

    @property
    def count(self) -> int:
        """Recorded interval count."""
        return self._series.count

    @property
    def total_s(self) -> float:
        """Sum of recorded seconds."""
        return self._series.total

    @property
    def max_s(self) -> float:
        """Largest recorded interval (0.0 while empty)."""
        m = self._series.max
        return 0.0 if m != m else m  # NaN while empty

    def as_dict(self) -> Dict[str, float]:
        """Snapshot: count plus total/mean/max seconds."""
        count = self.count
        total = self.total_s
        return {
            'count': count,
            'total_s': total,
            'mean_s': total / count if count else 0.0,
            'max_s': self.max_s,
        }


@contextlib.contextmanager
def timed(
    name: str,
    *,
    block_until_ready: bool = False,
    sync: Union[None, Any, Callable[[], Any]] = None,
) -> Iterator[Timer]:
    """Time a host-side stage and record it under ``name`` (seconds).

    Device-synced timing charges only this stage's own work: pass the
    tensors (or a zero-arg callable returning them) as ``sync=``, or
    register outputs produced inside the region via :meth:`Timer.sync`
    — the exit then waits on their streams. ``block_until_ready=True``
    *without* any registered target waits for the whole card
    (``torch.cuda.synchronize()``), which charges unrelated in-flight
    work to this stage — kept for the legacy spelling; prefer ``sync=``.
    """
    with _legacy_lock:
        _legacy_names.add(name)
    timer = Timer(name)
    t0 = time.perf_counter()
    try:
        yield timer
    finally:
        targets = list(timer._sync_targets)
        if sync is not None:
            targets.append(sync() if callable(sync) else sync)
        if targets:
            _wait_for(targets)
        elif block_until_ready:
            torch = sys.modules.get('torch')
            if torch is not None and torch.cuda.is_initialized():
                torch.cuda.synchronize()
        timer.add(time.perf_counter() - t0)


def record_value(name: str, value: float) -> None:
    """Record a dimensionless sample into a gauge in the shared registry.

    The legacy spelling of ``obs.gauge(name).set(value)``. When the name
    is already registered as a gauge with a real unit (the feed's
    ``pipeline/feed_queue_depth``, ``unit='chunks'``), the sample lands on
    that gauge; a name registered as a different *kind* still raises.
    """
    with _legacy_lock:
        _legacy_names.add(name)
    inst = _metrics.REGISTRY.get(name)
    if isinstance(inst, _metrics.Gauge):
        inst.set(float(value))
        return
    _metrics.gauge(name, unit='value').set(float(value))


def timer_report(reset: bool = False) -> Dict[str, Dict[str, float]]:
    """Legacy flat report ``{name: {count, total, mean, max, unit, ...}}``.

    Rendered from the typed registry snapshot: façade-recorded series
    under their own names, the labeled pipeline stage histogram under
    the flat names, and the feed queue-depth gauge. ``reset`` zeroes
    every registry series in place (instruments stay registered).
    """
    snapshot = _metrics.REGISTRY.snapshot()
    with _legacy_lock:
        spec: Dict[str, Any] = {
            n: n for n in _legacy_names if n in snapshot.instruments
        }
    for stage, legacy in LEGACY_STAGE_NAMES.items():
        spec[legacy] = (STAGE_SECONDS, {'stage': stage})
    if _FEED_QUEUE_DEPTH in snapshot.instruments:
        spec[_FEED_QUEUE_DEPTH] = _FEED_QUEUE_DEPTH
    report = timer_report_compat(snapshot, spec)
    if reset:
        _metrics.REGISTRY.reset()
    return report


def annotate(name: str) -> ContextManager[Any]:
    """A region named for the profiler (``torch.profiler.record_function``).

    Example::

        with annotate('xt/solve'):
            solution = solve_xt(probs, eps=eps)
    """
    import torch

    return torch.profiler.record_function(name)


@contextlib.contextmanager
def profile_trace(log_dir: str, *, enabled: bool = True) -> Iterator[Any]:
    """Capture a ``torch.profiler`` trace of the enclosed region.

    CPU activity always, the card's kernels and copies where there is a
    card. On exit the trace is written to ``log_dir`` as
    ``trace-<pid>-<n>.json`` (Chrome trace format, readable by Perfetto
    and ``chrome://tracing``). Yields the profiler (``key_averages()``
    for sums by kernel). ``enabled=False`` turns the context into a
    no-op, so call sites can keep the hook in place.

    The capture runs inside a ``profile/trace`` span carrying
    ``log_dir``, so a run log (and the flight recorder) records when a
    trace was taken and where it went.
    """
    if not enabled:
        yield None
        return
    import torch
    from torch.profiler import ProfilerActivity, profile

    from ..obs.trace import span as _span

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    path = os.path.join(log_dir, f'trace-{os.getpid()}-{next(_trace_seq)}.json')
    with _span('profile/trace', log_dir=log_dir, path=path):
        with profile(activities=activities) as prof:
            yield prof
        prof.export_chrome_trace(path)
