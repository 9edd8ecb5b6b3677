"""Span-structured run logs: nested spans, JSONL events, run manifests.

Port of the JAX package's ``socceraction_tpu/obs/trace.py``. Metrics
(:mod:`socceraction_tpu_torch.obs.metrics`) answer "how much / how fast";
this module answers "what happened, in what order, under which
configuration":

- :func:`span` — a nestable context manager that times a named region
  (wall clock, plus a device-synced duration when the body registers
  outputs with :meth:`Span.sync`) and appends ``span_open``/
  ``span_close`` events to the active :class:`RunLog`; every close also
  lands in the flight recorder. Nesting is per thread (the feed's
  prefetch worker gets its own stack). In place of ``jax.named_scope``
  the region runs under ``torch.profiler.record_function(name)`` while a
  torch profiler is on, so a ``torch.profiler`` trace shows the spans by
  name. :meth:`Span.sync` records a CUDA event on the current stream and
  waits on that event at span exit, so the span is charged for its own
  stream's work and never for unrelated streams
  (``torch.cuda.synchronize()`` would wait for every stream of the
  card). :meth:`Span.memory` adds the card's allocator watermarks to the
  close event.
- :class:`RunLog` — the run-scoped sink: a rotating ``obs.jsonl`` writer
  that opens with a run manifest (config, selected environment, device
  topology), accepts structured events, can embed metric snapshots, and
  closes with a final snapshot + ``run_end`` event. Its events and
  fields are the JAX package's.
- :func:`run_manifest` — the manifest dict alone, for artifacts as well
  as run logs. Its device topology comes from ``torch.cuda`` (name,
  capability, count, memory) and, where ``nvidia-smi`` is on the path,
  the card's power limit.
"""

from __future__ import annotations

import contextlib
import io
import itertools
import json
import os
import shutil
import subprocess
import sys
import threading
import time
from typing import Any, Dict, Iterator, List, Optional

from .metrics import NAME_RE, REGISTRY, MetricRegistry

__all__ = [
    'RunLog', 'Span', 'current_runlog', 'current_span', 'run_manifest', 'span',
]

_tls = threading.local()
_span_ids = itertools.count(1)
_active_lock = threading.Lock()
_active_runlog: Optional['RunLog'] = None


def current_runlog() -> Optional['RunLog']:
    """The :class:`RunLog` currently collecting events, if any."""
    return _active_runlog


def current_span() -> Optional['Span']:
    """This thread's innermost open span, if any (the hook request
    contexts use to link a request into the submitting thread's trace)."""
    stack = getattr(_tls, 'stack', None)
    return stack[-1] if stack else None


def _span_stack() -> List['Span']:
    stack = getattr(_tls, 'stack', None)
    if stack is None:
        stack = _tls.stack = []
    return stack


class Span:
    """One open span: identity, attributes and registered sync events."""

    __slots__ = (
        'name', 'attrs', 'span_id', 'parent_id', 't0', '_events', '_sync', '_memory',
    )

    def __init__(self, name: str, attrs: Dict[str, Any], parent_id: Optional[int]) -> None:
        self.name = name
        self.attrs = attrs
        self.span_id = next(_span_ids)
        self.parent_id = parent_id
        self.t0 = time.perf_counter()
        self._events: List[Any] = []
        self._sync = False
        self._memory: Optional[Dict[str, float]] = None

    def sync(self, value: Any) -> Any:
        """Have the span wait, at exit, for the device work queued so far.

        Records a CUDA event on the current stream of ``value``'s device
        (a tensor, or anything with a ``device``) and returns ``value``
        unchanged, so it can wrap an expression inline::

            with span('scenario/dispatch') as sp:
                values = sp.sync(model.rate_batch(batch))

        A CPU value is ready already: it records no event (the close
        event still says ``synced``).
        """
        import torch

        self._sync = True
        device = getattr(value, 'device', None)
        if isinstance(device, torch.device) and device.type == 'cuda':
            event = torch.cuda.Event()
            event.record(torch.cuda.current_stream(device))
            self._events.append(event)
        return value

    def annotate(self, **attrs: Any) -> None:
        """Attach additional attributes (shown on the close event)."""
        self.attrs.update(attrs)

    def memory(self) -> 'Span':
        """Request device-memory watermarks for this span; returns self.

        Reads the allocator's stats now and, at span exit, annotates the
        close event with ``mem_bytes_in_use`` / ``mem_peak_bytes`` /
        ``mem_delta_bytes`` and records the peak into the
        ``mem/span_peak_bytes`` histogram (labeled by span name). Where
        there is no card the span closes without memory attributes.
        """
        from .memory import device_memory_stats

        self._memory = device_memory_stats() or {}
        return self


def _record_function(name: str) -> Any:
    """``torch.profiler.record_function`` while a torch profiler is on,
    else a no-op. With no profiler on, the range records nothing, yet its
    entry and exit are two dispatcher calls, about half of a span's cost,
    so the check (torch's process-wide flag, set on every thread while any
    of its profilers runs) keeps spans cheap on a hot path. A data-prep
    process that never imported torch stays free of it."""
    torch = sys.modules.get('torch')
    if torch is None or not getattr(torch.autograd.profiler, '_is_profiler_enabled', True):
        return contextlib.nullcontext()
    return torch.profiler.record_function(name)


@contextlib.contextmanager
def span(name: str, **attrs: Any) -> Iterator[Span]:
    """Open a named, nestable span around a code region.

    Records wall duration always; waits at exit for the CUDA events the
    body registered with :meth:`Span.sync`, so the span's wall time then
    covers its own stream's work. The region runs under
    ``torch.profiler.record_function(name)`` while a torch profiler is on
    (no profiler, no range: the span then costs a few microseconds). When
    a :class:`RunLog` is active, ``span_open`` and ``span_close`` events
    (span id, parent id, duration, error status) are appended to it;
    every close also lands in the flight recorder.
    """
    if not NAME_RE.match(name):
        raise ValueError(
            f'span name {name!r} violates the area/stage convention '
            "(lowercase segments joined by '/', e.g. 'xt/fit')"
        )
    stack = _span_stack()
    parent = stack[-1] if stack else None
    s = Span(name, dict(attrs), parent.span_id if parent else None)
    log = _active_runlog
    if log is not None:
        log.event(
            'span_open', name=name, span_id=s.span_id,
            parent_id=s.parent_id, attrs=s.attrs,
        )
    stack.append(s)
    status = 'ok'
    error: Optional[str] = None
    try:
        with _record_function(name):
            yield s
    except BaseException as e:
        status = 'error'
        error = f'{type(e).__name__}: {e}'
        raise
    finally:
        synced = False
        if s._sync:
            # never raise from span exit: a sync failure must not shadow
            # the body's own exception
            try:
                for event in s._events:
                    event.synchronize()
                synced = True
            except RuntimeError:
                pass
        duration = time.perf_counter() - s.t0
        stack.pop()
        if s._memory is not None:
            _annotate_span_memory(s)
        log = _active_runlog
        if log is not None:
            close: Dict[str, Any] = {
                'name': name,
                'span_id': s.span_id,
                'parent_id': s.parent_id,
                'duration_s': duration,
                'synced': synced,
                'status': status,
                'attrs': s.attrs,
            }
            if error is not None:
                close['error'] = error
            log.event('span_close', **close)
        # feed the always-on flight recorder (bounded ring — cheap)
        from .recorder import RECORDER

        RECORDER.record(
            'span_close', name=name, duration_s=duration, status=status,
            attrs=dict(s.attrs), **({'error': error} if error else {}),
        )


def _annotate_span_memory(s: Span) -> None:
    """Close-time half of :meth:`Span.memory` (no-op without a card)."""
    from .memory import device_memory_stats

    end = device_memory_stats()
    if not end:
        return
    in_use = end['bytes_in_use']
    peak = end['peak_bytes_in_use']
    s.attrs['mem_bytes_in_use'] = in_use
    start = s._memory.get('bytes_in_use')
    if start is not None:
        s.attrs['mem_delta_bytes'] = in_use - start
    s.attrs['mem_peak_bytes'] = peak
    # span names may be dynamic (sanctioned for spans): past the label
    # budget the samples collapse into the reserved overflow series
    # instead of raising out of the span's exit path
    REGISTRY.histogram(
        'mem/span_peak_bytes', unit='bytes', on_overflow='overflow'
    ).observe(peak, span=s.name)


def _power_limit() -> Optional[str]:
    """The first card's power limit as ``nvidia-smi`` reports it, or None
    where the tool is not on the path."""
    smi = shutil.which('nvidia-smi')
    if smi is None:
        return None
    out = subprocess.run(
        [smi, '--query-gpu=power.limit', '--format=csv,noheader'],
        capture_output=True, text=True, timeout=30,
    )
    lines = out.stdout.strip().splitlines()
    return lines[0].strip() if out.returncode == 0 and lines else None


def run_manifest(
    config: Optional[Dict[str, Any]] = None,
    *,
    env_prefixes: Any = ('SOCCERACTION_TPU_', 'CUDA_', 'TORCH_'),
) -> Dict[str, Any]:
    """Describe this run: time, process, selected env, device topology.

    The device topology is read from ``torch.cuda`` only when torch is
    already imported (asking for a manifest never pulls torch into a
    process that does not use it): ``platform`` (``'cuda'`` or
    ``'cpu'``), and on a card its name, compute capability, count, total
    memory and ``nvidia-smi``'s power limit.
    """
    import platform as _platform
    import socket

    manifest: Dict[str, Any] = {
        'time_unix': time.time(),
        'pid': os.getpid(),
        'host': socket.gethostname(),
        'python': _platform.python_version(),
        'argv': list(sys.argv),
        'env': {
            k: v
            for k, v in sorted(os.environ.items())
            if k.startswith(tuple(env_prefixes))
        },
    }
    torch = sys.modules.get('torch')
    if torch is not None:
        device: Dict[str, Any] = {'torch_version': torch.__version__}
        if torch.cuda.is_available():
            props = torch.cuda.get_device_properties(0)
            device.update(
                platform='cuda',
                device_kind=torch.cuda.get_device_name(0),
                capability='.'.join(map(str, torch.cuda.get_device_capability(0))),
                device_count=torch.cuda.device_count(),
                memory_bytes=int(props.total_memory),
                power_limit=_power_limit(),
                cuda_version=torch.version.cuda,
            )
        else:
            device.update(platform='cpu', device_kind='cpu', device_count=1)
        manifest['device'] = device
    if config:
        manifest['config'] = dict(config)
    return manifest


class RunLog:
    """Run-scoped JSONL sink tying spans, metrics and the manifest together.

    Usage::

        with RunLog(out_dir, config={'games': 512}) as log:
            with span('train/epoch', epoch=0):
                for batch, ids in iter_batches(store, 512, ...):
                    ...
            log.metric_snapshot()

    The file opens with a ``run_start`` event carrying the manifest,
    receives ``span_open``/``span_close`` events from every :func:`span`
    in the process while active, and closes with a final metric snapshot
    plus ``run_end``. Writes rotate at ``max_bytes`` (``obs.jsonl`` →
    ``obs.jsonl.1`` → ... up to ``keep``), so a long-running feed cannot
    fill the disk. Appends are locked — worker threads (the feed's
    prefetch producer) interleave whole lines, never partial ones.

    Only one RunLog collects spans at a time (process-global); nested
    activation raises rather than silently splitting the event stream.
    """

    def __init__(
        self,
        path: str,
        *,
        config: Optional[Dict[str, Any]] = None,
        registry: Optional[MetricRegistry] = None,
        max_bytes: int = 64 << 20,
        keep: int = 3,
    ) -> None:
        if os.path.isdir(path) or path.endswith(os.sep):
            path = os.path.join(path, 'obs.jsonl')
        self.path = path
        self.config = config
        self.registry = registry if registry is not None else REGISTRY
        self.max_bytes = int(max_bytes)
        self.keep = int(keep)
        self._lock = threading.Lock()
        self._fh: Optional[io.TextIOBase] = None

    # -- lifecycle ---------------------------------------------------------

    def open(self) -> 'RunLog':
        """Open the sink, write the manifest, start collecting spans."""
        global _active_runlog
        with _active_lock:
            if _active_runlog is not None:
                raise RuntimeError(
                    'another RunLog is already active in this process'
                )
            os.makedirs(os.path.dirname(os.path.abspath(self.path)), exist_ok=True)
            self._fh = open(self.path, 'a', encoding='utf-8')
            _active_runlog = self
        self.event('run_start', manifest=run_manifest(self.config))
        return self

    def close(self) -> None:
        """Write the final snapshot + ``run_end`` and stop collecting."""
        global _active_runlog
        if self._fh is None:
            return
        self.metric_snapshot()
        self.event('run_end')
        with _active_lock:
            if _active_runlog is self:
                _active_runlog = None
        with self._lock:
            self._fh.close()
            self._fh = None

    def __enter__(self) -> 'RunLog':
        return self.open()

    def __exit__(self, *exc: Any) -> None:
        self.close()

    # -- events ------------------------------------------------------------

    def event(self, event_type: str, **fields: Any) -> None:
        """Append one structured JSONL event (no-op once closed)."""
        record = {
            'ts': time.time(),
            'event': event_type,
            'thread': threading.current_thread().name,
        }
        record.update(fields)
        line = json.dumps(record, default=str, sort_keys=True)
        with self._lock:
            if self._fh is None:
                return
            self._fh.write(line + '\n')
            self._fh.flush()
            if self._fh.tell() >= self.max_bytes:
                self._rotate_locked()

    def metric_snapshot(self) -> None:
        """Embed the registry's current typed snapshot as one event."""
        from .export import snapshot_dict

        self.event(
            'metrics',
            metrics=snapshot_dict(self.registry.snapshot(), buckets=False),
        )

    # -- rotation ----------------------------------------------------------

    def _rotate_locked(self) -> None:
        self._fh.close()
        for i in range(self.keep - 1, 0, -1):
            src = f'{self.path}.{i}'
            if os.path.exists(src):
                os.replace(src, f'{self.path}.{i + 1}')
        os.replace(self.path, f'{self.path}.1')
        self._fh = open(self.path, 'a', encoding='utf-8')
