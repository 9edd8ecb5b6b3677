"""Crash-dump flight recorder: a bounded event ring + debug bundles.

Port of the JAX package's ``socceraction_tpu/obs/recorder.py``. When a
long-running loop dies, the metrics registry says *that* something went
wrong, but not *what led up to it*. The flight recorder keeps a small,
always-on, bounded in-memory ring of recent runtime events (span closes,
first calls of a dispatch signature, kernel builds, retrace storms,
retries, numeric-guard hits) so the last seconds before a failure can be
written out as one post-mortem artifact:

- :data:`RECORDER` — the process-wide :class:`FlightRecorder`. Spans
  (:mod:`socceraction_tpu_torch.obs.trace`), the dispatch observatory
  (:mod:`socceraction_tpu_torch.obs.dispatch`), the numeric guards and
  the retry engine feed it; appends are a lock + deque push, cheap
  enough to stay on in production.
- :func:`dump_debug_bundle` — write ring + typed metric snapshot + run
  manifest (env, device topology) + memory census as one ``.tar.gz``.

Bundle layout (all JSON), the JAX package's::

    manifest.json   run manifest + {'reason', 'trigger': {...}}
    ring.jsonl      the recorder ring, one event per line, oldest first
    metrics.json    compact typed registry snapshot (snapshot_dict)
    memory.json     the card's allocator stats + live-tensor census
                    ({'supported': false} where there is no card)

Stdlib only at import time: a crashing process with no card can still
dump.
"""

from __future__ import annotations

import io
import itertools
import json
import os
import tarfile
import threading
import time
from collections import deque
from typing import Any, Dict, List, Optional

from .metrics import REGISTRY, MetricRegistry

__all__ = [
    'RECORDER',
    'FlightRecorder',
    'default_debug_dir',
    'dump_debug_bundle',
]


def default_debug_dir() -> str:
    """Where automatic debug bundles land unless a caller overrides it.

    One resolution chain (``SOCCERACTION_TPU_DEBUG_DIR`` env var, else a
    fixed tempdir subdirectory) shared by every auto-dumping subsystem —
    the serving layer's crash/overload/swap dumps and the learning
    loop's rejected-promotion dumps must land in the same place for
    ``obsctl bundle <dir>`` to find them all.
    """
    import tempfile

    return os.environ.get('SOCCERACTION_TPU_DEBUG_DIR') or os.path.join(
        tempfile.gettempdir(), 'socceraction-tpu-debug'
    )

_bundle_seq = itertools.count(1)


class FlightRecorder:
    """Bounded ring of recent runtime events (thread-safe).

    ``capacity`` bounds memory: the ring holds the *most recent* events
    and silently drops the oldest — a flight recorder, not a log.
    """

    def __init__(self, capacity: int = 2048) -> None:
        self._lock = threading.Lock()
        self._ring: 'deque[Dict[str, Any]]' = deque(maxlen=int(capacity))
        self.dropped = 0

    def record(self, kind: str, **fields: Any) -> None:
        """Append one event (``ts`` and ``kind`` are added here)."""
        event = {'ts': time.time(), 'kind': kind}
        event.update(fields)
        with self._lock:
            if len(self._ring) == self._ring.maxlen:
                self.dropped += 1
            self._ring.append(event)

    def events(self) -> List[Dict[str, Any]]:
        """The ring's events, oldest first (a copy)."""
        with self._lock:
            return list(self._ring)

    def clear(self) -> None:
        """Drop every buffered event (test isolation)."""
        with self._lock:
            self._ring.clear()
            self.dropped = 0

    def __len__(self) -> int:
        with self._lock:
            return len(self._ring)


#: The process-wide flight recorder the runtime feeds by default.
RECORDER = FlightRecorder()


def _json_bytes(obj: Any) -> bytes:
    return json.dumps(obj, default=str, sort_keys=True, indent=1).encode('utf-8')


def dump_debug_bundle(
    out_dir: str,
    *,
    reason: str = 'manual',
    trigger: Optional[Dict[str, Any]] = None,
    registry: Optional[MetricRegistry] = None,
    recorder: Optional[FlightRecorder] = None,
) -> str:
    """Write one post-mortem tarball into ``out_dir``; returns its path.

    ``reason`` is a short machine-readable cause (``flusher_crash``,
    ``overload``, ``swap_failure``, ``manual``); ``trigger`` is the
    structured event that fired the dump (error string, queue state, …)
    and lands verbatim in ``manifest.json``. The active
    :class:`~socceraction_tpu_torch.obs.trace.RunLog` (if any) gets a
    ``debug_bundle`` event pointing at the artifact.
    """
    from .export import snapshot_dict
    from .memory import (
        device_memory_stats,
        live_array_census,
    )
    from .trace import current_runlog, run_manifest

    reg = registry if registry is not None else REGISTRY
    rec = recorder if recorder is not None else RECORDER

    manifest = run_manifest()
    manifest['reason'] = reason
    manifest['trigger'] = dict(trigger) if trigger else None

    ring = rec.events()
    ring_lines = b''.join(
        json.dumps(e, default=str, sort_keys=True).encode('utf-8') + b'\n'
        for e in ring
    )

    census = live_array_census()
    memory = {
        'device_memory_stats': device_memory_stats(),
        'live_arrays': census,
        'supported': census.get('supported', False),
    }

    os.makedirs(out_dir, exist_ok=True)
    stamp = time.strftime('%Y%m%dT%H%M%S')
    path = os.path.join(
        out_dir,
        f'debug-{os.getpid()}-{stamp}-{next(_bundle_seq)}.tar.gz',
    )
    members = (
        ('manifest.json', _json_bytes(manifest)),
        ('ring.jsonl', ring_lines),
        ('metrics.json', _json_bytes(snapshot_dict(reg.snapshot(), buckets=False))),
        ('memory.json', _json_bytes(memory)),
    )
    tmp = f'{path}.tmp-{os.getpid()}'

    def _write_bundle() -> None:
        # write + atomic rename as ONE retried unit: a transient
        # OSError (disk briefly full, fs failover) rebuilds the tmp
        # from the already-captured in-memory payloads and tries
        # again — a post-mortem bundle is exactly the artifact that
        # must survive a flaky disk
        try:
            with tarfile.open(tmp, 'w:gz') as tar:
                for name, payload in members:
                    info = tarfile.TarInfo(name)
                    info.size = len(payload)
                    info.mtime = int(time.time())
                    tar.addfile(info, io.BytesIO(payload))
            os.replace(tmp, path)  # a killed dump never leaves a partial bundle
        finally:
            if os.path.exists(tmp):
                os.unlink(tmp)

    from ..resil.retry import retry_call

    retry_call(_write_bundle, site='recorder.dump')

    rec.record('debug_bundle', path=path, reason=reason)
    log = current_runlog()
    if log is not None:
        log.event('debug_bundle', path=path, reason=reason)
    return path
