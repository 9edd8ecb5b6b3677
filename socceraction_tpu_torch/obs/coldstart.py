"""Cold-start timeline: phase-marked startup spans from process start.

A copy of the JAX package's ``socceraction_tpu/obs/coldstart.py``. A
replica's worth is "process start → first rated action", and shortening
it requires knowing where those seconds go. The port's start-up phases
(:data:`PHASES`) name what it does: ``import`` (the interpreter, torch
and the package), ``checkpoint_load``, ``aot_deserialize`` (the serving
warm tier checking and installing shipped kernel libraries,
:meth:`~socceraction_tpu_torch.serve.service.RatingService.load_aot`),
``kernel_build`` (``nvcc`` building the hand-written kernels, or loading
libraries already in place, recorded by
:func:`~socceraction_tpu_torch.ops.cuda_build.load_libraries`),
``device_upload`` and ``first_dispatch``.

- :func:`process_start_unix` — the OS's record of when this process
  started (``/proc/self/stat`` start time against the boot clock), so
  the timeline's zero predates even the interpreter's own startup. None
  where ``/proc`` is unavailable; callers fall back to their own entry
  stamp (the measured wall then starts at first Python instead of
  ``exec``, strictly later — the sum-of-phases ≤ wall contract holds
  either way).
- :class:`ColdstartTimeline` (the process-global :data:`TIMELINE`) —
  ``begin()`` anchors the zero; ``phase(name)`` context-manages one
  sequential startup phase (``start_unix=`` backdates a phase to the
  anchor, which is how ``import`` charges interpreter startup);
  ``mark(name)`` stamps point events (``first_rated_action``). Every
  phase close lands a ``coldstart_phase`` event in the flight recorder
  and the active run log, so a timeline can be rebuilt post-mortem.
- :func:`coldstart_report` — the typed report: ordered phases with
  walls, marks, ``phase_total_s``, ``wall_s`` (process start → the
  ``first_rated_action`` mark) and ``unattributed_s`` (the gap the
  phases did not cover — nonzero is expected: interpreter startup when
  ``/proc`` anchoring is off, host work between phases).

Phases are wall-clock (`time.time`) on purpose: the anchor comes from
the kernel's boot-relative clock and must compose with stamps taken
before any Python ran.

Stdlib only.
"""

from __future__ import annotations

import contextlib
import os
import threading
import time
from typing import Any, Dict, Iterator, List, Optional

__all__ = [
    'PHASES',
    'TIMELINE',
    'ColdstartTimeline',
    'coldstart_report',
    'process_start_unix',
]


#: The port's start-up phases, in the order a serving process runs them.
PHASES = (
    'import', 'checkpoint_load', 'aot_deserialize', 'kernel_build', 'device_upload',
    'first_dispatch',
)


def process_start_unix() -> Optional[float]:
    """This process's start time as a unix timestamp, or None.

    Linux: ``/proc/self/stat`` field 22 (process start in clock ticks
    since boot — parsed after the last ``)`` so an exotic process name
    cannot shift the fields) plus ``/proc/stat``'s ``btime`` boot
    stamp. Returns None anywhere that bookkeeping is unavailable.
    """
    try:
        with open('/proc/self/stat', 'rb') as f:
            stat = f.read().decode('ascii', 'replace')
        # fields after the parenthesized comm; state is index 0, so the
        # overall field 22 (starttime) lands at index 19
        fields = stat.rsplit(')', 1)[1].split()
        ticks = float(fields[19])
        hz = float(os.sysconf('SC_CLK_TCK'))
        with open('/proc/stat', encoding='ascii', errors='replace') as f:
            btime = next(
                float(line.split()[1])
                for line in f
                if line.startswith('btime ')
            )
        return btime + ticks / hz
    except Exception:
        return None


class ColdstartTimeline:
    """Ordered startup phases + point marks, anchored at process start."""

    def __init__(self) -> None:
        self._lock = threading.Lock()
        self._start: Optional[float] = None
        self._phases: List[Dict[str, Any]] = []
        self._marks: Dict[str, float] = {}

    def begin(self, process_start: Optional[float] = None) -> float:
        """Anchor the timeline's zero (idempotent); returns the anchor.

        ``process_start`` defaults to :func:`process_start_unix`, then
        to now. A second ``begin`` keeps the first anchor — the earliest
        caller wins, so library code can begin defensively.
        """
        with self._lock:
            if self._start is None:
                if process_start is None:
                    process_start = process_start_unix()
                self._start = (
                    float(process_start)
                    if process_start is not None
                    else time.time()
                )
            return self._start

    @property
    def started_at(self) -> Optional[float]:
        """The anchor (unix seconds), or None before :meth:`begin`."""
        with self._lock:
            return self._start

    @contextlib.contextmanager
    def phase(
        self, name: str, *, start_unix: Optional[float] = None
    ) -> Iterator[None]:
        """Record the enclosed block as one sequential startup phase.

        ``start_unix`` backdates the phase's start (the ``import`` phase
        passes the process anchor so interpreter startup is charged to
        it, not lost). The phase is recorded — and its
        ``coldstart_phase`` event emitted — even when the body raises,
        so a failed startup still leaves its partial timeline.
        """
        self.begin()
        t0 = float(start_unix) if start_unix is not None else time.time()
        try:
            yield
        finally:
            t1 = time.time()
            entry = {
                'phase': name,
                'start_unix': t0,
                'seconds': max(t1 - t0, 0.0),
            }
            with self._lock:
                self._phases.append(entry)
            self._emit('coldstart_phase', **entry)

    def mark(self, name: str) -> float:
        """Stamp a named point event (e.g. ``first_rated_action``)."""
        self.begin()
        now = time.time()
        with self._lock:
            self._marks[name] = now
        self._emit('coldstart_mark', mark=name, unix=now)
        return now

    @staticmethod
    def _emit(kind: str, **payload: Any) -> None:
        """Recorder + run-log fan-out; telemetry must never fail startup."""
        try:
            from .recorder import RECORDER
            from .trace import current_runlog

            RECORDER.record(kind, **payload)
            log = current_runlog()
            if log is not None:
                log.event(kind, **payload)
        except Exception:
            pass

    def report(self) -> Dict[str, Any]:
        """The typed timeline: phases, marks, and the wall decomposition.

        ``supported`` is False (and nothing else meaningful) before
        :meth:`begin`. ``wall_s`` appears once a ``first_rated_action``
        mark exists; ``unattributed_s`` is ``wall_s`` minus the phase
        sum, floored at 0 — the startup time no phase claimed.
        """
        with self._lock:
            start = self._start
            phases = [dict(p) for p in self._phases]
            marks = dict(self._marks)
        if start is None:
            return {'supported': False, 'phases': [], 'marks': {}}
        phase_total = sum(p['seconds'] for p in phases)
        out: Dict[str, Any] = {
            'supported': True,
            'process_start_unix': start,
            'phases': phases,
            'phase_seconds': {p['phase']: p['seconds'] for p in phases},
            'phase_total_s': phase_total,
            'marks': marks,
        }
        first = marks.get('first_rated_action')
        if first is not None:
            wall = max(first - start, 0.0)
            out['wall_s'] = wall
            out['unattributed_s'] = max(wall - phase_total, 0.0)
        return out

    def reset(self) -> None:
        """Forget the timeline (tests; a process cold-starts once)."""
        with self._lock:
            self._start = None
            self._phases = []
            self._marks = {}


#: the process-wide timeline (a process cold-starts exactly once)
TIMELINE = ColdstartTimeline()


def coldstart_report() -> Dict[str, Any]:
    """:meth:`ColdstartTimeline.report` of the process timeline."""
    return TIMELINE.report()
