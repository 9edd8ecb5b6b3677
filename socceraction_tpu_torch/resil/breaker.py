"""Circuit breaker: trip on consecutive failures, probe, recover.

A copy of the JAX package's ``socceraction_tpu/resil/breaker.py``. The
fused serving dispatch is one program: when it starts failing (an
injected chaos fault, an operand error), every flush fails the same way,
and retrying it per flush just burns the latency budget of every queued
request. The classic answer is a circuit breaker with three states:

- **closed** (healthy): calls flow; ``failure_threshold`` *consecutive*
  failures trip the breaker open (one success resets the streak);
- **open**: calls are refused up front (:meth:`allow` returns
  ``'open'``) so the caller can take its degraded path without paying
  the failure; after ``recovery_time_s`` the next :meth:`allow` admits
  exactly one **probe** (``'probe'``);
- **half-open**: the single in-flight probe decides — success closes
  the breaker (healthy again), failure re-opens it and restarts the
  recovery clock.

The serving integration
(:class:`~socceraction_tpu_torch.serve.service.RatingService`) wraps the
fused dispatch: a tripped breaker routes flushes through the
materialized ``rate_batch_reference`` path, ``health()`` reports
``'degraded'``, and the half-open probe is simply the next real flush
tried on the fused path. A kernel that cannot run
(:class:`~socceraction_tpu_torch.ops.cuda_build.KernelError`) is never
recorded here: the service fails that flush instead of degrading it.

State is exported as the governed ``resil/breaker_state`` gauge
(0 closed, 1 half-open, 2 open), trips under ``resil/breaker_trips``,
probe verdicts under ``resil/breaker_probes{outcome}``; every
transition records a ``breaker_transition`` event in the flight
recorder and run log.
"""

from __future__ import annotations

import threading
import time
from typing import Any, Dict, Optional

__all__ = ['CircuitBreaker']

#: gauge encoding of the state (documented in docs/resilience.md)
_STATE_VALUE = {'closed': 0, 'half_open': 1, 'open': 2}


class CircuitBreaker:
    """Thread-safe three-state circuit breaker (see the module docs).

    Parameters
    ----------
    failure_threshold : int
        Consecutive failures that trip the breaker open.
    recovery_time_s : float
        Open dwell before one half-open probe is admitted.
    name : str
        Identity in events (one breaker per protected path).
    clock : callable
        Monotonic time source (injectable for deterministic tests).
    """

    def __init__(
        self,
        failure_threshold: int = 3,
        recovery_time_s: float = 5.0,
        *,
        name: str = 'serve.dispatch',
        clock: Any = time.monotonic,
    ) -> None:
        if failure_threshold < 1:
            raise ValueError('failure_threshold must be >= 1')
        self.failure_threshold = int(failure_threshold)
        self.recovery_time_s = float(recovery_time_s)
        self.name = name
        self._clock = clock
        self._lock = threading.Lock()
        self._state = 'closed'
        self._consecutive_failures = 0
        self._opened_t: Optional[float] = None
        self._probe_in_flight = False
        self._trips = 0
        self._last_error: Optional[str] = None
        self._gauge('closed')

    # -- the protected-call protocol ----------------------------------------

    def allow(self) -> str:
        """Admission verdict for one call: ``'closed'`` | ``'probe'`` |
        ``'open'``.

        ``'probe'`` admits exactly one call while half-open; until that
        probe reports back (:meth:`record_success` /
        :meth:`record_failure`), every other caller sees ``'open'``.
        """
        with self._lock:
            if self._state == 'closed':
                return 'closed'
            if self._state == 'open':
                if (
                    self._opened_t is not None
                    and self._clock() - self._opened_t >= self.recovery_time_s
                ):
                    self._transition('half_open')
                    self._probe_in_flight = True
                    return 'probe'
                return 'open'
            # half-open: one probe only
            if not self._probe_in_flight:
                self._probe_in_flight = True
                return 'probe'
            return 'open'

    def record_success(self) -> None:
        """One protected call succeeded; closes a half-open breaker."""
        probe_closed = False
        with self._lock:
            self._consecutive_failures = 0
            self._probe_in_flight = False
            if self._state != 'closed':
                self._transition('closed')
                probe_closed = True
        if probe_closed:
            self._count('resil/breaker_probes', outcome='closed')

    def record_failure(self, exc: Optional[BaseException] = None) -> bool:
        """One protected call failed; returns True when this call tripped
        the breaker open (the caller's cue for its one-time alarm)."""
        tripped = False
        probe_failed = False
        with self._lock:
            self._last_error = (
                f'{type(exc).__name__}: {exc}' if exc is not None else None
            )
            if self._state == 'half_open':
                # the probe failed: back to open, restart the clock
                self._probe_in_flight = False
                self._opened_t = self._clock()
                self._transition('open')
                probe_failed = True
            else:
                self._consecutive_failures += 1
                if (
                    self._state == 'closed'
                    and self._consecutive_failures >= self.failure_threshold
                ):
                    self._opened_t = self._clock()
                    self._trips += 1
                    self._transition('open')
                    tripped = True
        if tripped:
            self._count('resil/breaker_trips')
        if probe_failed:
            self._count('resil/breaker_probes', outcome='reopened')
        return tripped

    def _abandon_probe(self) -> None:
        """The in-flight probe ended with no verdict (its call failed for
        a reason that says nothing of the protected path's health): free
        the probe slot, change nothing else, so the next :meth:`allow`
        admits a new probe."""
        with self._lock:
            self._probe_in_flight = False

    # -- transitions + accounting -------------------------------------------

    def _transition(self, new_state: str) -> None:
        """State change under the lock; telemetry is best-effort."""
        old, self._state = self._state, new_state
        self._gauge(new_state)
        try:
            from ..obs.recorder import RECORDER
            from ..obs.trace import current_runlog

            payload = {
                'breaker': self.name,
                'from': old,
                'to': new_state,
                'consecutive_failures': self._consecutive_failures,
                'last_error': self._last_error,
            }
            RECORDER.record('breaker_transition', **payload)
            log = current_runlog()
            if log is not None:
                log.event('breaker_transition', **payload)
        except Exception:
            pass  # telemetry must never wedge the breaker

    @staticmethod
    def _gauge(state: str) -> None:
        try:
            from ..obs import gauge

            gauge('resil/breaker_state', unit='state').set(_STATE_VALUE[state])
        except Exception:
            pass

    @staticmethod
    def _count(name: str, **labels: str) -> None:
        try:
            from ..obs import counter

            counter(name, unit='count').inc(1, **labels)
        except Exception:
            pass

    # -- introspection ------------------------------------------------------

    @property
    def state(self) -> str:
        """``'closed'`` | ``'open'`` | ``'half_open'`` right now.

        A read-only peek: an expired open dwell still reads ``'open'``
        until :meth:`allow` admits the probe (admission is what
        transitions, so state never changes under a passive observer).
        """
        with self._lock:
            return self._state

    @property
    def trips(self) -> int:
        """Times the breaker has tripped open (lifetime)."""
        with self._lock:
            return self._trips

    def to_dict(self) -> Dict[str, Any]:
        """JSON-able snapshot for ``health()`` and ``obsctl resil``."""
        with self._lock:
            open_for = (
                self._clock() - self._opened_t
                if self._state != 'closed' and self._opened_t is not None
                else None
            )
            return {
                'name': self.name,
                'state': self._state,
                'consecutive_failures': self._consecutive_failures,
                'failure_threshold': self.failure_threshold,
                'recovery_time_s': self.recovery_time_s,
                'open_for_s': open_for,
                'trips': self._trips,
                'last_error': self._last_error,
            }
