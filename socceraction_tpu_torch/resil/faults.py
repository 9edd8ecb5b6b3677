"""Deterministic fault injection: named points, seeded plans, zero cost off.

A copy of the JAX package's ``socceraction_tpu/resil/faults.py``:

- :func:`fault_point` — named markers in the production code paths (the
  port has one so far: ``'ingest.read'`` inside the parquet read of
  :class:`~socceraction_tpu_torch.pipeline.store.SeasonStore`). Disarmed
  — the default, always, in production — a call is one module-global
  read and a ``None`` check: no locks, no metrics, no allocation.
- :class:`FaultPlan` — the armed schedule: a seed plus a list of
  :class:`FaultSpec` rules (error / latency injection, by nth call,
  call set or probability, with an injection budget). The same seed
  over the same call sequence produces the **identical** injection
  sequence (:attr:`FaultPlan.history` pins it bit-for-bit), so a chaos
  failure replays exactly.

Every injection is counted in the governed
``resil/faults_injected{point,kind}`` counter. (The JAX package also
writes a ``fault_injected`` event to its flight recorder and run log;
the port has neither yet.)

Usage (tests)::

    plan = FaultPlan(seed=7, specs=[
        FaultSpec('ingest.read', error=OSError, probability=0.2,
                  max_injections=3),
        FaultSpec('ingest.read', kind='latency', latency_s=0.05, nth=1),
    ])
    with plan:                      # arm (re-entrant arming is rejected)
        ... drive reads ...
    assert plan.history == expected  # reproducible bit-for-bit
"""

from __future__ import annotations

import fnmatch
import random
import threading
import time
from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional, Sequence, Tuple

__all__ = ['FaultPlan', 'FaultSpec', 'fault_point', 'injected_faults']

#: The armed plan, or None. Read unlocked on every fault_point call —
#: rebinding a module global is atomic in CPython, and the disarmed fast
#: path must cost nothing beyond this load.
_ACTIVE: Optional['FaultPlan'] = None


def fault_point(point: str, **info: Any) -> None:
    """Mark one named injection point; a no-op unless a plan is armed.

    ``info`` (small, JSON-able) travels into the ``fault_injected``
    event when an injection fires, so post-mortems carry the site's
    context (batch size, key, version). The call contract: placed where
    an injected exception exercises the *caller's* failure handling —
    inside the retried callable for retry sites, inside the flusher
    loop for crash supervision, before the device dispatch for the
    breaker.
    """
    plan = _ACTIVE
    if plan is None:
        return
    plan._hit(point, info)


def injected_faults() -> List[Dict[str, Any]]:
    """The armed plan's injection history so far ([] when disarmed)."""
    plan = _ACTIVE
    return plan.history if plan is not None else []


@dataclass
class FaultSpec:
    """One injection rule of a :class:`FaultPlan`.

    Parameters
    ----------
    point : str
        Fault-point name to match — exact, or an ``fnmatch`` glob
        (``'serve.*'``) when it contains a wildcard.
    kind : str
        ``'error'`` (raise) or ``'latency'`` (sleep ``latency_s`` and
        continue).
    error : type or callable
        Exception class (instantiated with ``message``) or a zero-arg
        factory returning the exception instance to raise.
    message : str
        Message for ``error`` classes (the default names the point, so
        an injected traceback is self-identifying).
    nth : int, optional
        Fire on exactly the nth matching call (1-based) at this spec.
    on_calls : sequence of int, optional
        Fire on this set of matching-call ordinals (1-based).
    probability : float, optional
        Fire per matching call with this probability, drawn from the
        plan's seeded RNG — deterministic for a deterministic call
        sequence.
    max_injections : int, optional
        Budget: stop firing after this many injections from this spec
        (unbounded when None; ``nth`` implies a budget of one).
    latency_s : float
        Sleep duration for ``kind='latency'``.

    With none of ``nth`` / ``on_calls`` / ``probability`` set the spec
    fires on **every** matching call (until ``max_injections``).
    """

    point: str
    kind: str = 'error'
    error: Any = OSError
    message: str = ''
    nth: Optional[int] = None
    on_calls: Optional[Sequence[int]] = None
    probability: Optional[float] = None
    max_injections: Optional[int] = None
    latency_s: float = 0.0
    #: calls that matched this spec's point so far (mutated by the plan)
    calls: int = field(default=0, repr=False)
    #: injections fired from this spec so far (mutated by the plan)
    injections: int = field(default=0, repr=False)

    def __post_init__(self) -> None:
        if self.kind not in ('error', 'latency'):
            raise ValueError(f'unknown fault kind {self.kind!r}')
        if self.probability is not None and not 0.0 <= self.probability <= 1.0:
            raise ValueError('probability must be in [0, 1]')

    def _matches(self, point: str) -> bool:
        if self.point == point:
            return True
        if any(c in self.point for c in '*?['):
            return fnmatch.fnmatchcase(point, self.point)
        return False

    def _budget(self) -> Optional[int]:
        if self.max_injections is not None:
            return int(self.max_injections)
        if self.nth is not None:
            return 1
        return None

    def _make_error(self) -> BaseException:
        if isinstance(self.error, type) and issubclass(self.error, BaseException):
            return self.error(
                self.message or f'injected fault at {self.point!r}'
            )
        return self.error()


class FaultPlan:
    """A seeded, armable schedule of :class:`FaultSpec` rules.

    Exactly one plan may be armed per process at a time (arming is a
    test/chaos-harness activity; overlapping plans would destroy the
    reproducibility contract). Arm with ``with plan:`` or
    :meth:`arm` / :meth:`disarm`.

    Determinism contract: for one fixed sequence of
    :func:`fault_point` calls, the same ``(seed, specs)`` produces the
    identical :attr:`history` — per-point call counters and the seeded
    RNG advance only on matching calls, in call order. (Concurrency is
    the *caller's* half of the contract: a chaos schedule that must be
    bit-reproducible drives deterministic call sequences, e.g. nth-call
    triggers on single-threaded sites.)
    """

    def __init__(self, seed: int = 0, specs: Sequence[FaultSpec] = ()) -> None:
        self.seed = int(seed)
        self.specs: Tuple[FaultSpec, ...] = tuple(specs)
        self._rng = random.Random(self.seed)
        self._lock = threading.Lock()
        self._calls: Dict[str, int] = {}
        self._history: List[Dict[str, Any]] = []

    # -- arming -------------------------------------------------------------

    def arm(self) -> 'FaultPlan':
        """Make this the process's armed plan (rejects double-arming)."""
        global _ACTIVE
        with _ARM_LOCK:
            if _ACTIVE is not None:
                raise RuntimeError(
                    'another FaultPlan is already armed; disarm it first '
                    '(one plan per process keeps injections reproducible)'
                )
            _ACTIVE = self
        return self

    def disarm(self) -> None:
        """Disarm (a no-op when some other plan — or none — is armed)."""
        global _ACTIVE
        with _ARM_LOCK:
            if _ACTIVE is self:
                _ACTIVE = None

    def __enter__(self) -> 'FaultPlan':
        return self.arm()

    def __exit__(self, *exc: Any) -> None:
        self.disarm()

    # -- the hit path (armed only) ------------------------------------------

    def _hit(self, point: str, info: Dict[str, Any]) -> None:
        fire: Optional[FaultSpec] = None
        with self._lock:
            self._calls[point] = self._calls.get(point, 0) + 1
            for spec in self.specs:
                if not spec._matches(point):
                    continue
                spec.calls += 1
                budget = spec._budget()
                if budget is not None and spec.injections >= budget:
                    continue
                if spec.nth is not None and spec.calls != spec.nth:
                    continue
                if (
                    spec.on_calls is not None
                    and spec.calls not in set(spec.on_calls)
                ):
                    continue
                if (
                    spec.probability is not None
                    and self._rng.random() >= spec.probability
                ):
                    continue
                spec.injections += 1
                fire = spec
                break  # first matching spec wins; later specs stay inert
            if fire is not None:
                record = {
                    'point': point,
                    'kind': fire.kind,
                    'call': fire.calls,
                    'injection': fire.injections,
                    'info': dict(info),
                }
                self._history.append(record)
        if fire is None:
            return
        self._account(record)
        if fire.kind == 'latency':
            time.sleep(fire.latency_s)
            return
        raise fire._make_error()

    @staticmethod
    def _account(record: Dict[str, Any]) -> None:
        """Count the injection; never raises."""
        try:
            from ..obs import counter

            counter('resil/faults_injected', unit='count').inc(
                1, point=record['point'], kind=record['kind']
            )
        except Exception:
            pass  # accounting must never mask (or add to) the injection

    # -- introspection ------------------------------------------------------

    @property
    def history(self) -> List[Dict[str, Any]]:
        """Every injection fired so far, in order (copies)."""
        with self._lock:
            return [dict(r) for r in self._history]

    @property
    def calls(self) -> Dict[str, int]:
        """Per-point call counts seen while armed (a copy)."""
        with self._lock:
            return dict(self._calls)

    def injections(self) -> int:
        """Total injections fired so far."""
        with self._lock:
            return len(self._history)


_ARM_LOCK = threading.Lock()
