"""SLO engine: declarative objectives, multi-window burn rates, shedding.

A copy of the JAX package's ``socceraction_tpu/obs/slo.py``, for the
serving layer: service-level objectives evaluated as **error-budget burn
rates** over two windows, the admission-control input that sheds load by
SLO rather than by queue depth alone.

- :class:`SLOObjective` — one promise: a latency objective per traffic
  kind ("99% of ``rate`` requests complete within 250 ms"), an
  error-rate objective ("99.9% of requests succeed"), or a
  model-freshness objective ("the serving model is never older than
  N seconds").
- :class:`SLOConfig` — the objective set plus the evaluation windows and
  the shed threshold. :meth:`SLOConfig.simple` builds the common shape
  in one call.
- :class:`SLOEngine` — feeds per-request outcomes into the governed
  ``slo/events{objective, outcome}`` counters and evaluates burn rates
  **over the typed registry snapshot**: the engine keeps a ring of
  ``(t, cumulative totals)`` samples and differences them at the fast
  and slow window boundaries, so the arithmetic is reproducible from
  the same counters an external scraper sees.

Burn rate semantics (the multi-window form used for paging): with a
target of ``t``, the error budget is ``1 - t``; the burn rate over a
window is ``bad_fraction / (1 - t)`` — 1.0 means the budget is being
consumed exactly at the sustainable rate, higher means faster.
:meth:`SLOEngine.should_shed` trips only when the burn rate exceeds the
threshold over **both** windows: the slow window keeps a brief spike
from shedding, the fast window makes recovery quick once the burn
stops. A breach (either-window transition into burning) fires the
``on_breach`` hook once per episode.

Stdlib only.
"""

from __future__ import annotations

import threading
import time
from collections import deque
from dataclasses import dataclass
from typing import Any, Callable, Dict, List, Mapping, Optional, Tuple

from .metrics import REGISTRY, MetricRegistry

__all__ = ['SLOConfig', 'SLOEngine', 'SLOObjective']

_TERMINAL = ('ok', 'error', 'expired')


@dataclass(frozen=True)
class SLOObjective:
    """One service-level promise.

    ``kind``:

    - ``'latency'`` — ``target`` of completed requests (optionally only
      those of ``request_kind``) must finish within ``latency_ms``;
      failed requests are the error objective's business, not this one's.
    - ``'error'`` — ``target`` of terminal requests must succeed
      (``error`` and deadline-``expired`` outcomes are bad).
    - ``'freshness'`` — the active model must be younger than
      ``max_age_s``. Evaluated instantaneously (no event stream) and
      never sheds: rejecting traffic cannot make a model younger.
    """

    name: str
    kind: str = 'latency'
    target: float = 0.99
    latency_ms: Optional[float] = None
    request_kind: Optional[str] = None
    max_age_s: Optional[float] = None

    def __post_init__(self) -> None:
        if self.kind not in ('latency', 'error', 'freshness'):
            raise ValueError(f'unknown objective kind {self.kind!r}')
        if not (0.0 < self.target < 1.0):
            raise ValueError(
                f'{self.name}: target must be in (0, 1), got {self.target!r}'
            )
        if self.kind == 'latency' and self.latency_ms is None:
            raise ValueError(f'{self.name}: latency objectives need latency_ms')
        if self.kind == 'freshness' and self.max_age_s is None:
            raise ValueError(f'{self.name}: freshness objectives need max_age_s')


@dataclass(frozen=True)
class SLOConfig:
    """The objective set plus burn-rate evaluation parameters.

    ``shed_burn_rate`` is the admission-control threshold: a sheddable
    objective burning faster than this over BOTH windows sheds new
    traffic. ``min_events`` refuses to act on windows with too few
    terminal requests (no evidence, no shedding — the opposite
    fail-direction from the promotion gate, deliberately: an idle
    service must accept its first requests).
    """

    objectives: Tuple[SLOObjective, ...]
    fast_window_s: float = 60.0
    slow_window_s: float = 600.0
    shed_burn_rate: float = 4.0
    min_events: int = 20
    eval_interval_s: float = 0.25

    def __post_init__(self) -> None:
        if not self.objectives:
            raise ValueError('an SLOConfig needs at least one objective')
        names = [o.name for o in self.objectives]
        if len(set(names)) != len(names):
            raise ValueError(f'duplicate objective names in {names}')
        if self.fast_window_s >= self.slow_window_s:
            raise ValueError('fast_window_s must be < slow_window_s')

    @classmethod
    def simple(
        cls,
        *,
        latency_ms: Any = 250.0,
        latency_target: float = 0.99,
        error_target: float = 0.999,
        model_freshness_s: Optional[float] = None,
        **kwargs: Any,
    ) -> 'SLOConfig':
        """The common shape in one call.

        ``latency_ms`` is either one budget for all traffic or a
        ``{request_kind: ms}`` mapping (one objective per kind — the
        "latency objective per bucket kind" form, e.g. tighter for
        ``session`` ticks than for whole-match ``rate`` calls).
        Remaining ``kwargs`` go to :class:`SLOConfig` (windows,
        threshold, ...).
        """
        objectives: List[SLOObjective] = []
        if isinstance(latency_ms, Mapping):
            for kind, ms in sorted(latency_ms.items()):
                objectives.append(
                    SLOObjective(
                        name=f'latency_{kind}', kind='latency',
                        target=latency_target, latency_ms=float(ms),
                        request_kind=str(kind),
                    )
                )
        else:
            objectives.append(
                SLOObjective(
                    name='latency', kind='latency', target=latency_target,
                    latency_ms=float(latency_ms),
                )
            )
        objectives.append(
            SLOObjective(name='errors', kind='error', target=error_target)
        )
        if model_freshness_s is not None:
            objectives.append(
                SLOObjective(
                    name='model_freshness', kind='freshness', target=0.99,
                    max_age_s=float(model_freshness_s),
                )
            )
        return cls(objectives=tuple(objectives), **kwargs)


class SLOEngine:
    """Feeds request outcomes into ``slo/*`` and evaluates burn rates.

    Parameters
    ----------
    config : SLOConfig
    model_age_s : callable, optional
        Zero-arg callable returning the active model's age in seconds
        (freshness objectives evaluate against it; absent, they report
        unknown).
    on_breach : callable, optional
        ``on_breach(objective_name, evaluation_entry)`` fired once per
        burn episode, on the thread that ran the evaluation. The service
        hooks its rate-limited debug-bundle dump here; the hook must not
        raise (it is swallowed if it does).
    registry : MetricRegistry, optional
        Where the ``slo/*`` instruments live (default: the process
        registry). The burn-rate arithmetic reads the same counters
        back through :meth:`MetricRegistry.snapshot`.
    time_fn : callable
        Monotonic clock (injectable for tests).
    """

    def __init__(
        self,
        config: SLOConfig,
        *,
        model_age_s: Optional[Callable[[], float]] = None,
        on_breach: Optional[Callable[[str, Dict[str, Any]], None]] = None,
        registry: Optional[MetricRegistry] = None,
        time_fn: Callable[[], float] = time.monotonic,
    ) -> None:
        self.config = config
        self._model_age_s = model_age_s
        self._on_breach = on_breach
        self._registry = registry if registry is not None else REGISTRY
        self._time = time_fn
        self._lock = threading.Lock()
        #: (t, {objective: (good_total, bad_total)}) cumulative samples
        self._history: 'deque[Tuple[float, Dict[str, Tuple[float, float]]]]' = (
            deque()
        )
        self._breaching: Dict[str, bool] = {}
        self._last_eval_t: Optional[float] = None
        self._last_eval: Optional[Dict[str, Any]] = None
        # baseline sample: the registry's totals at engine birth, so one
        # later evaluation already has a window start to difference
        # against (and counters that predate this engine — a shared
        # registry — are never charged to its first window)
        self._history.append((self._time(), self._totals()))

    # -- event intake ------------------------------------------------------

    def observe_request(self, kind: str, wall_s: float, status: str) -> None:
        """Score one terminal request against every matching objective.

        ``status`` is the batcher's terminal state (``ok`` | ``error`` |
        ``expired``). Latency objectives judge only completed requests;
        the error objective counts failures and expiries as budget burn.
        """
        if status not in _TERMINAL:
            raise ValueError(f'unknown terminal status {status!r}')
        events = self._registry.counter('slo/events', unit='requests')
        for obj in self.config.objectives:
            if obj.kind == 'latency':
                if obj.request_kind is not None and obj.request_kind != kind:
                    continue
                if status != 'ok':
                    continue
                outcome = 'good' if wall_s * 1e3 <= obj.latency_ms else 'bad'
            elif obj.kind == 'error':
                outcome = 'good' if status == 'ok' else 'bad'
            else:  # freshness: no event stream
                continue
            events.inc(1, objective=obj.name, outcome=outcome)

    # -- burn-rate evaluation ----------------------------------------------

    def _totals(self) -> Dict[str, Tuple[float, float]]:
        """Cumulative (good, bad) per objective from the typed snapshot."""
        snap = self._registry.snapshot()
        return {
            obj.name: (
                snap.value('slo/events', objective=obj.name, outcome='good'),
                snap.value('slo/events', objective=obj.name, outcome='bad'),
            )
            for obj in self.config.objectives
            if obj.kind != 'freshness'
        }

    def _window_delta(
        self, name: str, now: float, window_s: float
    ) -> Tuple[float, float]:
        """(good, bad) accumulated over the trailing window (locked)."""
        current = self._history[-1][1].get(name, (0.0, 0.0))
        base = self._history[0][1].get(name, (0.0, 0.0))
        cutoff = now - window_s
        for t, totals in self._history:
            if t > cutoff:
                break
            base = totals.get(name, (0.0, 0.0))
        return (
            max(0.0, current[0] - base[0]),
            max(0.0, current[1] - base[1]),
        )

    def evaluate(self, now: Optional[float] = None) -> Dict[str, Any]:
        """One burn-rate evaluation pass; records the ``slo/*`` gauges.

        Returns ``{'objectives': {name: entry}, 'shed_burn_rate': ...}``
        where each entry carries the per-window burn rates (None while
        the window holds fewer than ``min_events`` terminal requests),
        the remaining error-budget fraction over the slow window, and
        ``breaching``. Cheap enough to call per health poll; admission
        control uses the cached form (:meth:`should_shed`).
        """
        cfg = self.config
        now = self._time() if now is None else now
        totals = self._totals()
        breach_fires: List[Tuple[str, Dict[str, Any]]] = []
        with self._lock:
            if self._history:
                prev = self._history[-1][1]
                # a registry reset (a measurement pass does this) rewinds the
                # cumulative counters; stale history would then produce
                # negative deltas — start over instead
                if any(
                    totals.get(k, (0.0, 0.0))[0] < g
                    or totals.get(k, (0.0, 0.0))[1] < b
                    for k, (g, b) in prev.items()
                ):
                    self._history.clear()
            self._history.append((now, totals))
            horizon = now - cfg.slow_window_s
            while len(self._history) > 2 and self._history[1][0] <= horizon:
                self._history.popleft()
            out: Dict[str, Any] = {
                'objectives': {},
                'shed_burn_rate': cfg.shed_burn_rate,
                'windows_s': [cfg.fast_window_s, cfg.slow_window_s],
            }
            gauges = {
                'burn': self._registry.gauge('slo/burn_rate', unit='ratio'),
                'budget': self._registry.gauge(
                    'slo/budget_remaining', unit='ratio'
                ),
                'age': self._registry.gauge('slo/model_age_seconds', unit='s'),
            }
            for obj in cfg.objectives:
                if obj.kind == 'freshness':
                    entry = self._eval_freshness(obj, gauges)
                else:
                    entry = self._eval_windows(obj, now, gauges)
                was = self._breaching.get(obj.name, False)
                self._breaching[obj.name] = entry['breaching']
                if entry['breaching'] and not was:
                    self._registry.counter('slo/breaches', unit='count').inc(
                        1, objective=obj.name
                    )
                    breach_fires.append((obj.name, entry))
                out['objectives'][obj.name] = entry
            self._last_eval_t = now
            self._last_eval = out
        for name, entry in breach_fires:
            from .recorder import RECORDER

            RECORDER.record('slo_breach', objective=name, evaluation=entry)
            if self._on_breach is not None:
                try:
                    self._on_breach(name, entry)
                except Exception:
                    pass
        return out

    def _eval_windows(
        self, obj: SLOObjective, now: float, gauges: Dict[str, Any]
    ) -> Dict[str, Any]:
        budget = 1.0 - obj.target
        entry: Dict[str, Any] = {
            'kind': obj.kind,
            'target': obj.target,
            'latency_ms': obj.latency_ms,
            'request_kind': obj.request_kind,
        }
        burns: Dict[str, Optional[float]] = {}
        for window, window_s in (
            ('fast', self.config.fast_window_s),
            ('slow', self.config.slow_window_s),
        ):
            good, bad = self._window_delta(obj.name, now, window_s)
            n = good + bad
            entry[f'window_events_{window}'] = int(n)
            if n < self.config.min_events:
                burns[window] = None
                entry[f'burn_rate_{window}'] = None
                continue
            burn = (bad / n) / budget
            burns[window] = burn
            entry[f'burn_rate_{window}'] = round(burn, 4)
            gauges['burn'].set(burn, objective=obj.name, window=window)
        slow = burns.get('slow')
        remaining = 1.0 if slow is None else max(0.0, 1.0 - slow)
        entry['budget_remaining'] = round(remaining, 4)
        gauges['budget'].set(remaining, objective=obj.name)
        entry['breaching'] = bool(
            burns.get('fast') is not None
            and slow is not None
            and burns['fast'] > self.config.shed_burn_rate
            and slow > self.config.shed_burn_rate
        )
        entry['ok'] = not entry['breaching']
        return entry

    def _eval_freshness(
        self, obj: SLOObjective, gauges: Dict[str, Any]
    ) -> Dict[str, Any]:
        age = None
        if self._model_age_s is not None:
            try:
                age = float(self._model_age_s())
            except Exception:
                age = None
        entry: Dict[str, Any] = {
            'kind': 'freshness',
            'max_age_s': obj.max_age_s,
            'age_s': None if age is None else round(age, 3),
        }
        if age is None:
            entry.update(budget_remaining=None, breaching=False, ok=None)
            return entry
        gauges['age'].set(age)
        entry['budget_remaining'] = round(
            max(0.0, 1.0 - age / obj.max_age_s), 4
        )
        entry['breaching'] = bool(age > obj.max_age_s)
        entry['ok'] = not entry['breaching']
        return entry

    # -- admission control -------------------------------------------------

    def _cached_eval(self) -> Dict[str, Any]:
        with self._lock:
            fresh = (
                self._last_eval is not None
                and self._last_eval_t is not None
                and self._time() - self._last_eval_t
                < self.config.eval_interval_s
            )
            if fresh:
                return self._last_eval
        return self.evaluate()

    def should_shed(self, kind: str = 'rate') -> Tuple[bool, Optional[Dict[str, Any]]]:
        """Admission verdict for one incoming request of traffic ``kind``.

        Sheds when any sheddable objective covering this kind is burning
        past the threshold over both windows. Returns ``(shed, reason)``
        where ``reason`` is the machine-readable rejection payload
        (objective, burn rates, threshold, windows, budget remaining) —
        what :class:`SLOShed` carries to the caller. The evaluation is
        cached for ``eval_interval_s``, so per-request admission costs a
        dict lookup, not a registry snapshot.
        """
        ev = self._cached_eval()
        for obj in self.config.objectives:
            if obj.kind == 'freshness':
                continue  # a stale model is not fixed by rejecting traffic
            if (
                obj.kind == 'latency'
                and obj.request_kind is not None
                and obj.request_kind != kind
            ):
                continue
            entry = ev['objectives'][obj.name]
            if entry['breaching']:
                return True, {
                    'objective': obj.name,
                    'kind': obj.kind,
                    'target': obj.target,
                    'burn_rate_fast': entry['burn_rate_fast'],
                    'burn_rate_slow': entry['burn_rate_slow'],
                    'threshold': self.config.shed_burn_rate,
                    'windows_s': ev['windows_s'],
                    'budget_remaining': entry['budget_remaining'],
                }
        return False, None
