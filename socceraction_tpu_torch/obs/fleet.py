"""Fleet aggregation: scrape N replicas, merge, judge staleness/divergence.

A copy of the JAX package's ``socceraction_tpu/obs/fleet.py``, the
front-end half of the cross-process telemetry plane
(:mod:`~socceraction_tpu_torch.obs.wire` is the format,
:mod:`~socceraction_tpu_torch.obs.endpoint` the per-replica surface). The
documents are the JAX package's, so one aggregator of either package can
watch replicas of both:

- :class:`FleetAggregator` — holds the replica roster (bounded ids →
  endpoint addresses), **scrapes** or **ingests** their wire documents,
  and :meth:`~FleetAggregator.aggregate`\\ s them into one
  :class:`FleetSnapshot`: the merged metrics
  (:func:`~socceraction_tpu_torch.obs.wire.merge_wires` semantics),
  per-replica staleness, a mesh-wide SLO evaluation and a per-replica
  divergence table.
- **Staleness is a loud fleet-health fact.** A replica whose scrape
  failed, or whose last document is older than ``stale_after_s``, is
  flagged ``stale``, counted in ``fleet/replicas{state="stale"}``, ages
  in ``fleet/scrape_age_seconds{replica=...}`` and degrades the fleet
  ``status`` — its last-known counters stay IN the merged sums (a dead
  replica must never become a silent hole that makes fleet totals dip),
  they just stop moving, which the staleness flag explains.
- **Mesh-wide SLO.** With an ``slo=``
  :class:`~socceraction_tpu_torch.obs.slo.SLOConfig`, the aggregator runs
  a :class:`~socceraction_tpu_torch.obs.slo.SLOEngine` whose snapshot
  source is the *merged* fleet snapshot — the replicas' ``slo/events``
  counters sum under counter-merge semantics, so burn rates and
  ``should_shed()`` describe the whole mesh's error budget.
- **Divergence: the "one replica degrades alone" signal.** Per replica,
  a small set of health signals (worst request p99, parity error,
  breaker state, error rate) is compared against the fleet median;
  a replica ``sick_factor`` (default 3×) past the median — or with a
  non-closed breaker — is flagged ``sick``: a replica can be locally
  "healthy" while being 10× slower than its peers. Rows exist only for
  signals some replica reports.

Stdlib only: the module imports neither torch nor jax.
"""

from __future__ import annotations

import statistics
import threading
import time
from typing import Any, Callable, Dict, List, Mapping, NamedTuple, Optional, Sequence, Tuple, Union

from .metrics import (
    REGISTRY,
    MetricRegistry,
    RegistrySnapshot,
)
from .wire import (
    REPLICAS,
    ReplicaRegistry,
    WireError,
    decode_snapshot,
    merge_wires,
    typed_snapshot_from_dict,
)

__all__ = ['FleetAggregator', 'FleetSnapshot', 'ReplicaState']

#: the divergence signals, each read from one replica's wire metrics
DIVERGENCE_SIGNALS = (
    'request_p99_s', 'parity_max_abs_err', 'error_rate', 'breaker_state',
)


class ReplicaState(NamedTuple):
    """One replica's aggregation-time standing."""

    replica: str
    address: Optional[str]
    reachable: bool
    stale: bool
    age_s: Optional[float]  # since the last successful scrape/ingest
    time_unix: Optional[float]  # the last wire document's capture time
    error: Optional[str]  # last scrape failure, when unreachable


class FleetSnapshot(NamedTuple):
    """One aggregation pass over the fleet."""

    status: str  # 'ok' | 'degraded' | 'empty'
    replicas: Tuple[ReplicaState, ...]
    metrics: Dict[str, Any]  # merged snapshot dict (merge_wires shape)
    slo: Optional[Dict[str, Any]]  # mesh-wide SLOEngine.evaluate() output
    divergence: Tuple[Dict[str, Any], ...]

    @property
    def stale_replicas(self) -> Tuple[str, ...]:
        """Ids of the replicas flagged stale in this pass."""
        return tuple(r.replica for r in self.replicas if r.stale)

    def typed(self) -> 'RegistrySnapshot':
        """The merged metrics as a typed ``RegistrySnapshot``."""
        return typed_snapshot_from_dict(self.metrics)


class _ReplicaSlot:
    __slots__ = ('address', 'wire', 'scraped_t', 'reachable', 'error')

    def __init__(self, address: Optional[str]) -> None:
        self.address = address
        self.wire: Optional[Dict[str, Any]] = None
        self.scraped_t: Optional[float] = None
        self.reachable = True
        self.error: Optional[str] = None


class _FleetSLOView:
    """The registry the mesh-wide SLO engine runs against.

    ``snapshot()`` reads the aggregator's LAST MERGED fleet snapshot
    (so burn windows difference mesh-wide cumulative counters), while
    instrument creation delegates to a private output registry — the
    engine's ``slo/*`` burn/budget gauges land there, never colliding
    with a front-end process's own local SLO engine writing the same
    names into the process registry.
    """

    def __init__(self, aggregator: 'FleetAggregator') -> None:
        self._aggregator = aggregator
        self._out = MetricRegistry()

    def snapshot(self) -> 'RegistrySnapshot':
        return typed_snapshot_from_dict(self._aggregator._last_merged)

    def counter(self, name: str, **kwargs: Any) -> Any:
        return self._out.counter(name, **kwargs)

    def gauge(self, name: str, **kwargs: Any) -> Any:
        return self._out.gauge(name, **kwargs)

    def histogram(self, name: str, **kwargs: Any) -> Any:
        return self._out.histogram(name, **kwargs)


class FleetAggregator:
    """Scrape/ingest N replica snapshots and aggregate them (see module).

    Parameters
    ----------
    replicas : mapping, optional
        ``{replica_id: endpoint_address}`` roster for the pull
        (:meth:`scrape`) mode; addresses are anything
        :func:`~socceraction_tpu_torch.obs.endpoint.parse_address` accepts.
        Push/post-mortem consumers skip it and call :meth:`ingest`.
    stale_after_s : float
        A replica whose last successful document is older than this is
        ``stale`` (unreachable replicas are stale immediately).
    sick_factor : float
        Divergence threshold: a replica's signal past ``sick_factor ×``
        the fleet median is flagged sick.
    slo : SLOConfig, optional
        Mesh-wide objectives, evaluated over the merged snapshot on
        every :meth:`aggregate`.
    registry : MetricRegistry, optional
        Where the ``fleet/*`` instruments land (default: the process
        registry — the front end's own exposition then includes them).
    replica_registry : ReplicaRegistry, optional
        The bounded id registry (default: the process-wide
        :data:`~socceraction_tpu_torch.obs.wire.REPLICAS`).
    scrape_timeout_s : float
        Per-replica scrape timeout.
    time_fn : callable
        Monotonic clock (injectable for tests).
    """

    def __init__(
        self,
        replicas: Optional[Mapping[str, Any]] = None,
        *,
        stale_after_s: float = 10.0,
        sick_factor: float = 3.0,
        slo: Any = None,
        registry: Optional[MetricRegistry] = None,
        replica_registry: Optional[ReplicaRegistry] = None,
        scrape_timeout_s: float = 5.0,
        time_fn: Callable[[], float] = time.monotonic,
    ) -> None:
        self.stale_after_s = float(stale_after_s)
        self.sick_factor = float(sick_factor)
        self.scrape_timeout_s = float(scrape_timeout_s)
        self._registry = registry if registry is not None else REGISTRY
        self._replica_registry = (
            replica_registry if replica_registry is not None else REPLICAS
        )
        self._time = time_fn
        self._lock = threading.Lock()
        self._slots: Dict[str, _ReplicaSlot] = {}
        self._last_merged: Dict[str, Any] = {}
        self._slo_engine = None
        if slo is not None:
            from .slo import SLOEngine

            self._slo_view = _FleetSLOView(self)
            self._slo_engine = SLOEngine(
                slo, registry=self._slo_view, time_fn=time_fn
            )
        for replica_id, address in (replicas or {}).items():
            self.add_replica(replica_id, address)

    # -- roster ------------------------------------------------------------

    def add_replica(self, replica_id: str, address: Optional[Any] = None) -> None:
        """Register one replica slot (id governed by the bounded registry)."""
        replica_id = self._replica_registry.register(replica_id)
        with self._lock:
            slot = self._slots.get(replica_id)
            if slot is None:
                self._slots[replica_id] = _ReplicaSlot(
                    str(address) if address is not None else None
                )
            elif address is not None:
                slot.address = str(address)

    @property
    def replicas(self) -> Tuple[str, ...]:
        """The registered replica slot ids, in registration order."""
        with self._lock:
            return tuple(self._slots)

    def last_wire(self, replica_id: str) -> Optional[Dict[str, Any]]:
        """The replica's last successfully scraped/ingested document."""
        with self._lock:
            slot = self._slots.get(replica_id)
            return dict(slot.wire) if slot is not None and slot.wire else None

    # -- intake ------------------------------------------------------------

    def ingest(self, wire: Union[str, bytes, Mapping[str, Any]]) -> str:
        """Accept one pushed/post-mortem wire document; returns its replica.

        The push half of the plane (and the ``obsctl fleet`` runlog
        path): a replica that cannot be scraped — batch jobs, closed
        run logs — hands its document in directly. The document's own
        ``replica`` field names the slot (created on first ingest).
        """
        doc = decode_snapshot(wire)
        replica_id = self._replica_registry.register(str(doc['replica']))
        now = self._time()
        with self._lock:
            slot = self._slots.setdefault(replica_id, _ReplicaSlot(None))
            slot.wire = doc
            slot.scraped_t = now
            slot.reachable = True
            slot.error = None
        return replica_id

    def _scrape_one(self, replica_id: str, address: str) -> bool:
        from .endpoint import EndpointError, scrape

        try:
            doc = scrape(address, timeout=self.scrape_timeout_s)
            got = str(doc['replica'])
            if got != replica_id:
                raise WireError(
                    f'endpoint {address!r} identifies as {got!r}, '
                    f'expected {replica_id!r} (roster miswired?)'
                )
            now = self._time()
            with self._lock:
                slot = self._slots[replica_id]
                slot.wire = doc
                slot.scraped_t = now
                slot.reachable = True
                slot.error = None
            return True
        except (EndpointError, WireError) as e:
            with self._lock:
                slot = self._slots[replica_id]
                slot.reachable = False
                slot.error = f'{type(e).__name__}: {e}'
            return False

    def scrape(self) -> Dict[str, bool]:
        """One scrape pass over every addressed replica, **in parallel**.

        Returns ``{replica: ok}``. A failed scrape marks the replica
        unreachable (stale from the next :meth:`aggregate` on) and
        counts ``fleet/scrapes{replica, outcome="error"}`` — the
        replica's last-known document is KEPT for the merge. The whole
        pass's wall lands in ``fleet/scrape_seconds``. Replicas are
        scraped concurrently so the pass wall is bounded by the slowest
        single replica, not the sum: a serial pass would let two dead
        endpoints' timeouts age a healthy first replica past
        ``stale_after_s`` and misflag it stale.
        """
        import concurrent.futures

        scrapes = self._registry.counter('fleet/scrapes', unit='count')
        outcomes: Dict[str, bool] = {}
        with self._lock:
            targets = [
                (replica_id, slot.address)
                for replica_id, slot in self._slots.items()
                if slot.address is not None
            ]
        t0 = time.perf_counter()
        if targets:
            with concurrent.futures.ThreadPoolExecutor(
                max_workers=min(len(targets), 16),
                thread_name_prefix='fleet-scrape',
            ) as pool:
                futures = {
                    replica_id: pool.submit(
                        self._scrape_one, replica_id, address
                    )
                    for replica_id, address in targets
                }
            for replica_id, future in futures.items():
                ok = future.result()
                scrapes.inc(
                    1, replica=replica_id, outcome='ok' if ok else 'error'
                )
                outcomes[replica_id] = ok
        self._registry.histogram('fleet/scrape_seconds', unit='s').observe(
            time.perf_counter() - t0
        )
        return outcomes

    # -- aggregation -------------------------------------------------------

    def aggregate(self) -> FleetSnapshot:
        """Merge the replicas' last documents into one fleet snapshot.

        Pure host work over already-scraped documents (pair with
        :meth:`scrape` for the pull loop). Records the ``fleet/*``
        staleness gauges and ``fleet/merge_seconds``, re-evaluates the
        mesh-wide SLO engine when configured, and computes the
        divergence table.
        """
        now = self._time()
        with self._lock:
            slots = dict(self._slots)
        states: List[ReplicaState] = []
        wires: List[Dict[str, Any]] = []
        age_gauge = self._registry.gauge(
            'fleet/scrape_age_seconds', unit='s'
        )
        for replica_id, slot in slots.items():
            age = (
                now - slot.scraped_t if slot.scraped_t is not None else None
            )
            stale = (
                not slot.reachable
                or age is None
                or age > self.stale_after_s
            )
            if age is not None:
                age_gauge.set(age, replica=replica_id)
            if slot.wire is not None:
                wires.append(slot.wire)
            states.append(
                ReplicaState(
                    replica=replica_id,
                    address=slot.address,
                    reachable=slot.reachable and slot.wire is not None,
                    stale=stale,
                    age_s=age,
                    time_unix=(
                        float(slot.wire.get('time_unix'))
                        if slot.wire is not None
                        and slot.wire.get('time_unix') is not None
                        else None
                    ),
                    error=slot.error,
                )
            )
        n_stale = sum(1 for s in states if s.stale)
        replicas_gauge = self._registry.gauge('fleet/replicas', unit='count')
        replicas_gauge.set(len(states) - n_stale, state='ok')
        replicas_gauge.set(n_stale, state='stale')
        t0 = time.perf_counter()
        merged = merge_wires(
            wires, registry=self._replica_registry
        ) if wires else {}
        self._registry.histogram('fleet/merge_seconds', unit='s').observe(
            time.perf_counter() - t0
        )
        with self._lock:
            self._last_merged = merged
        slo_eval = None
        if self._slo_engine is not None and merged:
            slo_eval = self._slo_engine.evaluate()
        divergence = self._divergence(slots)
        if n_stale:
            from .recorder import RECORDER

            RECORDER.record(
                'fleet_stale_replicas',
                replicas=[s.replica for s in states if s.stale],
                stale_after_s=self.stale_after_s,
            )
        status = (
            'empty' if not states
            else 'degraded' if n_stale or any(
                row['sick'] for row in divergence
            )
            else 'ok'
        )
        return FleetSnapshot(
            status=status,
            replicas=tuple(states),
            metrics=merged,
            slo=slo_eval,
            divergence=tuple(divergence),
        )

    def should_shed(self, kind: str = 'rate') -> Tuple[bool, Optional[Dict[str, Any]]]:
        """Mesh-wide admission verdict (None-config: never sheds).

        The front-end hook: same contract as
        :meth:`SLOEngine.should_shed`, evaluated over the merged fleet
        snapshot from the last :meth:`aggregate`.
        """
        if self._slo_engine is None:
            return False, None
        return self._slo_engine.should_shed(kind)

    # -- divergence --------------------------------------------------------

    @staticmethod
    def _replica_signals(metrics: Mapping[str, Any]) -> Dict[str, float]:
        """The divergence signals of ONE replica's wire metrics."""

        def series(name: str) -> Sequence[Mapping[str, Any]]:
            return (metrics.get(name) or {}).get('series', ())

        signals: Dict[str, float] = {}
        p99s = [
            float((s.get('quantiles') or {}).get('p99'))
            for s in series('serve/request_seconds')
            if (s.get('labels') or {}).get('kind') != 'warmup'
            and (s.get('quantiles') or {}).get('p99') is not None
        ]
        if p99s:
            signals['request_p99_s'] = max(p99s)
        parity = [
            float(s['max'])
            for s in series('num/parity_abs_err')
            if s.get('max') is not None
        ]
        if parity:
            signals['parity_max_abs_err'] = max(parity)
        good = bad = 0.0
        for s in series('slo/events'):
            outcome = (s.get('labels') or {}).get('outcome')
            if outcome == 'good':
                good += float(s.get('total') or 0.0)
            elif outcome == 'bad':
                bad += float(s.get('total') or 0.0)
        if good + bad > 0:
            signals['error_rate'] = bad / (good + bad)
        breaker = [
            float(s['last'])
            for s in series('resil/breaker_state')
            if s.get('last') is not None
        ]
        if breaker:
            signals['breaker_state'] = max(breaker)
        return signals

    def _divergence(
        self, slots: Mapping[str, _ReplicaSlot]
    ) -> List[Dict[str, Any]]:
        """Per-replica signals vs the fleet median, sick replicas flagged.

        Rows only exist for signals at least one replica reports; the
        divergence gauge ``fleet/divergence{replica, signal}`` carries
        the value/median ratio (1.0 == at the median) so a dashboard
        can alert on the shape, not on absolute units.
        """
        per_replica = {
            replica_id: self._replica_signals(slot.wire.get('metrics') or {})
            for replica_id, slot in slots.items()
            if slot.wire is not None
        }
        div_gauge = self._registry.gauge('fleet/divergence', unit='ratio')
        rows: List[Dict[str, Any]] = []
        for signal in DIVERGENCE_SIGNALS:
            values = {
                replica_id: signals[signal]
                for replica_id, signals in per_replica.items()
                if signal in signals
            }
            if not values:
                continue
            median = statistics.median(values.values())
            for replica_id, value in sorted(values.items()):
                if signal == 'breaker_state':
                    # states are categorical (0 closed / 1 half-open /
                    # 2 open): any non-closed breaker is the signal,
                    # regardless of what the median replica is doing
                    ratio = None
                    sick = value != 0.0
                else:
                    ratio = (
                        value / median if median > 0.0
                        else (float('inf') if value > 0.0 else 1.0)
                    )
                    sick = bool(
                        ratio is not None and ratio >= self.sick_factor
                    )
                if ratio is not None:
                    div_gauge.set(ratio, replica=replica_id, signal=signal)
                rows.append(
                    {
                        'signal': signal,
                        'replica': replica_id,
                        'value': value,
                        'median': median,
                        'ratio': ratio,
                        'sick': sick,
                    }
                )
        return rows
