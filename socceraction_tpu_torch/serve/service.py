"""The online rating service: micro-batched, shape-bucketed, hot-swappable.

Port of the rating core of the JAX package's
``socceraction_tpu/serve/service.py``. :class:`RatingService` is the
in-process front end that turns the batch-oriented valuation core
(``VAEP.rate_batch`` and kernel B1 behind it) into a multiplexed,
latency-bounded server:

- ``rate(actions) -> Future`` — rate one match's SPADL actions; packing
  happens on the calling thread, the dispatch is coalesced with every
  other concurrent request by the micro-batcher
  (:mod:`socceraction_tpu_torch.serve.batcher`) into power-of-two shape
  buckets, so steady traffic runs a pinned set of shapes;
- ``open_session(match_id, ...)`` — a per-match streaming
  :class:`~socceraction_tpu_torch.serve.session.MatchSession` that rates
  a live game in O(new actions) per tick through the same batcher;
- ``swap_model(name, version)`` / ``rollback_model()`` — atomic hot-swap
  via the :class:`~socceraction_tpu_torch.serve.registry.ModelRegistry`:
  each flush reads the active model once, so no request is ever rated by
  a half-swapped model;
- overload raises :class:`~socceraction_tpu_torch.serve.batcher.Overloaded`
  at ``rate()`` time (bounded queue — load is shed, not buffered forever);
- ``rate_scenarios(actions, grid) -> Future`` — value every perturbation
  of a :class:`~socceraction_tpu_torch.scenario.grid.ScenarioGrid` over
  one match in ONE dispatch: the perturbation axis is folded into the game
  axis at its own power-of-two bucket, so a ``b``-perturbation flush is
  the shape of a ``b``-game rate flush (one B1 launch);
- SLO admission (``slo=``): past the burn threshold over both windows,
  submissions raise :class:`SLOShed` (an ``Overloaded``);
- a circuit breaker on the fused dispatch
  (:class:`~socceraction_tpu_torch.resil.breaker.CircuitBreaker`) serves
  failing flushes through the materialized reference, except when the
  failure is the kernel's own: a
  :class:`~socceraction_tpu_torch.ops.cuda_build.KernelError` (B1 cannot
  build, load, launch or take its operands) or a CUDA error fails the
  flush's requests and never
  moves the breaker, so a broken kernel is never hidden behind the plain
  path. Rate and scenario flushes alike;
- a sampled parity probe (``parity=``) re-rates fused rate flushes
  through the reference off the flusher thread, on its own CUDA stream;
- a capture ring (``capture=``) records served traffic for the learning
  loop, and :meth:`RatingService.telemetry` exposes the service to the
  fleet's scrape surface;
- replica lanes (``n_replicas=N``): N flusher threads drain the one
  queue, each lane with its own breaker (``serve.dispatch.r{i}``), its
  ``replica=`` label and, on a card, its own CUDA stream; lane ``i`` sits
  on card ``i`` modulo the process's cards, so lanes share a card (and
  one copy of the weights) when there are fewer cards than lanes;
- a warm tier (``aot_dir=``, :meth:`RatingService.load_aot`, a registry
  version's ``aot/``): the kernel libraries shipped with a version are
  installed before warm-up, so a new replica runs no ``nvcc``
  (:mod:`socceraction_tpu_torch.serve.aot`).

The service runs on the device of the model it serves (its lanes on
theirs): each flush copies its padded host batch there, rates it, and
makes one copy of the values back; before that copy it reads only host
counts. A sampled flush hands the probe its card batch, goalscore block
and values before that copy. Every stage reports under the ``serve`` (and
``scenario``, ``slo``) telemetry areas, with the JAX package's names.
pandas is imported only inside the verbs that take or return frames.
"""

from __future__ import annotations

import contextlib
import dataclasses
import threading
import time
from collections import deque
from concurrent.futures import Future
from typing import TYPE_CHECKING, Any, Callable, Dict, List, Optional, Tuple

import numpy as np
import torch

from ..core.batch import (
    ActionBatch,
    bucket_window,
    pack_actions,
    pad_batch_games,
    unpack_values,
    window_ladder,
)
from ..obs import REGISTRY, counter, gauge, histogram, span
from ..obs.context import RequestContext, new_request_context, record_segment
from ..obs.numerics import drain_guards
from ..obs.parity import ParityProbe
from ..obs.perf import perf_snapshot, record_dispatch
from ..obs.recorder import default_debug_dir, dump_debug_bundle
from ..obs.residency import owned_bytes
from ..obs.slo import SLOConfig, SLOEngine
from ..ops.cuda_build import KernelError
from ..ops.gather_matmul import fused_first_layer_quant
from ..resil.breaker import CircuitBreaker
from ..resil.faults import fault_point
from ..scenario.engine import (
    bucket_perturbations,
    expand_scenarios,
    perturbation_ladder,
    rate_scenarios_reference,
)
from ..scenario.grid import ScenarioGrid, pad_perturbations
from .batcher import MicroBatcher, Overloaded
from .session import (
    WINDOW_LOCAL_KERNELS,
    MatchSession,
    goalscore_block,
    pack_window,
    score_prefix,
)

if TYPE_CHECKING:  # pandas is imported inside the verbs that take frames
    import pandas as pd

__all__ = ['RatingService', 'SLOShed']


class SLOShed(Overloaded):
    """Raised at submission when SLO burn-rate admission control sheds.

    An :class:`~socceraction_tpu_torch.serve.batcher.Overloaded`, so
    callers that handle queue overload keep working, but the cause
    differs: the service is burning its error budget past the threshold
    over both windows. ``reason`` is the machine-readable payload:
    objective, per-window burn rates, threshold, windows and remaining
    budget.
    """

    def __init__(self, reason: Dict[str, Any]) -> None:
        self.reason = dict(reason)
        super().__init__(
            'shedding by SLO burn rate: objective '
            f'{reason.get("objective")!r} burning at '
            f'{reason.get("burn_rate_fast")}x (fast) / '
            f'{reason.get("burn_rate_slow")}x (slow) of budget, '
            f'threshold {reason.get("threshold")}x '
            f'(budget remaining: {reason.get("budget_remaining")})'
        )


RATING_COLUMNS = ['offensive_value', 'defensive_value', 'vaep_value']

#: Failures that are the kernel's own: anything that stops B1 (its wrapper
#: raises every such error as a ``KernelError``, its refusals as
#: ``KernelRefused``), or a CUDA error surfacing at the values' copy.
#: Never degraded by the breaker.
_KERNEL_ERRORS: Tuple[type, ...] = (KernelError,) + tuple(
    e for e in (getattr(torch, 'AcceleratorError', None),) if e is not None
)


class _Payload:
    """One packed request: a staging batch plus its result recipe."""

    __slots__ = ('staging', 'gs', 'keep', 'index', 'ctx')

    def __init__(
        self,
        staging: Any,
        gs: Optional[np.ndarray],
        keep: Optional[Tuple[int, int]] = None,
        index: Any = None,
        ctx: Any = None,
    ) -> None:
        self.staging = staging  # host ActionBatch, (1, A) numpy fields
        self.gs = gs  # (1, A, 3) f32 goalscore block
        self.keep = keep  # None (whole frame) | (context, m) window slice
        self.index = index  # pandas index for frame requests
        self.ctx = ctx  # RequestContext (trace identity + segments)


class _ScenarioPayload:
    """One packed counterfactual request: a staging batch plus its grid.

    Rides the batcher's queue like :class:`_Payload` (admission, deadline
    expiry and SLO scoring apply unchanged) but dispatches as its own
    flush: the grid's perturbation axis folds into the game axis at its
    own power-of-two bucket.
    """

    __slots__ = ('staging', 'gs', 'grid', 'index', 'ctx')

    def __init__(
        self,
        staging: Any,
        gs: Optional[np.ndarray],
        grid: ScenarioGrid,
        index: Any = None,
        ctx: Any = None,
    ) -> None:
        self.staging = staging  # host ActionBatch, (1, A) numpy fields
        self.gs = gs  # (1, A, 3) f32 goalscore block
        self.grid = grid  # ScenarioGrid, P perturbations
        self.index = index  # pandas index of the request frame
        self.ctx = ctx  # RequestContext (trace identity + segments)


class RatingService:
    """In-process online rating server over a fitted VAEP model.

    Parameters
    ----------
    model : VAEP, optional
        A fitted standard-SPADL :class:`~socceraction_tpu_torch.vaep.base.VAEP`.
        Give either ``model`` or ``registry``. The service rates on the
        model's device.
    registry : ModelRegistry, optional
        A :class:`~socceraction_tpu_torch.serve.registry.ModelRegistry`
        whose active model serves traffic; enables :meth:`swap_model`.
    max_actions : int
        Fixed action-axis capacity of every device batch. A request or
        window longer than this is rejected at call time.
    max_batch_size : int
        Requests per flush cap == top of the bucket ladder.
    max_wait_ms : float
        Deadline bound: a lone request is dispatched at most this long
        after arrival.
    max_queue : int
        Admission bound; past it ``rate()`` raises
        :class:`~socceraction_tpu_torch.serve.batcher.Overloaded`.
    slo_p99_ms : float
        The p99 end-to-end latency budget :meth:`health` compares the
        measured ``serve/request_seconds`` p99 against (observability
        only; ``slo=`` is the form that sheds).
    slo : SLOConfig, optional
        Service-level objectives
        (:class:`~socceraction_tpu_torch.obs.slo.SLOConfig`). An
        :class:`~socceraction_tpu_torch.obs.slo.SLOEngine` scores every
        terminal request (warm-up excluded), :meth:`health` reports each
        objective's budget, a breach dumps a rate-limited debug bundle,
        and ``rate``, ``rate_scenarios`` and session ticks raise
        :class:`SLOShed` while an objective burns past the threshold over
        both windows. ``None``: shedding by queue depth only.
    request_deadline_ms : float, optional
        Default per-request deadline. A request still queued when its
        deadline passes is failed with
        :class:`~socceraction_tpu_torch.obs.context.DeadlineExceeded` —
        never dispatched. ``rate(deadline_ms=...)`` overrides per call.
    capture : TrafficCapture, optional
        A :class:`~socceraction_tpu_torch.serve.capture.TrafficCapture`
        ring recording served traffic (``rate`` requests whose futures
        succeeded, copied on the caller's thread, and committed session
        ticks) for the learning loop's shadow replay.
    parity : ParityProbe, optional
        A :class:`~socceraction_tpu_torch.obs.parity.ParityProbe`: a
        sampled fraction of fused rate flushes is re-rated through
        ``rate_batch_reference`` off the flusher thread. On a card the
        sample is handed over inside the dispatch, before the values'
        copy: the flush's card batch, goalscore block and values, read on
        the probe's own stream. An exceedance dumps a debug bundle and
        degrades :meth:`health`; the probe's stats feed the learning
        gate's ``max_parity_err``. Closed with the service.
    breaker : CircuitBreaker, optional
        The circuit breaker on the fused dispatch. ``breaker_failures``
        consecutive flush-level dispatch failures trip it open; flushes
        then route through the materialized reference
        (``rate_batch_reference``, on the same device) instead of failing
        callers, :meth:`health` reports ``'degraded'``, and after
        ``breaker_recovery_s`` one half-open probe flush tries the fused
        path again. A kernel that cannot run (``KernelError``, which
        ``KernelRefused`` is too, or a CUDA error) is not such a failure: it fails the flush's requests and
        leaves the breaker as it was. Pass an explicit instance to share
        or tune one, or ``breaker_failures=0`` to disable degradation.
    n_replicas : int
        Replica lanes. Above 1, N flusher threads share the one queue and
        every lane rates through the fused dispatch on its own device
        (:class:`~socceraction_tpu_torch.parallel.serve.ReplicaDispatcher`):
        lane ``i`` on card ``i`` modulo the cards of this process, on its
        own CUDA stream; a lane on the model's card shares the model's
        weights. Each lane gets its own breaker (``breaker=`` is refused),
        warms its own ladder and labels its series ``replica=r{i}``;
        :meth:`health` names sick lanes. A model that does not rate
        through the fused path is refused here.
    max_perturbations : int
        Top of the scenario verb's perturbation ladder
        (:attr:`scenario_ladder`, ``(1, 2, 4, ..., max_perturbations)``
        rounded up to a power of two); a grid with more perturbations is
        rejected at call time.
    aot_dir : str, optional
        Where this model-backed service's shipped kernel libraries live (an
        ``aot/`` directory from
        :func:`~socceraction_tpu_torch.serve.aot.export_serving_aot`). A
        registry-backed service reads each version's own ``aot/``.
    debug_dir : str, optional
        Where automatic flight-recorder bundles land (flusher-thread death,
        ``Overloaded`` bursts past ``overload_dump_threshold`` within
        ``overload_dump_window_s``, hot-swap failure, a breaker trip, a
        non-finite dispatch). Default:
        :func:`~socceraction_tpu_torch.obs.recorder.default_debug_dir`.
        Dumps are rate-limited to one per reason per ``dump_interval_s``.
    """

    def __init__(
        self,
        model: Any = None,
        registry: Any = None,
        *,
        max_actions: int = 1664,
        max_batch_size: int = 64,
        max_wait_ms: float = 2.0,
        max_queue: int = 256,
        slo_p99_ms: float = 250.0,
        slo: Optional[SLOConfig] = None,
        request_deadline_ms: Optional[float] = None,
        capture: Any = None,
        parity: Optional[ParityProbe] = None,
        breaker: Optional[CircuitBreaker] = None,
        breaker_failures: int = 3,
        breaker_recovery_s: float = 5.0,
        n_replicas: int = 1,
        max_perturbations: int = 4096,
        aot_dir: Optional[str] = None,
        debug_dir: Optional[str] = None,
        overload_dump_threshold: int = 64,
        overload_dump_window_s: float = 10.0,
        dump_interval_s: float = 60.0,
    ) -> None:
        if (model is None) == (registry is None):
            raise ValueError('give exactly one of model= or registry=')
        self.n_replicas = int(n_replicas)
        if self.n_replicas < 1:
            raise ValueError('n_replicas must be >= 1')
        self.max_perturbations = int(max_perturbations)
        if self.max_perturbations < 1:
            raise ValueError('max_perturbations must be >= 1')
        self._registry = registry
        self._model = None
        if model is not None:
            self._validate_model(model)
            self._model = model
            first = model
        else:
            first = registry.active()[2]
            self._validate_model(first)
        # whether requests must carry the host goalscore block: invariant
        # across swaps (swap_model rejects feature-layout changes), so
        # models without the kernel never pay the per-request prefix work
        self._gs_enabled = 'goalscore' in first.xfns
        self.max_actions = int(max_actions)
        self.slo_p99_ms = float(slo_p99_ms)
        self.capture = capture
        self.parity: Optional[ParityProbe] = parity
        if parity is not None and parity.on_exceed is None:
            parity.on_exceed = self._on_parity_exceed
        #: nonfinite guard events drained by THIS service's flushes (the
        #: pending-guard ring is process-global: whichever flush drains
        #: first absorbs an event, which errs fail-closed on purpose)
        self._nonfinite_events = 0
        self.debug_dir = debug_dir or default_debug_dir()
        self.overload_dump_threshold = int(overload_dump_threshold)
        self.overload_dump_window_s = float(overload_dump_window_s)
        self.dump_interval_s = float(dump_interval_s)
        self.last_dump_path: Optional[str] = None
        self._dump_lock = threading.Lock()
        self._last_dump_t: Dict[str, float] = {}
        # the breach dumps' threads, joined by close()
        self._dumps: List[threading.Thread] = []
        self._overloads: 'deque[float]' = deque()
        self._started_t = time.monotonic()
        self.request_deadline_ms = request_deadline_ms
        self._model_activated_t = time.monotonic()
        self._slo: Optional[SLOEngine] = (
            SLOEngine(
                slo,
                model_age_s=lambda: time.monotonic() - self._model_activated_t,
                on_breach=self._on_slo_breach,
            )
            if slo is not None
            else None
        )
        if self.n_replicas > 1:
            if breaker is not None:
                raise ValueError(
                    'a shared breaker instance defeats per-replica '
                    'degradation; with n_replicas > 1 the service builds '
                    'one breaker per replica from breaker_failures/'
                    'breaker_recovery_s'
                )
            from ..obs.wire import REPLICAS

            self.replica_ids: Tuple[str, ...] = tuple(
                REPLICAS.register(f'r{i}') for i in range(self.n_replicas)
            )
            self._breakers: List[Optional[CircuitBreaker]] = [
                CircuitBreaker(
                    failure_threshold=int(breaker_failures),
                    recovery_time_s=float(breaker_recovery_s),
                    name=f'serve.dispatch.{rid}',
                )
                if int(breaker_failures) > 0
                else None
                for rid in self.replica_ids
            ]
            self._lane_devices = _lane_devices(first.device, self.n_replicas)
            #: one CUDA stream per lane on a card, made once: a lane's
            #: upload, dispatch and values' copy run on it, so lanes that
            #: share a card overlap instead of queueing on one stream
            self._lane_streams: List[Any] = [
                torch.cuda.Stream(d) if d.type == 'cuda' else None for d in self._lane_devices
            ]
            # fail at construction, not first flush: the lanes serve the
            # fused dispatch only, and a service that cannot serve its
            # topology must say so here
            self._dispatchers: List[Tuple[Any, Any]] = [(first, self._build_dispatcher(first))]
        else:
            self.replica_ids = ()
            if breaker is not None:
                self._breakers = [breaker]
            elif int(breaker_failures) > 0:
                self._breakers = [
                    CircuitBreaker(
                        failure_threshold=int(breaker_failures),
                        recovery_time_s=float(breaker_recovery_s),
                        name='serve.dispatch',
                    )
                ]
            else:
                self._breakers = [None]
            self._lane_devices = ()
            self._lane_streams = []
            self._dispatchers = []
        self._dispatcher_lock = threading.Lock()
        self._batcher = MicroBatcher(
            self._flush,
            max_batch_size=max_batch_size,
            max_wait_ms=max_wait_ms,
            max_queue=max_queue,
            on_crash=self._on_flusher_crash,
            on_request_done=self._on_request_done,
            n_lanes=self.n_replicas,
            lane_names=self.replica_ids or None,
        )
        self._shape_lock = threading.Lock()
        self._seen_shapes: set = set()
        self._seen_scenario_buckets: set = set()
        #: explicit artifact source for model-backed services
        self._aot_dir_override = aot_dir
        #: last warm-tier load summary + the (name, version) it was tried for
        self._aot_state: Optional[Dict[str, Any]] = None
        self._aot_tried_for: Optional[Tuple[str, str]] = None
        #: the compile cache's status from the last warmup
        self._cache_state: Optional[Dict[str, Any]] = None

    # -- model plumbing ----------------------------------------------------

    @staticmethod
    def _validate_model(model: Any) -> None:
        if not getattr(model, '_models', None):
            raise ValueError('the serving model must be fitted')
        if getattr(model, '_fused_registry', None) != 'standard':
            raise ValueError(
                'RatingService serves standard-SPADL VAEP models '
                '(atomic serving is not wired up yet)'
            )

    def _active(self) -> Tuple[str, str, Any]:
        """One consistent ``(name, version, model)`` read (swap atomicity)."""
        if self._model is not None:
            return ('default', '0', self._model)
        return self._registry.active()

    @property
    def model(self) -> Any:
        """The model currently serving traffic."""
        return self._active()[2]

    @property
    def nb_prev_actions(self) -> int:
        """Game-state depth ``k`` of the serving model."""
        return int(self.model.nb_prev_actions)

    def _model_quantize(self) -> str:
        """Table-storage mode of the serving model ('none' when unknown)."""
        try:
            return str(getattr(self.model, 'quantize', 'none'))
        except ValueError:
            return 'none'

    def _model_kernel(self) -> Dict[str, Any]:
        """What a flush dispatches through: the serving model's rating path
        and B1's launches in this process by the instantiation the kernel
        reported (``fused_first_layer_quant.plans``; none on the CPU, where
        the wrapper runs its plain version). The JAX service reports its
        first-layer lowering here, which has no counterpart: B1 has one
        CUDA route."""
        try:
            path = self.model._rating_path()
        except ValueError:
            # a malformed path override must not take down the health
            # endpoint the operator needs to diagnose it
            path = 'invalid'
        return {'path': path, 'plans': dict(fused_first_layer_quant.plans)}

    # -- replica lanes ------------------------------------------------------

    @property
    def _breaker(self) -> Optional[CircuitBreaker]:
        """Lane 0's breaker: the single-lane service's only one."""
        return self._breakers[0]

    def _replica_kw(self, lane: int) -> Dict[str, str]:
        """The ``replica=`` label of one lane's serve-area series."""
        if not self.replica_ids:
            return {}
        return {'replica': self.replica_ids[lane]}

    def _build_dispatcher(self, model: Any) -> Any:
        """A :class:`~socceraction_tpu_torch.parallel.serve.ReplicaDispatcher`
        for one model over the lanes' devices: a lane on the model's own
        device shares the model's fold and heads, any other lane gets one
        copy on its card."""
        from ..parallel.serve import ReplicaDispatcher

        return ReplicaDispatcher(model, self.n_replicas, devices=self._lane_devices)

    def _dispatcher_for(self, model: Any) -> Any:
        """The lanes' dispatcher serving ``model`` (built once per model).

        Keyed by model identity, bounded to the registry's working set
        (active + swap target + rollback source): a flush that read the
        active model mid-swap keeps its model's dispatcher even while a
        new one warms, so swap atomicity extends to the lanes.
        """
        with self._dispatcher_lock:
            for m, d in self._dispatchers:
                if m is model:
                    return d
        dispatcher = self._build_dispatcher(model)
        with self._dispatcher_lock:
            for m, d in self._dispatchers:
                if m is model:  # lost a build race: keep the first
                    return d
            self._dispatchers.append((model, dispatcher))
            del self._dispatchers[:-3]
        return dispatcher

    def _prepare_swap_target(self, name: str, version: str) -> Any:
        """Load, validate, layout-guard and ladder-warm a swap target.

        The shared half of :meth:`swap_model` and :meth:`rollback_model`:
        the target must be serve-compatible (fitted, standard SPADL) and
        keep the active model's feature layout — sessions in flight pin
        their window shape to ``nb_prev_actions`` and the bucket ladder
        pins the served shapes, so a layout change requires a new service,
        not a swap. The version's shipped libraries are tried first
        (:meth:`_load_aot_for`, never raising), then the ladder is
        dispatched through the target on every lane *before* it goes live
        (on the caller's thread), so the first post-swap request pays no
        first-use cost and a target that cannot rate on any lane fails
        this call, not a flush.
        """
        old = self.model
        new = self._registry.load(name, version)
        self._validate_model(new)
        if new.nb_prev_actions != old.nb_prev_actions or tuple(new.xfns) != tuple(old.xfns):
            raise ValueError(
                'swap target changes the feature layout '
                '(nb_prev_actions/xfns); start a new RatingService for it'
            )
        self._load_aot_for(name, version, new)
        A = self.max_actions
        rungs: Tuple[Optional[int], ...] = (
            window_ladder(A) if getattr(new, 'time_rungs', False) else (None,)
        )
        # every lane warms before the caller activates the target anywhere:
        # one lane failing to warm raises out of this loop and aborts the
        # swap for all of them, so no mixed-version service ever serves
        for lane in range(self.n_replicas):
            for b in self._batcher.ladder:
                for tl in rungs:
                    self._device_rate(
                        _empty_host_batch(1, A), _empty_gs(1, A), new, b, lane=lane, time_len=tl,
                    )
        return new

    def swap_model(self, name: str, version: Optional[str] = None) -> Tuple[str, str]:
        """Atomically swap serving to ``name``/``version`` (default newest).

        The new version is validated, layout-guarded and ladder-warmed
        before activation (:meth:`_prepare_swap_target`). That ordering
        is the corrupt-checkpoint fallback: a damaged artifact fails *this
        call* on the caller's thread — the previously active model keeps
        serving and the flusher never sees the broken candidate.
        """
        if self._registry is None:
            raise RuntimeError('swap_model needs a registry-backed service')
        try:
            # pin 'newest' NOW: the version validated and pre-warmed below
            # must be the exact version activated
            version = self._registry.resolve_version(name, version)
            self._prepare_swap_target(name, version)
            out = self._registry.activate(name, version)
            self._model_activated_t = time.monotonic()
            return out
        except Exception as e:
            self._maybe_dump(
                'swap_failure',
                {
                    'type': 'swap_failure',
                    'target': f'{name}/{version or "newest"}',
                    'error': f'{type(e).__name__}: {e}',
                },
            )
            raise

    def rollback_model(self) -> Tuple[str, str]:
        """Atomically roll serving back to the previously active version.

        The registry's :meth:`~socceraction_tpu_torch.serve.registry.ModelRegistry.rollback`
        restores the version that was serving before the last swap (still
        resident in the load cache) after this service re-warms the
        bucket ladder for it. Counted under
        ``serve/model_swaps{reason="rollback"}``; a failure dumps the
        flight recorder like a failed forward swap.
        """
        if self._registry is None:
            raise RuntimeError('rollback_model needs a registry-backed service')
        prev = self._registry.previous()
        if prev is None:
            raise RuntimeError('no previous version to roll back to')
        name, version = prev
        try:
            self._prepare_swap_target(name, version)
            # pin the exact version just validated/warmed: a promotion
            # racing this call changes "previous"
            out = self._registry.rollback(expected=(name, version))
            self._model_activated_t = time.monotonic()
            return out
        except Exception as e:
            self._maybe_dump(
                'swap_failure',
                {
                    'type': 'rollback_failure',
                    'target': f'{name}/{version}',
                    'error': f'{type(e).__name__}: {e}',
                },
            )
            raise

    # -- request entry points ----------------------------------------------

    def rate(
        self,
        actions: 'pd.DataFrame',
        *,
        home_team_id: Any = None,
        deadline_ms: Optional[float] = None,
        context: Optional[RequestContext] = None,
    ) -> Future:
        """Rate one match's SPADL actions; returns a Future of a DataFrame.

        ``actions`` is a single game's frame; ``home_team_id`` defaults to
        the frame's ``home_team_id`` column when present. Packing runs on
        the calling thread; the device dispatch is coalesced with
        concurrent requests. The future resolves to a DataFrame with
        ``offensive_value`` / ``defensive_value`` / ``vaep_value``
        aligned to ``actions``' index.

        Every call mints a :class:`~socceraction_tpu_torch.obs.context.RequestContext`
        exposed on the future as ``future.context`` (and its id as
        ``future.request_id``); ``context`` accepts a pre-built one (the
        process-hop form, whose deadline then holds). ``deadline_ms``
        (default: the service's ``request_deadline_ms``) bounds the total
        wait. Raises
        :class:`~socceraction_tpu_torch.serve.batcher.Overloaded`
        synchronously when the admission queue is full, and
        :class:`SLOShed` (before any packing) while an SLO burns.
        """
        if len(actions) == 0:
            raise ValueError('cannot rate an empty actions frame')
        self._check_admission('rate')
        if 'game_id' in actions.columns and actions['game_id'].nunique() > 1:
            raise ValueError(
                'one request rates one match; split multi-game frames '
                '(or use VAEP.rate_batch for offline batches)'
            )
        if home_team_id is None:
            if 'home_team_id' not in actions.columns:
                raise ValueError('home_team_id is required')
            home_team_id = actions['home_team_id'].iloc[0]
        if len(actions) > self.max_actions:
            raise ValueError(
                f'{len(actions)} actions exceed the service window '
                f'(max_actions={self.max_actions})'
            )
        frame = actions
        if 'game_id' not in frame.columns:
            frame = frame.assign(game_id=0)
        staging, _ids = pack_actions(
            frame, home_team_id=home_team_id, max_actions=self.max_actions,
            as_numpy=True,
        )
        gs = self._frame_goalscore(frame, home_team_id) if self._gs_enabled else None
        if context is not None:
            ctx = context
        else:
            ctx = new_request_context(
                'rate',
                deadline_ms=(
                    deadline_ms if deadline_ms is not None else self.request_deadline_ms
                ),
            )
        payload = _Payload(staging, gs, keep=None, index=actions.index, ctx=ctx)
        future = self._submit(payload, 'rate', ctx)
        # capture only what was served: shed, expired or failed requests
        # never produced ratings. The frame is copied HERE, on the caller's
        # thread; the done callback runs on the flusher thread
        if self.capture is not None:
            capture = self.capture
            captured = actions.copy()

            def _record(fut: Future, _a: Any = captured, _h: Any = home_team_id) -> None:
                try:
                    if not fut.cancelled() and fut.exception() is None:
                        capture.record_frame(_a, _h, copy=False)
                except Exception:  # capture must never hurt the caller
                    pass

            future.add_done_callback(_record)
        return future

    def rate_sync(
        self, actions: 'pd.DataFrame', *, home_team_id: Any = None,
        timeout: Optional[float] = None,
        deadline_ms: Optional[float] = None,
    ) -> 'pd.DataFrame':
        """Blocking convenience wrapper around :meth:`rate`."""
        return self.rate(
            actions, home_team_id=home_team_id, deadline_ms=deadline_ms
        ).result(timeout)

    def rate_scenarios(
        self,
        actions: 'pd.DataFrame',
        grid: ScenarioGrid,
        *,
        home_team_id: Any = None,
        deadline_ms: Optional[float] = None,
        context: Optional[RequestContext] = None,
    ) -> Future:
        """Value every perturbation of one match in ONE fused dispatch.

        ``actions`` is a single game's SPADL frame (as for :meth:`rate`),
        ``grid`` a :class:`~socceraction_tpu_torch.scenario.grid.ScenarioGrid`
        of ``P`` alternatives. The future resolves to a
        ``(P, len(actions), 3)`` array: row ``p`` is what :meth:`rate`
        returns for the frame with perturbation ``p`` applied, carrying
        the factual goalscore block. ``P`` snaps to its power-of-two bucket
        (edge-padded grid, result sliced back), and the folded dispatch is
        the shape of a ``P_bucket``-game rate flush: one B1 launch.
        Admission, deadlines, SLO scoring (kind ``'scenario'``), the
        breaker (fallback: the looped materialized reference, never for a
        kernel that cannot run) and the flight recorder apply as for
        :meth:`rate`; metrics land under the ``scenario`` area. Malformed
        grids fail here, on the caller's thread.
        """
        if len(actions) == 0:
            raise ValueError('cannot rate scenarios for an empty actions frame')
        self._check_admission('scenario')
        if not isinstance(grid, ScenarioGrid):
            raise TypeError(
                'rate_scenarios needs a ScenarioGrid (build one with '
                'end_location_grid / action_type_sweep / custom_grid)'
            )
        P = grid.n_perturbations
        if P > self.max_perturbations:
            raise ValueError(
                f'{P} perturbations exceed the scenario ladder '
                f'(max_perturbations={self.max_perturbations})'
            )
        if 'game_id' in actions.columns and actions['game_id'].nunique() > 1:
            raise ValueError(
                'one request rates one match; split multi-game frames '
                '(or use rate_scenarios_batch for offline grids)'
            )
        if home_team_id is None:
            if 'home_team_id' not in actions.columns:
                raise ValueError('home_team_id is required')
            home_team_id = actions['home_team_id'].iloc[0]
        if len(actions) > self.max_actions:
            raise ValueError(
                f'{len(actions)} actions exceed the service window '
                f'(max_actions={self.max_actions})'
            )
        frame = actions
        if 'game_id' not in frame.columns:
            frame = frame.assign(game_id=0)
        staging, _ids = pack_actions(
            frame, home_team_id=home_team_id, max_actions=self.max_actions,
            as_numpy=True,
        )
        self._validate_grid(grid)
        gs = self._frame_goalscore(frame, home_team_id) if self._gs_enabled else None
        if context is not None:
            ctx = context
        else:
            ctx = new_request_context(
                'scenario',
                deadline_ms=(
                    deadline_ms if deadline_ms is not None else self.request_deadline_ms
                ),
            )
        counter('scenario/requests', unit='count').inc(1, verb='serve')
        payload = _ScenarioPayload(staging, gs, grid, actions.index, ctx)
        return self._submit(payload, 'scenario', ctx)

    def rate_scenarios_sync(
        self,
        actions: 'pd.DataFrame',
        grid: ScenarioGrid,
        *,
        home_team_id: Any = None,
        timeout: Optional[float] = None,
        deadline_ms: Optional[float] = None,
    ) -> np.ndarray:
        """Blocking convenience wrapper around :meth:`rate_scenarios`."""
        return self.rate_scenarios(
            actions, grid, home_team_id=home_team_id, deadline_ms=deadline_ms
        ).result(timeout)

    def _validate_grid(self, grid: ScenarioGrid) -> None:
        """Fail a grid that does not fit this service's window or the
        model's dense blocks, with the model's named errors."""
        P = grid.n_perturbations
        for name, upd in grid.field_updates.items():
            if upd.ndim == 3 and upd.shape[1:] != (1, self.max_actions):
                raise ValueError(
                    f'field update {name!r} has shape {upd.shape}; per-action '
                    f'updates must be (P, 1, max_actions) = '
                    f'({P}, 1, {self.max_actions}) for this service'
                )
        model = self.model
        for name, block in grid.dense_overrides.items():
            model._check_dense_override(name, block.shape[1:], 1, self.max_actions)

    def open_session(self, match_id: Any, *, home_team_id: Any) -> MatchSession:
        """Start a live-match streaming session (see :class:`MatchSession`)."""
        names = set(self.model.xfns)
        nonlocal_names = names - WINDOW_LOCAL_KERNELS - {'goalscore'}
        if nonlocal_names:
            raise ValueError(
                f'feature kernels {sorted(nonlocal_names)} are not '
                'window-local; streaming sessions cannot rate suffixes '
                'under this model'
            )
        counter('serve/sessions_opened', unit='count').inc(1)
        return MatchSession(self, match_id, home_team_id)

    def _submit_window(
        self, window: 'pd.DataFrame', context: int, m: int,
        *, match_id: Any, home_team_id: Any,
    ) -> Future:
        """Session entry: pack a context+suffix window and enqueue it."""
        self._check_admission('session')
        staging, gs = pack_window(window, match_id, home_team_id, self.max_actions)
        ctx = new_request_context('session', deadline_ms=self.request_deadline_ms)
        payload = _Payload(staging, gs, keep=(context, m), ctx=ctx)
        return self._submit(payload, 'session', ctx)

    def _check_admission(self, kind: str) -> None:
        """SLO burn-rate admission control; raises :class:`SLOShed`.

        A no-op without ``slo=``. The verdict is the engine's cached
        evaluation; a shed counts under ``slo/shed_total{objective}`` and,
        like a queue overload, toward the overload-burst dump.
        """
        if self._slo is None:
            return
        shed, reason = self._slo.should_shed(kind)
        if shed:
            counter('slo/shed_total', unit='requests').inc(1, objective=reason['objective'])
            self._note_overload()
            raise SLOShed(reason)

    def _on_request_done(
        self, ctx: Optional[RequestContext], kind: str, wall_s: float, status: str,
    ) -> None:
        """Batcher terminal-state hook: score the request against the SLOs."""
        if self._slo is not None and kind != 'warmup':
            self._slo.observe_request(kind, wall_s, status)

    def _on_slo_breach(self, objective: str, entry: Dict[str, Any]) -> None:
        """SLO engine breach hook: dump the flight recorder (rate-limited)
        on a thread of its own. The breach fires inside the evaluation that
        admission runs, and the bundle's tensor census walks every object
        the collector tracks: the request that finds the breach does not
        wait for that walk. :meth:`close` waits for the dump."""
        trigger = {'type': 'slo_breach', 'objective': objective, 'evaluation': entry}
        dump = threading.Thread(target=self._maybe_dump, args=('slo_breach', trigger),
                                name='slo-breach-dump', daemon=True)
        with self._dump_lock:
            self._dumps = [t for t in self._dumps if t.is_alive()] + [dump]
            dump.start()

    def _submit(
        self, payload: Any, kind: str, ctx: Optional[RequestContext] = None,
    ) -> Future:
        """Enqueue via the batcher, counting ``Overloaded`` bursts.

        Where :meth:`rate`, :meth:`rate_scenarios` and session ticks arrive
        once they have checked admission and packed their frames:
        ``payload`` (a :class:`_Payload` or :class:`_ScenarioPayload`)
        holds a host staging batch of numpy fields and its goalscore block.
        """
        try:
            return self._batcher.submit(payload, kind=kind, ctx=ctx)
        except Overloaded:
            self._note_overload()
            raise

    def _frame_goalscore(self, frame: 'pd.DataFrame', home_team_id: Any) -> np.ndarray:
        """Whole-frame goalscore block ``(1, A, 3)`` computed on host.

        Every request carries this block (not just session windows) so
        all flushes dispatch the same function per bucket. Values come
        from the session module's ``score_prefix`` (the single host mirror
        of the device kernel): small integer counts, exactly what the
        kernel computes.
        """
        is_home = frame['team_id'].to_numpy() == home_team_id
        team, opp, _a, _b = score_prefix(
            frame['type_id'].to_numpy(dtype=np.int64),
            frame['result_id'].to_numpy(dtype=np.int64),
            is_home == bool(is_home[0]),
        )
        return goalscore_block(team, opp, self.max_actions)

    # -- the flush (runs on the batcher's flusher thread) ------------------

    def _device_rate(
        self,
        host_batch: ActionBatch,
        gs: Optional[np.ndarray],
        model: Any,
        bucket: int,
        lane: int = 0,
        extra_overrides: Optional[Dict[str, np.ndarray]] = None,
        time_len: Optional[int] = None,
        probe: bool = False,
        exemplar: Optional[str] = None,
    ) -> np.ndarray:
        """Pad to the bucket, rate on the lane's device, copy to host.

        The padded host batch is copied to the device (from pinned memory
        on a card, without waiting), rated, and its values come back in
        one copy. Nothing before that copy reads the device. A one-lane
        service rates through ``rate_batch`` on the model's device and its
        current stream. On a service with lanes, lane ``lane`` rates
        through the lanes' dispatcher (:meth:`_dispatcher_for`, the same
        function on that lane's device) on the lane's own stream, which
        first waits for the device's default stream (where models are
        loaded and folds built); the shape key and the series carry the
        lane.

        ``extra_overrides`` carries a scenario grid's dense blocks (already
        expanded to ``(bucket, A, width)``), uploaded beside the goalscore
        block the same way.

        ``time_len`` is the window-length rung for time-rung models
        (``model.time_rungs``): the action axis is sliced to the rung
        after bucket padding, dispatched at the reduced shape, and the
        values are zero-padded back to the caller's capacity. Safe because
        every kernel is backward-looking over masked tails and the rung
        never truncates a valid row. The sliced ``max_actions`` lands in
        the shape key, so each rung is its own pinned shape.

        ``probe`` marks a rate flush the parity probe may sample (with its
        first request id as ``exemplar``): a sampled flush hands the probe
        the batch, goalscore block and values on the model's device, before
        the values' copy.
        """
        host_batch, gs = _pad_to_bucket(host_batch, gs, bucket)
        orig_A = host_batch.max_actions
        if time_len is not None and time_len < orig_A:
            host_batch, gs = _slice_window(host_batch, gs, time_len)
            if extra_overrides:
                extra_overrides = {k: v[:, :time_len] for k, v in extra_overrides.items()}
            counter('seq/window_slices', unit='count').inc(1, window=str(time_len))
        key = (bucket, host_batch.max_actions, lane)
        with self._shape_lock:
            new_shape = key not in self._seen_shapes
            if new_shape:
                self._seen_shapes.add(key)
                n_shapes = len(self._seen_shapes)
        if new_shape:
            counter('serve/shape_traces', unit='count').inc(
                1, bucket=str(bucket), **self._replica_kw(lane)
            )
            gauge('serve/compiled_shapes', unit='shapes').set(n_shapes)
        fault_point('serve.dispatch', bucket=bucket)
        if self.n_replicas > 1:
            dispatcher = self._dispatcher_for(model)
            device, stream = self._lane_devices[lane], self._lane_streams[lane]
        else:
            dispatcher, device, stream = None, model.device, None
        with _on_device(device), _on_stream(stream, device):
            batch, overrides = _upload(
                host_batch, gs if self._gs_enabled else None, device, extra_overrides
            )
            if dispatcher is None:
                values = model.rate_batch(batch, dense_overrides=overrides, bucket=False)
            else:
                values = dispatcher.dispatch(lane, batch, overrides)
            # the probe's reference reads the model's own weights: a lane
            # on another card than the model's is not sampled
            if (
                probe and self.parity is not None and device == model.device
                and self.parity.should_sample()
            ):
                self.parity.submit_flush(
                    model, batch, (overrides or {}).get('goalscore'), values, exemplar=exemplar
                )
            with torch.profiler.record_function('serve/values_copy'):
                host = values.cpu().numpy()
        return _pad_values_time(host, orig_A)

    def _reference_rate(
        self,
        host_batch: ActionBatch,
        gs: Optional[np.ndarray],
        model: Any,
    ) -> np.ndarray:
        """The degraded path: the materialized reference rating, on the
        model's device. Same values contract as the fused dispatch; slower
        per flush; correct, which is what degradation is for."""
        device = model.device
        with _on_device(device):
            batch, overrides = _upload(host_batch, gs if self._gs_enabled else None, device)
            values = model.rate_batch_reference(batch, dense_overrides=overrides)
            return values.cpu().numpy()

    def _with_breaker(
        self, lane: int, fused: Callable[[], np.ndarray], fallback: Callable[[], np.ndarray],
    ) -> Tuple[np.ndarray, str]:
        """One flush's dispatch through its lane's breaker; ``(values, path)``.

        ``path`` is ``'fused'`` (healthy or successful half-open probe)
        or ``'fallback'`` (breaker open, or this flush's fused dispatch
        failed). A fused failure is recorded on the breaker and the SAME
        flush is served through ``fallback`` (the reference): callers see
        degraded latency, never a spurious error, and ``failure_threshold``
        consecutive failures trip the breaker so later flushes skip the
        doomed dispatch. A fallback failure propagates (the batcher fails
        the flush's futures).

        A kernel that cannot run (:class:`KernelError`, a CUDA error) is
        re-raised at once: it is not recorded on the breaker, counts no
        fallback flush and never reaches the reference, so the batcher
        fails the flush's requests with it. A half-open probe that ends so
        gives its slot back, unjudged.
        """
        breaker = self._breakers[lane]
        if breaker is None:
            return fused(), 'fused'
        replica_kw = self._replica_kw(lane)
        verdict = breaker.allow()
        if verdict == 'open':
            counter('serve/fallback_flushes', unit='count').inc(1, **replica_kw)
            return fallback(), 'fallback'
        try:
            values = fused()
        except _KERNEL_ERRORS:
            if verdict == 'probe':
                breaker._abandon_probe()
            raise
        except Exception as e:
            tripped = breaker.record_failure(e)
            if tripped:
                self._maybe_dump(
                    'breaker_open',
                    {
                        'type': 'breaker_open',
                        'error': f'{type(e).__name__}: {e}',
                        'breaker': breaker.to_dict(),
                    },
                )
            counter('serve/fallback_flushes', unit='count').inc(1, **replica_kw)
            return fallback(), 'fallback'
        breaker.record_success()
        return values, 'fused'

    def _rate_with_breaker(
        self,
        host_batch: ActionBatch,
        gs: Optional[np.ndarray],
        model: Any,
        bucket: int,
        lane: int = 0,
        time_len: Optional[int] = None,
        exemplar: Optional[str] = None,
    ) -> Tuple[np.ndarray, str]:
        """A rate flush through the breaker (:meth:`_with_breaker`); the
        fallback is the materialized reference of the same batch. Only a
        fused dispatch is offered to the parity probe: probing the
        reference would compare it with itself."""
        return self._with_breaker(
            lane,
            lambda: self._device_rate(
                host_batch, gs, model, bucket, lane, time_len=time_len, probe=True,
                exemplar=exemplar,
            ),
            lambda: self._reference_rate(host_batch, gs, model),
        )

    def _rate_scenarios_with_breaker(
        self,
        p: _ScenarioPayload,
        expanded: ActionBatch,
        gs_full: Optional[np.ndarray],
        extra: Optional[Dict[str, np.ndarray]],
        model: Any,
        p_bucket: int,
        lane: int,
    ) -> Tuple[np.ndarray, str]:
        """A scenario flush through the same breaker (:meth:`_with_breaker`):
        ``'fused'`` is the one folded dispatch, ``'fallback'`` the looped
        materialized reference over the unpadded grid (``P`` dispatches that
        launch B1 none), on the model's device. A kernel that cannot run
        fails the request, as for rate flushes."""

        def fallback() -> np.ndarray:
            gs = (
                p.gs
                if self._gs_enabled and 'goalscore' not in p.grid.dense_overrides
                else None
            )
            device = model.device
            with _on_device(device):
                batch, overrides = _upload(p.staging, gs, device)
                ref = rate_scenarios_reference(model, batch, p.grid, dense_overrides=overrides)
                ref = ref.cpu().numpy()
            return ref.reshape(ref.shape[0], *ref.shape[2:])

        return self._with_breaker(
            lane,
            lambda: self._device_rate(
                expanded, gs_full, model, p_bucket, lane, extra_overrides=extra
            ),
            fallback,
        )

    def _flush(self, payloads: List[Any], bucket: int, *, lane: int = 0) -> List[Any]:
        """The batcher's runner: route a take to its dispatch shape(s).

        Rate and session payloads coalesce into one bucket-padded dispatch
        (:meth:`_flush_rate`; a take with no scenario payload runs only
        that). Each scenario payload folds its perturbation axis into the
        game axis at its own bucket and dispatches as its own flush
        (:meth:`_flush_scenario`); a mixed take is partitioned and its
        results come back in payload order.
        """
        if not any(isinstance(p, _ScenarioPayload) for p in payloads):
            return self._flush_rate(payloads, bucket, lane=lane)
        plain = [p for p in payloads if not isinstance(p, _ScenarioPayload)]
        results: Dict[int, Any] = {}
        if plain:
            plain_bucket = self._batcher.bucket_for(len(plain))
            for p, r in zip(plain, self._flush_rate(plain, plain_bucket, lane=lane)):
                results[id(p)] = r
        for p in payloads:
            if isinstance(p, _ScenarioPayload):
                results[id(p)] = self._flush_scenario(p, lane=lane)
        return [results[id(p)] for p in payloads]

    def _flush_scenario(self, p: _ScenarioPayload, *, lane: int = 0) -> np.ndarray:
        """One scenario request -> ``(P, n_rows, 3)`` in ONE fused dispatch.

        The perturbation count snaps to its power-of-two bucket
        (edge-padded grid, sliced back), the grid expands the request's
        host staging batch to ``(P_bucket, A)`` on the host, and the
        dispatch goes through the breaker like a rate flush: a field-update
        grid at bucket ``b`` is the shape of a ``b``-game rate flush, so
        scenario rungs share the serving ladder's warm-up.
        """
        _name, _version, model = self._active()  # ONE read per flush
        t0 = time.perf_counter()
        P = p.grid.n_perturbations
        p_bucket = bucket_perturbations(P)
        expanded, extra = expand_scenarios(p.staging, pad_perturbations(p.grid, p_bucket))
        if 'goalscore' in extra:
            # a grid that perturbs goalscore overrides the factual block
            gs_full: Optional[np.ndarray] = extra.pop('goalscore')
        elif self._gs_enabled and p.gs is not None:
            gs_full = np.tile(p.gs, (p_bucket, 1, 1))
        else:
            gs_full = None
        bucket_label = str(p_bucket)
        with self._shape_lock:
            new_bucket = p_bucket not in self._seen_scenario_buckets
            if new_bucket:
                self._seen_scenario_buckets.add(p_bucket)
        if new_bucket:
            counter('scenario/shape_traces', unit='count').inc(1, n_perturbations_bucket=bucket_label)
        t_pad = time.perf_counter()
        values, path = self._rate_scenarios_with_breaker(
            p, expanded, gs_full, extra or None, model, p_bucket, lane
        )
        t_dispatch = time.perf_counter()
        dispatch_s = t_dispatch - t_pad
        if path == 'fused':
            # the folded dispatch is a pair dispatch at the perturbation
            # bucket: it feeds the live roofline like any fused flush
            record_dispatch('pair_probs', dispatch_s, bucket=p_bucket)
            counter('scenario/dispatches', unit='count').inc(1, n_perturbations_bucket=bucket_label)
        else:
            counter('scenario/fallbacks', unit='count').inc(1)
        self._drain_numeric_guards()
        rows = np.stack([unpack_values(values[q : q + 1], p.staging) for q in range(P)])
        t_slice = time.perf_counter()
        histogram('scenario/dispatch_seconds', unit='s').observe(
            dispatch_s, n_perturbations_bucket=bucket_label
        )
        n_values = P * rows.shape[1]
        counter('scenario/values', unit='values').inc(n_values)
        if dispatch_s > 0:
            gauge('scenario/values_per_sec', unit='values/s').set(
                n_values / dispatch_s, n_perturbations_bucket=bucket_label
            )
        exemplar = p.ctx.request_id if p.ctx is not None else None
        replica_kw = self._replica_kw(lane)
        pad_s = t_pad - t0
        slice_s = t_slice - t_dispatch
        record_segment('pad', pad_s, exemplar, **replica_kw)
        record_segment('dispatch', dispatch_s, exemplar, **replica_kw)
        record_segment('slice', slice_s, exemplar, **replica_kw)
        if p.ctx is not None:
            p.ctx.segments.update(pad=pad_s, dispatch=dispatch_s, slice=slice_s)
        return rows

    def _flush_rate(self, payloads: List[_Payload], bucket: int, *, lane: int = 0) -> List[Any]:
        """Rate and session payloads in one coalesced, bucket-padded
        dispatch."""
        _name, _version, model = self._active()  # ONE read per flush
        t0 = time.perf_counter()
        stagings = [p.staging for p in payloads]
        if len(stagings) == 1:
            host_batch = stagings[0]
            gs = payloads[0].gs
        else:
            host_batch = _concat_games(stagings)
            gs = (
                np.concatenate([p.gs for p in payloads], axis=0)
                if self._gs_enabled
                else None
            )
        # pad here (not inside the dispatch) so the host-side concat+pad
        # overhead is charged to the 'pad' segment, never to 'dispatch'
        host_batch, gs = _pad_to_bucket(host_batch, gs, bucket)
        # time-rung models (seq heads) also snap the WINDOW length to a
        # power-of-two rung, read from the host lengths
        time_len = (
            bucket_window(int(np.asarray(host_batch.n_actions).max()), self.max_actions)
            if getattr(model, 'time_rungs', False)
            else None
        )
        exemplar = next((p.ctx.request_id for p in payloads if p.ctx is not None), None)
        t_pad = time.perf_counter()
        values, path = self._rate_with_breaker(
            host_batch, gs, model, bucket, lane, time_len=time_len, exemplar=exemplar
        )
        t_dispatch = time.perf_counter()
        if path == 'fused':
            # the flush's dispatch wall ends after the values' copy, so it
            # is synchronized; fallback flushes run another function
            record_dispatch('pair_probs', t_dispatch - t_pad, bucket=bucket)
        # the values are on the host now, so the dispatch's guard events
        # have completed: draining converts without waiting on the device
        self._drain_numeric_guards()

        results: List[Any] = []
        for i, p in enumerate(payloads):
            if p.keep is None:
                import pandas as pd

                rows = unpack_values(values[i : i + 1], p.staging)
                results.append(pd.DataFrame(rows, columns=RATING_COLUMNS, index=p.index))
            else:
                context, m = p.keep
                results.append(values[i, context : context + m, :].copy())
        t_slice = time.perf_counter()

        # the flush-shared half of the per-request wall decomposition
        # (queue_wait is the batcher's)
        replica_kw = self._replica_kw(lane)
        pad_s = t_pad - t0
        dispatch_s = t_dispatch - t_pad
        slice_s = t_slice - t_dispatch
        record_segment('pad', pad_s, exemplar, **replica_kw)
        record_segment('dispatch', dispatch_s, exemplar, **replica_kw)
        record_segment('slice', slice_s, exemplar, **replica_kw)
        for p in payloads:
            if p.ctx is not None:
                p.ctx.segments.update(pad=pad_s, dispatch=dispatch_s, slice=slice_s)
        return results

    # -- numeric health -----------------------------------------------------

    def _drain_numeric_guards(self) -> None:
        """Drain pending in-dispatch guards; act on nonzero detections.

        Runs on the flusher thread, after the flush's values copy. A
        detection is already counted by the drain itself; the service adds
        the rate-limited debug bundle and the :meth:`health` degradation
        for **nonfinite** events only (overflow stays a metric-level
        warning).
        """
        try:
            events = drain_guards()
        except Exception:  # guard telemetry must never fail a flush
            return
        bad = [e for e in events if e.kind == 'nonfinite']
        if not bad:
            return
        with self._dump_lock:
            self._nonfinite_events += len(bad)
        self._maybe_dump(
            'nonfinite',
            {'type': 'nonfinite_dispatch', 'events': [e.to_dict() for e in bad]},
        )

    def _on_parity_exceed(self, observation: Dict[str, Any]) -> None:
        """Parity-probe band breach: dump the flight recorder (rate-limited)."""
        self._maybe_dump('parity', {'type': 'parity_exceeded', 'observation': observation})

    # -- flight recorder + health ------------------------------------------

    def _queue_state(self) -> Dict[str, Any]:
        """The batcher's current state, for triggers and ``health()``."""
        b = self._batcher
        crashed = b.crashed
        return {
            'queue_depth': b.queue_depth,
            'max_queue': b.max_queue,
            'flusher_alive': b.flusher_alive,
            'flusher_error': f'{type(crashed).__name__}: {crashed}' if crashed else None,
            'last_flush_age_s': b.last_flush_age_s,
        }

    def _maybe_dump(self, reason: str, trigger: Dict[str, Any]) -> Optional[str]:
        """Write a debug bundle, rate-limited per reason; never raises.

        Every trigger increments ``serve/debug_dumps{reason=...}`` even
        when the bundle itself is rate-limited away.
        """
        counter('serve/debug_dumps', unit='count').inc(1, reason=reason)
        now = time.monotonic()
        with self._dump_lock:
            last = self._last_dump_t.get(reason)
            if last is not None and now - last < self.dump_interval_s:
                return None
            self._last_dump_t[reason] = now
        try:
            path = dump_debug_bundle(
                self.debug_dir,
                reason=reason,
                trigger={**trigger, 'queue_state': self._queue_state()},
            )
        except Exception:  # a failing dump must never mask the trigger
            return None
        self.last_dump_path = path
        return path

    def _on_flusher_crash(self, exc: BaseException) -> None:
        """Batcher crash hook: the service is dead — dump the recorder."""
        self._maybe_dump(
            'flusher_crash',
            {'type': 'flusher_crash', 'error': f'{type(exc).__name__}: {exc}'},
        )

    def _note_overload(self) -> None:
        """Track ``Overloaded`` raises; a burst past the threshold dumps."""
        now = time.monotonic()
        with self._dump_lock:
            self._overloads.append(now)
            cutoff = now - self.overload_dump_window_s
            while self._overloads and self._overloads[0] < cutoff:
                self._overloads.popleft()
            burst = len(self._overloads)
        if burst >= self.overload_dump_threshold:
            self._maybe_dump(
                'overload',
                {
                    'type': 'overload_burst',
                    'rejections_in_window': burst,
                    'window_s': self.overload_dump_window_s,
                },
            )

    def _aot_block(self) -> Dict[str, Any]:
        """The ``health()['aot']`` entry: the last warm-tier load verdict.

        ``available`` is False until a load was attempted (a model-backed
        service without ``aot_dir=``, or warmup not yet run); afterwards
        the block carries the outcome (``hit``/``stale``/``miss``), the
        libraries installed, the shipped fingerprint and, for ``stale``,
        the keys that moved (a torch upgrade? another card?). With it
        the compile cache's state: its directory (None: the checkout's
        build directory) and, when it failed to enable, the error.
        """
        state = self._aot_state
        if state is None:
            block: Dict[str, Any] = {'available': False}
        else:
            block = {
                'available': True,
                'outcome': state.get('outcome'),
                'entries_loaded': state.get('entries_loaded', 0),
            }
            for key in ('model', 'reason', 'mismatch', 'fingerprint'):
                if state.get(key) is not None:
                    block[key] = state[key]
        if self._cache_state is not None:
            block['compile_cache'] = dict(self._cache_state)
        return block

    def health(self) -> Dict[str, Any]:
        """Liveness/pressure dict for external pollers (one cheap call).

        Reads only host state and the typed metric snapshot — no device
        work, safe on any thread at any rate. The JAX service's keys:
        ``status`` (``'ok'`` | ``'degraded'`` | ``'flusher-dead'``), the
        queue state, the ``numerics`` block (in-dispatch guard detections
        and the parity probe's stats; ``status`` degrades when this
        service's flushes detected non-finite values or a probe breached
        its band), the ``breaker``
        block (a non-closed breaker reads ``'degraded'``: flushes are
        being served through the reference), ``flusher_restarts``, the
        active model (``kernel`` names the rating path and B1's launches
        by instantiation), compiled-shape budget vs. ladder, the ``aot``
        block, the ``capacity`` block (live roofline entries and the
        residency ledger's ``owned_bytes``), the ``slo`` block (the
        measured request p99 vs. the ``slo_p99_ms`` budget; with ``slo=``
        each objective's burn rates and budget, the shed threshold and
        whether the service sheds now), rejection and debug-dump totals,
        ``last_dump`` and ``uptime_s``.
        """
        snap = REGISTRY.snapshot()
        # worst p99 across traffic kinds (rate AND session)
        lat = snap.get('serve/request_seconds')
        p99s = [
            s.quantiles['p99']
            for s in (lat.series if lat is not None else ())
            if s.count and s.quantiles and s.labels.get('kind') != 'warmup'
        ]
        p99_ms = max(p99s) * 1e3 if p99s else None
        name, version, _model = self._active()
        state = self._queue_state()
        slo_block: Dict[str, Any] = {
            'request_p99_ms': p99_ms,
            'budget_p99_ms': self.slo_p99_ms,
            'ok': None if p99_ms is None else bool(p99_ms <= self.slo_p99_ms),
        }
        if self._slo is not None:
            # a fresh evaluation: the poll keeps the windows moving even
            # when no admission decision forced one
            evaluation = self._slo.evaluate()
            slo_block['objectives'] = evaluation['objectives']
            slo_block['shed_burn_rate'] = evaluation['shed_burn_rate']
            slo_block['shedding'] = bool(
                self._slo.should_shed('rate')[0] or self._slo.should_shed('session')[0]
            )
        with self._dump_lock:
            nonfinite_events = self._nonfinite_events
        parity_stats = self.parity.stats() if self.parity is not None else None
        numerics_ok = nonfinite_events == 0 and (
            parity_stats is None or parity_stats['exceedances'] == 0
        )
        breaker_block = self._breaker.to_dict() if self._breaker is not None else None
        breaker_ok = breaker_block is None or breaker_block['state'] == 'closed'
        replicas_block: Optional[Dict[str, Any]] = None
        sick: List[str] = []
        if self.replica_ids:
            # one entry per lane, naming exactly which lane is sick (its
            # breaker open or probing, or its flusher retired)
            dead = self._batcher.dead_lanes
            per_replica: Dict[str, Any] = {}
            for lane, rid in enumerate(self.replica_ids):
                b = self._breakers[lane]
                b_dict = b.to_dict() if b is not None else None
                lane_dead = lane in dead
                healthy = not lane_dead and (b_dict is None or b_dict['state'] == 'closed')
                per_replica[rid] = {'breaker': b_dict, 'flusher_dead': lane_dead, 'healthy': healthy}
                if not healthy:
                    sick.append(rid)
                breaker_ok = breaker_ok and (b_dict is None or b_dict['state'] == 'closed')
            replicas_block = {'n': self.n_replicas, 'per_replica': per_replica, 'sick': sick}
        owned = owned_bytes()
        if not state['flusher_alive']:
            status = 'flusher-dead'
        elif not numerics_ok or not breaker_ok or sick:
            status = 'degraded'
        else:
            status = 'ok'
        dumps = snap.get('serve/debug_dumps')
        return {
            'status': status,
            **state,
            **({'replicas': replicas_block} if replicas_block is not None else {}),
            'numerics': {
                'ok': numerics_ok,
                'nonfinite_events': nonfinite_events,
                'parity': parity_stats,
            },
            'breaker': breaker_block,
            'flusher_restarts': self._batcher.flusher_restarts,
            'model': {
                'name': name,
                'version': version,
                'quantize': self._model_quantize(),
                'kernel': self._model_kernel(),
            },
            'ladder': list(self.ladder),
            'compiled_shapes': self.compiled_shapes,
            'aot': self._aot_block(),
            'capacity': {
                'perf': perf_snapshot(),
                'owned_bytes': owned,
                'owned_total_bytes': sum(owned.values()),
            },
            'slo': slo_block,
            'rejected_total': int(snap.value('serve/rejected_total')),
            'debug_dumps': int(sum(s.total for s in dumps.series) if dumps is not None else 0),
            'last_dump': self.last_dump_path,
            'uptime_s': time.monotonic() - self._started_t,
        }

    def telemetry(self, replica: Optional[str] = None) -> Any:
        """This service's exposition bundle for the fleet scrape surface.

        A :class:`~socceraction_tpu_torch.obs.endpoint.Telemetry` over the
        process registry, this service's :meth:`health` and the flight
        recorder; serve it with
        ``obs.endpoint.serve(telemetry=service.telemetry(replica='serve-0'))``.
        ``replica`` is the fleet slot name (default: a host-pid id). Every
        route reads host state only.
        """
        from ..obs.endpoint import Telemetry

        return Telemetry(replica=replica, health=self.health)

    # -- lifecycle ---------------------------------------------------------

    def _aot_source(self, name: str, version: str) -> Optional[str]:
        """Where this service's shipped libraries live, or ``None``."""
        if self._aot_dir_override is not None:
            return self._aot_dir_override
        if self._registry is not None:
            return self._registry.aot_dir(name, version)
        return None

    def _load_aot_for(self, name: str, version: str, model: Any) -> Optional[Dict[str, Any]]:
        """Try the warm tier for one model version; never raises.

        The whole path — manifest parse, fingerprint and layout check,
        checksum-verified library reads (the ``registry.aot`` fault point
        and retry site), installing — lives in
        :func:`~socceraction_tpu_torch.serve.aot.load_serving_aot`, which
        reports every failure as a counted ``stale``/``miss`` instead of
        raising. So a corrupt library, a moved toolkit or another card can
        never fail a warmup or a swap: the build runs right after, at the
        first dispatch of each kernel.
        """
        source = self._aot_source(name, version)
        if source is None:
            return None
        from .aot import load_serving_aot

        state = load_serving_aot(
            model, source, ladder=self._batcher.ladder, max_actions=self.max_actions,
            context={'model': f'{name}/{version}'},
        )
        self._aot_state = state
        self._aot_tried_for = (name, version)
        return state

    def load_aot(self) -> Optional[Dict[str, Any]]:
        """Install the shipped kernel libraries of the active model (tier 1).

        The explicit first tier of :meth:`warmup`: callers that meter their
        cold start phase by phase (the ``aot_deserialize`` phase) run it
        on its own; ``warmup()`` otherwise runs it. Returns the load
        summary (``outcome`` ``hit``/``stale``/``miss``, see
        :func:`~socceraction_tpu_torch.serve.aot.load_serving_aot`), or
        ``None`` when the service has no artifact source (model-backed, no
        ``aot_dir=``). Idempotent per active version.
        """
        name, version, model = self._active()
        if self._aot_tried_for == (name, version):
            return self._aot_state
        return self._load_aot_for(name, version, model)

    def warmup(
        self,
        buckets: Optional[Tuple[int, ...]] = None,
        *,
        scenario_buckets: Optional[Tuple[int, ...]] = None,
    ) -> Tuple[int, ...]:
        """Warm the bucket ladder: shipped libraries > cache > ``nvcc``.

        Every rung of every lane goes through :meth:`_device_rate`, not
        through the breaker, so a B1 that cannot build or launch (or
        refuses the model's widths) raises out of this call before any
        traffic arrives. Seq models warm every window rung too.
        ``scenario_buckets`` adds perturbation rungs: a scenario flush at
        bucket ``b`` is the shape of a ``b``-game rate flush, so warming
        ``b`` (e.g. :attr:`scenario_ladder`) warms the verb. After warmup
        the shape counters stay flat under any traffic.

        The kernels' libraries come from the best tier available:

        1. **shipped libraries** — :meth:`load_aot`: when the registry
           version (or ``aot_dir=``) carries ``aot/`` artifacts and the
           fingerprint matches, each checksum-verified library is
           installed where ``load_library`` finds it, so the first
           dispatch loads it and ``nvcc`` never runs;
        2. **the compile cache** — the build directory named by
           ``SOCCERACTION_TPU_COMPILE_CACHE``
           (:func:`~socceraction_tpu_torch.serve.aot.enable_compile_cache`):
           a library a sibling replica built there is loaded;
        3. **``nvcc``** — the library is built at its first dispatch.

        Returns the buckets warmed.
        """
        buckets = tuple(buckets) if buckets is not None else self._batcher.ladder
        if scenario_buckets:
            buckets = tuple(sorted(set(buckets) | {int(b) for b in scenario_buckets}))
        name, version, model = self._active()
        from .aot import enable_compile_cache

        try:
            self._cache_state = {'dir': enable_compile_cache()}
        except Exception as e:
            # a broken cache dir must not fail warmup, but "off by choice"
            # and "broken" must read differently: record the error where
            # the warm tier's outcomes live
            self._cache_state = {'dir': None, 'error': f'{type(e).__name__}: {e}'}
            from ..obs.recorder import RECORDER

            try:
                RECORDER.record('compile_cache_error', **self._cache_state)
            except Exception:
                pass
        if self._aot_tried_for != (name, version):
            self._load_aot_for(name, version, model)
        A = self.max_actions
        rungs: Tuple[Optional[int], ...] = (
            window_ladder(A) if getattr(model, 'time_rungs', False) else (None,)
        )
        with span('serve/warmup', buckets=list(buckets)):
            # every lane warms its own ladder, so steady traffic adds a
            # shape on no lane
            for lane in range(self.n_replicas):
                for b in buckets:
                    for tl in rungs:
                        self._device_rate(
                            _empty_host_batch(1, A), _empty_gs(1, A), model, b, lane=lane,
                            time_len=tl,
                        )
        return buckets

    def close(self, *, drain: bool = True) -> None:
        """Flush (or fail) queued requests and stop the flusher thread; the
        parity probe, when attached, is closed after its pending probes, and
        a breach's debug bundle is written before this returns."""
        self._batcher.close(drain=drain)
        if self.parity is not None:
            self.parity.close()
        with self._dump_lock:
            dumps, self._dumps = self._dumps, []
        for dump in dumps:
            dump.join()

    def __enter__(self) -> 'RatingService':
        return self

    def __exit__(self, *exc: Any) -> None:
        self.close()

    # -- introspection -----------------------------------------------------

    @property
    def ladder(self) -> Tuple[int, ...]:
        """The bucket ladder (the shape budget) of this service."""
        return self._batcher.ladder

    @property
    def scenario_ladder(self) -> Tuple[int, ...]:
        """The scenario verb's perturbation ladder ``(1, 2, 4, ...,
        max_perturbations)``: every bucket a request's ``P`` can snap to,
        each the shape of a rate flush of that many games."""
        return perturbation_ladder(self.max_perturbations)

    @property
    def compiled_shapes(self) -> int:
        """Distinct ``(bucket, max_actions)`` shapes dispatched so far (the
        JAX service's compiled programs: here, shapes first launched)."""
        with self._shape_lock:
            return len(self._seen_shapes)

    @property
    def breaker(self) -> Optional[CircuitBreaker]:
        """The fused-dispatch circuit breaker (None when disabled); lane
        0's on a service with lanes (:attr:`breakers` has them all)."""
        return self._breakers[0]

    @property
    def breakers(self) -> Tuple[Optional[CircuitBreaker], ...]:
        """Every lane's circuit breaker, indexed by replica."""
        return tuple(self._breakers)

    @property
    def nonfinite_events(self) -> int:
        """Nonfinite in-dispatch guard events drained by this service."""
        with self._dump_lock:
            return self._nonfinite_events


def _on_device(device: torch.device) -> Any:
    """The card's device context for a dispatch from any thread (a no-op
    for the CPU)."""
    if device.type == 'cuda':
        return torch.cuda.device(device)
    return contextlib.nullcontext()


def _on_stream(stream: Any, device: torch.device) -> Any:
    """A lane's stream made current, after it waits for what the device's
    default stream was given before (model loads, folds); a no-op without
    a stream (one lane, or a lane on the CPU)."""
    if stream is None:
        return contextlib.nullcontext()
    stream.wait_stream(torch.cuda.default_stream(device))
    return torch.cuda.stream(stream)


def _lane_devices(device: torch.device, n_lanes: int) -> Tuple[torch.device, ...]:
    """Where each lane sits: lane ``i`` on card ``i`` modulo the process's
    cards for a model on a card (several lanes share a card when the
    process has fewer cards than lanes), all on the CPU for a CPU model."""
    if device.type != 'cuda':
        return (device,) * n_lanes
    count = torch.cuda.device_count()
    return tuple(torch.device('cuda', i % count) for i in range(n_lanes))


def _upload(
    host_batch: ActionBatch,
    gs: Optional[np.ndarray],
    device: torch.device,
    extra: Optional[Dict[str, np.ndarray]] = None,
) -> Tuple[ActionBatch, Optional[Dict[str, torch.Tensor]]]:
    """A host staging batch, its goalscore block and any ``extra`` dense
    blocks (a scenario grid's) on ``device``.

    On a card each array is copied from pinned memory without waiting, on
    the current stream; the batch keeps the host's action count, so
    nothing here reads the device.
    """

    def put(a: np.ndarray) -> torch.Tensor:
        t = torch.from_numpy(np.ascontiguousarray(a))
        if device.type == 'cuda':
            return t.pin_memory().to(device, non_blocking=True)
        return t.to(device)

    batch = type(host_batch)(**{n: put(a) for n, a in host_batch.fields().items()})
    batch = batch.with_total(host_batch.total_actions)
    overrides = {'goalscore': put(gs)} if gs is not None else {}
    overrides.update({k: put(v) for k, v in (extra or {}).items()})
    return batch, overrides or None


def _concat_games(stagings: List[ActionBatch]) -> ActionBatch:
    """Host staging batches stacked along the game axis, field by field."""
    names = list(stagings[0].fields())
    return type(stagings[0])(
        **{n: np.concatenate([getattr(s, n) for s in stagings], axis=0) for n in names}
    )


def _pad_to_bucket(
    host_batch: ActionBatch, gs: Optional[np.ndarray], bucket: int
) -> Tuple[ActionBatch, Optional[np.ndarray]]:
    """Pad a staging batch (and its goalscore block) up to the bucket.

    The ONE home of the padding rule, shared by the flush (which pads
    early so the cost lands in the 'pad' segment) and ``_device_rate``
    (whose call no-ops on pre-padded batches but still covers warmup's
    direct 1-game dispatches).
    """
    if host_batch.n_games != bucket:
        host_batch = pad_batch_games(host_batch, bucket)
        if gs is not None:
            gs = np.pad(gs, [(0, bucket - gs.shape[0]), (0, 0), (0, 0)])
    return host_batch, gs


def _slice_window(
    host_batch: ActionBatch, gs: Optional[np.ndarray], time_len: int
) -> Tuple[ActionBatch, Optional[np.ndarray]]:
    """Slice the action axis of a staging batch to its window rung.

    Per-action ``(G, A)`` fields (and the ``(G, A, 3)`` goalscore block)
    drop their masked tail beyond ``time_len``; per-game ``(G,)`` fields
    pass through. Only valid for ``time_len >= n_actions.max()``.
    """
    sliced = dataclasses.replace(
        host_batch,
        **{n: a[:, :time_len] for n, a in host_batch.fields().items() if a.ndim >= 2},
    )
    if gs is not None:
        gs = gs[:, :time_len]
    return sliced, gs


def _pad_values_time(values: np.ndarray, max_actions: int) -> np.ndarray:
    """Zero-pad a ``(G, a, 3)`` values block back to full action capacity."""
    if values.shape[1] < max_actions:
        values = np.pad(values, [(0, 0), (0, max_actions - values.shape[1]), (0, 0)])
    return values


def _empty_host_batch(n_games: int, max_actions: int) -> ActionBatch:
    """An all-padding staging batch (warms every rung)."""
    G, A = n_games, max_actions
    i32 = np.zeros((G, A), dtype=np.int32)
    f32 = np.zeros((G, A), dtype=np.float32)
    return ActionBatch(
        type_id=i32, result_id=i32, bodypart_id=i32, period_id=i32,
        is_home=np.zeros((G, A), dtype=bool),
        time_seconds=f32, start_x=f32, start_y=f32, end_x=f32, end_y=f32,
        mask=np.zeros((G, A), dtype=bool),
        n_actions=np.zeros((G,), dtype=np.int32),
        game_id=np.arange(G, dtype=np.int32),
        row_index=np.full((G, A), -1, dtype=np.int32),
    )


def _empty_gs(n_games: int, max_actions: int) -> np.ndarray:
    return np.zeros((n_games, max_actions, 3), dtype=np.float32)
