"""Micro-batching queue: coalesce concurrent rating requests into buckets.

A copy of the JAX package's ``socceraction_tpu/serve/batcher.py``; it
touches no device. One request is one match's (or one session window's)
actions — a single game-row of a device batch. Dispatching each request
alone would pay a whole dispatch per request and launch one shape per
distinct batch size; the batcher instead multiplexes every concurrent
caller onto the fused one-dispatch rating path:

- **coalescing** — requests accumulate in a bounded queue and flush as
  ONE device batch when ``max_batch_size`` requests are waiting or the
  oldest request has aged ``max_wait_ms`` (latency bound), whichever
  comes first;
- **shape buckets** — a flush of ``n`` requests is padded up to the
  power-of-two bucket ladder
  (:func:`socceraction_tpu_torch.core.batch.bucket_ladder`), so steady-state
  traffic runs a small, pinned set of shapes;
- **admission control** — past ``max_queue`` waiting requests, ``submit``
  raises :class:`Overloaded` immediately instead of growing the queue
  (and its memory) without bound; callers shed load explicitly.

The batcher is policy-only. A ``runner`` callable (the service's flush,
:meth:`socceraction_tpu_torch.serve.service.RatingService._flush`) turns a
list of payloads plus a bucket size into one result per payload; the
batcher owns the queue, the deadline clock, the futures and the
``serve/*`` telemetry. Everything is thread-safe; all device work happens
on the flusher threads.

With ``n_lanes > 1`` N flusher threads drain the ONE shared queue
concurrently: each lane takes a flush, dispatches it through the runner
with its lane index, and goes back for more — a sick or slow lane never
blocks the others' take loop. Crash supervision is per lane: a lane's
restart budget is its own, and a permanently dead lane strands nothing —
its un-flushed requests go back to the shared queue for live lanes, and
only the death of the LAST live lane fails the queue and rejects new
submits. Flush-scoped telemetry carries a ``replica=`` label when lanes
are named (``lane_names``). The rating service runs one lane.
"""

from __future__ import annotations

import inspect
import threading
import time
from collections import deque
from concurrent.futures import Future
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

from ..core.batch import bucket_ladder
from ..obs import counter, gauge, histogram, span
from ..obs.context import (
    DeadlineExceeded,
    RequestContext,
    record_request_done,
    record_request_enqueue,
    record_segment,
)
from ..obs.recorder import RECORDER
from ..resil.faults import fault_point

__all__ = ['DeadlineExceeded', 'MicroBatcher', 'Overloaded']


class Overloaded(RuntimeError):
    """Raised by ``submit`` when the admission queue is full.

    The explicit load-shedding signal: the caller sees it synchronously
    (no future is created) and can retry, down-sample or propagate a 429 —
    the alternative, unbounded queueing, turns overload into unbounded
    memory growth and unbounded latency for every request behind it.
    """


class _Request:
    __slots__ = ('payload', 'kind', 'future', 't0', 'ctx')

    def __init__(
        self, payload: Any, kind: str, ctx: Optional[RequestContext] = None
    ) -> None:
        self.payload = payload
        self.kind = kind
        self.future: Future = Future()
        self.ctx = ctx
        self.t0 = ctx.enqueue_t if ctx is not None else time.perf_counter()


class MicroBatcher:
    """Thread-safe micro-batching queue in front of a batch runner.

    Parameters
    ----------
    runner : callable
        ``runner(payloads, bucket) -> results`` — rates one coalesced
        batch; ``bucket >= len(payloads)`` is the ladder size the device
        batch must be padded to, and ``results`` must align with
        ``payloads``. Runs on a flusher thread only. A runner declaring
        a ``lane`` parameter receives the dispatching lane's index as
        ``lane=<int>`` (the service routes it to that replica's device);
        a two-argument runner keeps working unchanged.
    max_batch_size : int
        Flush immediately once this many requests are waiting. Also the
        top of the bucket ladder (rounded up to a power of two).
    max_wait_ms : float
        Deadline flush: a request never waits longer than this for
        co-batching before its flush is dispatched.
    max_queue : int
        Admission bound: ``submit`` past this many waiting requests
        raises :class:`Overloaded`.
    on_crash : callable, optional
        ``on_crash(exc)`` invoked (once, on the dying thread) if the
        flusher thread dies *permanently* — i.e. an exception escapes
        the take loop rather than a flush (flush failures land on the
        affected futures and the thread lives on) and the restart
        supervisor's budget is spent. The service hooks its
        flight-recorder dump here.
    max_flusher_restarts : int
        Supervised-restart budget: a crashed flusher thread is replaced
        (its un-flushed requests re-queued at the front, so nothing is
        stranded or reordered) up to this many times within
        ``flusher_restart_window_s``. Past the budget the crash is
        permanent: queued requests fail, new submits are rejected and
        ``on_crash`` fires — a crash loop must not masquerade as a
        healthy service. ``0`` restores the pre-supervision behavior
        (every crash is permanent).
    flusher_restart_window_s : float
        The sliding window the restart budget is counted over.
    on_restart : callable, optional
        ``on_restart(exc, n_in_window)`` invoked (on the dying thread,
        before its replacement starts) per supervised restart; must not
        raise (it is guarded). Restarts are always recorded in the
        flight recorder and counted under ``serve/flusher_restarts``
        regardless — the hook is for callers that want more (no debug
        bundle by default: the permanent-death ``flusher_crash`` bundle
        must stay the newest artifact after a crash loop).
    on_request_done : callable, optional
        ``on_request_done(ctx, kind, wall_s, status)`` invoked on the
        flusher thread for every request that reaches a terminal state
        (``status`` in ``'ok'`` | ``'error'`` | ``'expired'``). The
        service hooks its SLO engine here; the hook must not raise (a
        raising hook is swallowed, never the flush).
    n_lanes : int
        Concurrent flusher threads draining the shared queue (default 1,
        the classic single-flusher batcher). The mesh service runs one
        lane per replica so every replica keeps one dispatch in flight.
        Restart budgets, crash state and flush telemetry are per lane.
    lane_names : sequence of str, optional
        Telemetry identity per lane (the service passes replica ids).
        When given, flush-scoped ``serve/*`` series carry a
        ``replica=<name>`` label; when omitted they stay unlabeled, so a
        single-lane batcher's series are byte-identical to before.
    """

    def __init__(
        self,
        runner: Callable[[List[Any], int], Sequence[Any]],
        *,
        max_batch_size: int = 64,
        max_wait_ms: float = 2.0,
        max_queue: int = 256,
        on_crash: Optional[Callable[[BaseException], None]] = None,
        on_request_done: Optional[
            Callable[[Optional[RequestContext], str, float, str], None]
        ] = None,
        max_flusher_restarts: int = 3,
        flusher_restart_window_s: float = 60.0,
        on_restart: Optional[Callable[[BaseException, int], None]] = None,
        n_lanes: int = 1,
        lane_names: Optional[Sequence[str]] = None,
    ) -> None:
        if max_batch_size < 1:
            raise ValueError('max_batch_size must be >= 1')
        if max_queue < max_batch_size:
            raise ValueError('max_queue must be >= max_batch_size')
        if n_lanes < 1:
            raise ValueError('n_lanes must be >= 1')
        if lane_names is not None and len(lane_names) != n_lanes:
            raise ValueError(
                f'{len(lane_names)} lane_names for {n_lanes} lanes'
            )
        self._runner = runner
        self.max_batch_size = max_batch_size
        self.max_wait_s = max_wait_ms / 1000.0
        self.max_queue = max_queue
        self.ladder: Tuple[int, ...] = bucket_ladder(max_batch_size)
        self.n_lanes = int(n_lanes)
        self.lane_names: Optional[Tuple[str, ...]] = (
            tuple(lane_names) if lane_names is not None else None
        )
        self._lock = threading.Lock()
        self._cond = threading.Condition(self._lock)
        self._queue: List[_Request] = []
        self._closed = False
        self._threads: Dict[int, threading.Thread] = {}
        self._on_crash = on_crash
        self._on_request_done = on_request_done
        self._crashed_lanes: Dict[int, BaseException] = {}
        self._last_flush_t: Optional[float] = None
        self.max_flusher_restarts = int(max_flusher_restarts)
        self.flusher_restart_window_s = float(flusher_restart_window_s)
        self._on_restart = on_restart
        self._restart_times: Dict[int, 'deque[float]'] = {
            i: deque() for i in range(self.n_lanes)
        }
        self._restarts_total = 0

    @property
    def _runner(self) -> Callable:
        return self._runner_fn

    @_runner.setter
    def _runner(self, runner: Callable) -> None:
        # a runner declaring `lane` gets the dispatching lane's index;
        # legacy (payloads, bucket) runners keep working unchanged. A
        # setter (not a one-shot __init__ probe) so tests that swap
        # `_runner` for a two-arg stub get the legacy calling convention.
        self._runner_fn = runner
        try:
            self._runner_takes_lane = (
                'lane' in inspect.signature(runner).parameters
            )
        except (TypeError, ValueError):  # builtins / C callables
            self._runner_takes_lane = False

    def _lane_kw(self, lane: int) -> Dict[str, str]:
        """The ``replica=`` label of one lane's flush-scoped series."""
        if self.lane_names is None:
            return {}
        return {'replica': self.lane_names[lane]}

    def _lane_label(self, lane: int) -> str:
        return (
            self.lane_names[lane] if self.lane_names is not None
            else str(lane)
        )

    # -- submission --------------------------------------------------------

    def submit(
        self,
        payload: Any,
        *,
        kind: str = 'rate',
        ctx: Optional[RequestContext] = None,
    ) -> Future:
        """Enqueue one request; returns its :class:`concurrent.futures.Future`.

        Raises :class:`Overloaded` when the admission queue is full and
        ``RuntimeError`` after :meth:`close`. ``kind`` is a low-cardinality
        telemetry label (``rate`` | ``session`` | ``warmup``). ``ctx``, when
        given, is the request's trace identity: its id links the request
        into the flush span and run-log events, and its deadline is
        enforced at flush time — an expired request is failed with
        :class:`~socceraction_tpu_torch.obs.context.DeadlineExceeded` instead
        of being dispatched late.
        """
        req = _Request(payload, kind, ctx)
        with self._cond:
            if self._closed:
                raise RuntimeError('batcher is closed')
            if len(self._crashed_lanes) >= self.n_lanes:
                exc = next(iter(self._crashed_lanes.values()))
                raise RuntimeError(
                    f'flusher thread died: {exc!r} '
                    '(see the debug bundle; start a new service)'
                )
            if len(self._queue) >= self.max_queue:
                counter('serve/rejected_total', unit='requests').inc(1)
                raise Overloaded(
                    f'{len(self._queue)} requests already queued '
                    f'(max_queue={self.max_queue}); shed load or raise the bound'
                )
            self._queue.append(req)
            depth = len(self._queue)
            if not self._threads:
                for lane in range(self.n_lanes):
                    self._spawn_lane(lane)
            self._cond.notify()
        gauge('serve/queue_depth', unit='requests').set(depth)
        counter('serve/requests', unit='requests').inc(1, kind=kind)
        if ctx is not None:
            req.future.request_id = ctx.request_id  # type: ignore[attr-defined]
            req.future.context = ctx  # type: ignore[attr-defined]
            record_request_enqueue(ctx, depth)
        return req.future

    def _spawn_lane(self, lane: int) -> None:
        """Start (or replace) lane ``lane``'s flusher thread. Lock held."""
        name = 'serve-flusher' if self.n_lanes == 1 else (
            f'serve-flusher-{self._lane_label(lane)}'
        )
        t = threading.Thread(
            target=self._flush_loop, args=(lane,), name=name, daemon=True
        )
        self._threads[lane] = t
        t.start()

    def bucket_for(self, n: int) -> int:
        """The smallest ladder rung admitting ``n`` requests."""
        for b in self.ladder:
            if b >= n:
                return b
        return self.ladder[-1]

    # -- the flusher thread ------------------------------------------------

    def _take(self) -> Tuple[List[_Request], str]:
        """Block until a flush is due; pop and return (requests, reason).

        Called on the flusher thread. Returns ``([], 'closed')`` when the
        batcher is closed and drained.
        """
        with self._cond:
            while True:
                if self._queue:
                    if len(self._queue) >= self.max_batch_size:
                        reason = 'full'
                        break
                    if self._closed:
                        reason = 'close'
                        break
                    deadline = self._queue[0].t0 + self.max_wait_s
                    now = time.perf_counter()
                    if now >= deadline:
                        reason = 'deadline'
                        break
                    self._cond.wait(timeout=deadline - now)
                elif self._closed:
                    return [], 'closed'
                else:
                    self._cond.wait()
            take = self._queue[: self.max_batch_size]
            del self._queue[: len(take)]
            depth = len(self._queue)
        gauge('serve/queue_depth', unit='requests').set(depth)
        return take, reason

    def _flush_loop(self, lane: int = 0) -> None:
        taken: List[_Request] = []
        try:
            while True:
                taken, reason = self._take()
                if not taken:
                    return
                # the named chaos point for flusher-death schedules: an
                # injected error here escapes the take loop (not the
                # per-flush guard) and exercises the restart supervisor
                fault_point('batcher.flush', requests=len(taken))
                self._flush(taken, reason, lane)
                taken = []
                self._last_flush_t = time.monotonic()
        except BaseException as e:  # noqa: BLE001 - the thread is dying
            self._crash(e, taken, lane)

    def _crash(
        self, e: BaseException, taken: List[_Request], lane: int
    ) -> None:
        """A dying flusher thread's last act: restart, retire or fail all.

        Within the lane's budget (``max_flusher_restarts`` per
        ``flusher_restart_window_s``, counted per lane) the thread is
        replaced and the requests it had taken but not flushed go back
        to the FRONT of the queue — order preserved, no future stranded,
        callers never see the crash. Past the budget the lane's death is
        permanent — but with live lanes remaining it retires ALONE: its
        taken requests re-queue for the survivors and submits keep
        flowing (the mesh topology's single-sick-replica degradation).
        Only the LAST live lane's permanent death fails the queue,
        rejects new submits and fires ``on_crash``.
        """
        now = time.monotonic()
        restarted = False
        n_window = 0
        with self._cond:
            times = self._restart_times[lane]
            cutoff = now - self.flusher_restart_window_s
            while times and times[0] < cutoff:
                times.popleft()
            if (
                not self._closed
                and len(times) < self.max_flusher_restarts
            ):
                times.append(now)
                self._restarts_total += 1
                n_window = len(times)
                self._queue[:0] = taken
                restarted = True
        if restarted:
            # account + hook BEFORE the replacement starts: the new
            # thread may crash instantly (a persistent fault), and its
            # permanent-death dump must come chronologically after this
            # restart's, not race it
            counter('serve/flusher_restarts', unit='count').inc(
                1, **self._lane_kw(lane)
            )
            restart_payload = {
                'error': f'{type(e).__name__}: {e}',
                'restarts_in_window': n_window,
                'requeued': len(taken),
                'lane': self._lane_label(lane),
            }
            RECORDER.record('flusher_restart', **restart_payload)
            try:
                # dual-write to the run log so `obsctl resil <runlog>`
                # can show supervised restarts post-mortem (the recorder
                # ring dies with the process)
                from ..obs.trace import current_runlog

                log = current_runlog()
                if log is not None:
                    log.event('flusher_restart', **restart_payload)
            except Exception:
                pass  # telemetry must not fail the restart
            if self._on_restart is not None:
                try:
                    self._on_restart(e, n_window)
                except Exception:  # the hook must not kill the handler
                    pass
            with self._cond:
                # spawn even if close() raced in: the replacement drains
                # a closed queue correctly and exits via _take
                self._spawn_lane(lane)
                self._cond.notify_all()
            return
        counter('serve/flusher_crashes', unit='count').inc(
            1, **self._lane_kw(lane)
        )
        with self._cond:
            self._crashed_lanes[lane] = e
            last_lane = len(self._crashed_lanes) >= self.n_lanes
            if last_lane:
                dropped, self._queue = self._queue, []
            else:
                # survivors drain these: order preserved, nothing strands
                self._queue[:0] = taken
                self._cond.notify_all()
        RECORDER.record(
            'flusher_crash', error=f'{type(e).__name__}: {e}',
            queue_depth=self.queue_depth, lane=self._lane_label(lane),
            last_lane=last_lane,
        )
        if not last_lane:
            return
        # The LAST flusher died: anything queued (and any future submit)
        # would otherwise strand forever — fail it all and hand the
        # exception to the crash hook (the service's debug-bundle dump).
        dropped = taken + dropped
        for r in dropped:
            if r.future.set_running_or_notify_cancel():
                r.future.set_exception(
                    RuntimeError(f'flusher thread died: {e!r}')
                )
        if self._on_crash is not None:
            try:
                self._on_crash(e)
            except Exception:  # the hook must not mask the crash
                pass

    def _notify_done(self, req: _Request, wall_s: float, status: str) -> None:
        """Invoke the terminal-state hook; a raising hook never escapes."""
        if self._on_request_done is not None:
            try:
                self._on_request_done(req.ctx, req.kind, wall_s, status)
            except Exception:
                pass

    def _expire(self, req: _Request, now: float) -> None:
        """Fail one deadline-expired request without dispatching it.

        The whole wait was queue time, so it is attributed to the
        ``queue_wait`` segment; the request never reaches the runner
        (a caller that stopped waiting must not burn device time) and —
        because the future resolves with an error — is never recorded
        by the service's traffic capture.
        """
        ctx = req.ctx
        assert ctx is not None  # only ctx-carrying requests have deadlines
        wait = now - req.t0
        ctx.segments['queue_wait'] = wait
        record_segment('queue_wait', wait, ctx.request_id)
        counter('serve/deadline_expired', unit='requests').inc(1, kind=req.kind)
        err = DeadlineExceeded(
            f'request {ctx.request_id} spent {wait * 1e3:.1f}ms queued, past '
            f'its deadline (never dispatched); slow down or raise the deadline'
        )
        record_request_done(ctx, 'expired', wait, error=str(err))
        self._notify_done(req, wait, 'expired')
        req.future.set_exception(err)

    def _flush(self, take: List[_Request], reason: str, lane: int = 0) -> None:
        # Transition every future to RUNNING; a caller that cancel()ed
        # while queued is dropped here. After this point cancel() can no
        # longer succeed, so set_result below cannot raise
        # InvalidStateError and kill the flusher thread.
        take = [r for r in take if r.future.set_running_or_notify_cancel()]
        try:
            self._flush_running(take, reason, lane)
        except BaseException as e:  # noqa: BLE001 - never strand a future
            # a RUNNING future whose flush died any other way than the
            # runner path below would hang its caller forever (and the
            # escaping exception would kill the flusher thread for
            # everyone else) — fail what this flush owns, with the same
            # per-request error accounting as a runner failure (the SLO
            # engine and the trace must see these failures too), and
            # live on
            self._fail_requests(take, e)

    def _fail_requests(
        self,
        requests: List[_Request],
        exc: BaseException,
        *,
        bucket: Optional[int] = None,
        coalesced: Optional[int] = None,
    ) -> None:
        """Resolve every unresolved request as failed, fully accounted.

        Each request's accounting (request_done event, SLO hook) is
        individually guarded: if telemetry itself is what raised (a full
        disk under the run log), the remaining futures must still fail
        rather than strand.
        """
        done = time.perf_counter()
        for r in requests:
            if r.future.done():
                continue
            wall = done - r.t0
            if r.ctx is not None:
                try:
                    record_request_done(
                        r.ctx, 'error', wall, bucket=bucket,
                        coalesced=coalesced,
                        error=f'{type(exc).__name__}: {exc}',
                    )
                except Exception:
                    pass
            self._notify_done(r, wall, 'error')
            r.future.set_exception(exc)

    def _flush_running(
        self, take: List[_Request], reason: str, lane: int = 0
    ) -> None:
        now = time.perf_counter()
        live: List[_Request] = []
        for r in take:
            if r.ctx is not None and r.ctx.expired(now):
                self._expire(r, now)
            else:
                live.append(r)
        if not live:
            return
        lane_kw = self._lane_kw(lane)
        bucket = self.bucket_for(len(live))
        fill = len(live) / bucket
        counter('serve/flushes', unit='count').inc(1, reason=reason, **lane_kw)
        gauge('serve/batch_fill_ratio', unit='ratio').set(fill)
        request_ids = [r.ctx.request_id for r in live if r.ctx is not None]
        RECORDER.record(
            'serve_queue', taken=len(live), bucket=bucket, reason=reason,
            queue_depth=self.queue_depth, fill_ratio=fill,
            request_ids=request_ids, lane=self._lane_label(lane),
        )
        # every coalesced request's queue wait ends here: the flush owns
        # the rest of the wall (pad/dispatch/slice, recorded by the runner)
        flush_t0 = time.perf_counter()
        for r in live:
            wait = flush_t0 - r.t0
            if r.ctx is not None:
                r.ctx.segments['queue_wait'] = wait
            record_segment(
                'queue_wait', wait, r.ctx.request_id if r.ctx else None,
                **lane_kw,
            )
        try:
            # the flush span lists the coalesced request ids: the link
            # from one shared dispatch back to every request it served
            with span(
                'serve/flush', requests=len(live), bucket=bucket,
                request_ids=request_ids, **lane_kw,
            ) as flush_span:
                with histogram('serve/flush_seconds', unit='s').time(
                    bucket=str(bucket), **lane_kw
                ):
                    payloads = [r.payload for r in live]
                    if self._runner_takes_lane:
                        results = self._runner(payloads, bucket, lane=lane)
                    else:
                        results = self._runner(payloads, bucket)
            if len(results) != len(live):
                raise RuntimeError(
                    f'runner returned {len(results)} results for '
                    f'{len(live)} requests'
                )
        except BaseException as e:  # noqa: BLE001 - failures go to the futures
            self._fail_requests(live, e, bucket=bucket, coalesced=len(live))
            return
        done = time.perf_counter()
        lat = histogram('serve/request_seconds', unit='s')
        for r, out in zip(live, results):
            wall = done - r.t0
            lat.observe(
                wall,
                exemplar=(
                    {'request_id': r.ctx.request_id} if r.ctx else None
                ),
                kind=r.kind,
            )
            if r.ctx is not None:
                record_request_done(
                    r.ctx, 'ok', wall, bucket=bucket, coalesced=len(live),
                    flush_span_id=flush_span.span_id,
                )
            self._notify_done(r, wall, 'ok')
            r.future.set_result(out)

    # -- introspection -----------------------------------------------------

    @property
    def queue_depth(self) -> int:
        """Requests currently waiting for a flush."""
        with self._lock:
            return len(self._queue)

    @property
    def crashed(self) -> Optional[BaseException]:
        """The exception that killed the LAST flusher thread, or None.

        A multi-lane batcher with live lanes remaining reports None here
        (it still serves); :attr:`dead_lanes` names partial casualties.
        """
        with self._lock:
            if len(self._crashed_lanes) < self.n_lanes:
                return None
            return next(iter(self._crashed_lanes.values()))

    @property
    def dead_lanes(self) -> Dict[int, BaseException]:
        """Lanes whose flusher died permanently (index -> exception)."""
        with self._lock:
            return dict(self._crashed_lanes)

    @property
    def flusher_restarts(self) -> int:
        """Supervised flusher restarts performed so far (lifetime)."""
        with self._lock:
            return self._restarts_total

    @property
    def flusher_alive(self) -> bool:
        """False once ALL flusher lanes have died (crash or exit); True
        while any runs or before they have lazily started."""
        with self._lock:
            if len(self._crashed_lanes) >= self.n_lanes:
                return False
            threads = list(self._threads.values())
        return not threads or any(t.is_alive() for t in threads)

    @property
    def last_flush_age_s(self) -> Optional[float]:
        """Seconds since the last completed flush (None before any)."""
        t = self._last_flush_t
        return None if t is None else time.monotonic() - t

    # -- lifecycle ---------------------------------------------------------

    def close(self, *, drain: bool = True) -> None:
        """Stop the flusher. ``drain=True`` (default) rates what is queued
        first; ``drain=False`` fails queued requests with RuntimeError."""
        with self._cond:
            if not self._closed:
                self._closed = True
                if not drain:
                    dropped, self._queue = self._queue, []
                    for r in dropped:
                        if r.future.set_running_or_notify_cancel():
                            r.future.set_exception(
                                RuntimeError('batcher closed before flush')
                            )
            self._cond.notify_all()
            threads = list(self._threads.values())
        for t in threads:
            t.join(timeout=30.0)

    def __enter__(self) -> 'MicroBatcher':
        return self

    def __exit__(self, *exc: Any) -> None:
        self.close()
