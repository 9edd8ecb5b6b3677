"""Request-scoped trace context: one identity per rating request.

A copy of the JAX package's ``socceraction_tpu/obs/context.py``, for the
serving layer. Spans (:mod:`socceraction_tpu_torch.obs.trace`) nest per
*thread*, which is the wrong axis for a micro-batched server: a caller's
request enters the queue on its own thread, is coalesced with strangers
on the flusher thread, and resolves back on a future. A
:class:`RequestContext` is the identity that rides the request across
that boundary:

- minted at request time (:func:`new_request_context`): a
  process-unique ``request_id``, the enqueue timestamp, an optional
  absolute deadline, and the id of the caller's innermost open span (so
  a request can be linked back into the submitting thread's trace);
- its wall decomposed into **queue-wait / pad-overhead / dispatch /
  slice-back** segments (:func:`record_segment`), recorded both on the
  context (``ctx.segments``) and as the
  ``serve/segment_seconds{segment=...}`` histogram with the request id
  attached as an exemplar;
- lifecycle events (:func:`record_request_enqueue`,
  :func:`record_request_done`) land in the active
  :class:`~socceraction_tpu_torch.obs.trace.RunLog` and the
  flight-recorder ring, so one request's path through a shared dispatch
  can be rebuilt from the run log;
- carried **across the process boundary** by :meth:`RequestContext.to_wire`
  / :meth:`RequestContext.from_wire`: the receiving process reconstructs
  a context with the SAME ``request_id`` (and the remaining deadline
  re-anchored to its own clock — ``perf_counter`` instants never cross
  processes), one ``hop`` deeper. The headers are the JAX package's, so
  a request may cross from one package's process to the other's.

Stdlib only.
"""

from __future__ import annotations

import itertools
import os
import time
import uuid
from dataclasses import dataclass, field
from typing import Any, Dict, Optional

from .metrics import histogram

__all__ = [
    'DeadlineExceeded',
    'RequestContext',
    'SEGMENTS',
    'new_request_context',
    'record_request_done',
    'record_request_enqueue',
    'record_segment',
]

#: The per-request wall decomposition, in path order: time waiting in the
#: admission queue, host-side concat/pad of the coalesced batch, the
#: device dispatch (transfer + compute + fetch), and slicing each
#: request's rows back out of the shared result.
SEGMENTS = ('queue_wait', 'pad', 'dispatch', 'slice')

_req_seq = itertools.count(1)
#: short per-process prefix so ids from two services on one host never
#: collide (the RunLog may be shared)
_PROC_TAG = uuid.uuid4().hex[:6]


class DeadlineExceeded(RuntimeError):
    """A queued request's deadline passed before its flush dispatched.

    The request was **never** rated: it is failed here instead of being
    dispatched late (a caller that stopped waiting must not burn device
    time), its queue-wait is attributed to the ``queue_wait`` segment,
    and it is never recorded by the traffic capture (it never happened,
    as far as replay is concerned).
    """


@dataclass
class RequestContext:
    """One request's identity and timing as it crosses thread boundaries.

    ``deadline_t`` is an absolute ``time.perf_counter()`` instant (None:
    no deadline); ``segments`` is filled in by the batcher (queue_wait)
    and the service's flush (pad / dispatch / slice) as the request
    moves through the pipeline. ``hop`` counts process boundaries the
    request has crossed (0: minted here; a replica serving a front-end
    request sees 1).
    """

    request_id: str
    kind: str = 'rate'
    enqueue_t: float = field(default_factory=time.perf_counter)
    deadline_t: Optional[float] = None
    #: innermost open span id on the submitting thread (trace linkage)
    parent_span_id: Optional[int] = None
    segments: Dict[str, float] = field(default_factory=dict)
    #: process boundaries crossed so far (to_wire/from_wire increment it)
    hop: int = 0

    def remaining_s(self, now: Optional[float] = None) -> Optional[float]:
        """Seconds until the deadline (negative: expired); None without one."""
        if self.deadline_t is None:
            return None
        return self.deadline_t - (time.perf_counter() if now is None else now)

    def expired(self, now: Optional[float] = None) -> bool:
        """True once the deadline has passed (always False without one)."""
        remaining = self.remaining_s(now)
        return remaining is not None and remaining <= 0.0

    # -- the process hop ---------------------------------------------------

    def to_wire(self) -> Dict[str, Any]:
        """Serialize the identity that must survive a process hop.

        Plain JSON-able headers: the ``request_id`` (preserved
        end-to-end — the stitch key for ``obsctl trace`` across run
        logs), the traffic ``kind``, the hop count, and the deadline as
        *remaining milliseconds at encode time* — absolute
        ``perf_counter`` instants are process-local, so the receiver
        re-anchors what is left of the budget on its own clock (network
        time in flight is deliberately charged to the caller's budget).
        Span ids and segments stay home: they are process-local
        observations, recorded per process and joined by the id.
        """
        headers: Dict[str, Any] = {
            'request_id': self.request_id,
            'kind': self.kind,
            'hop': self.hop,
        }
        remaining = self.remaining_s()
        if remaining is not None:
            headers['deadline_remaining_ms'] = remaining * 1e3
        return headers

    @classmethod
    def from_wire(cls, headers: Dict[str, Any]) -> 'RequestContext':
        """Reconstruct a context shipped by :meth:`to_wire`, one hop on.

        The ``request_id`` is preserved verbatim; ``enqueue_t`` is this
        process's receive instant (its queue-wait segment starts now);
        the deadline re-anchors the shipped remaining budget.
        """
        request_id = headers.get('request_id')
        if not request_id:
            raise ValueError(
                f'wire context carries no request_id: {headers!r}'
            )
        now = time.perf_counter()
        remaining_ms = headers.get('deadline_remaining_ms')
        return cls(
            request_id=str(request_id),
            kind=str(headers.get('kind') or 'rate'),
            enqueue_t=now,
            deadline_t=(
                now + float(remaining_ms) / 1e3
                if remaining_ms is not None
                else None
            ),
            hop=int(headers.get('hop') or 0) + 1,
        )


def new_request_context(
    kind: str = 'rate',
    *,
    deadline_ms: Optional[float] = None,
    parent_span_id: Optional[int] = None,
) -> RequestContext:
    """Mint a fresh :class:`RequestContext` for one service request.

    ``deadline_ms`` is relative to now; the parent span defaults to the
    submitting thread's innermost open span (if any), so the request
    links back into the caller's trace.
    """
    now = time.perf_counter()
    if parent_span_id is None:
        from .trace import current_span

        open_span = current_span()
        parent_span_id = open_span.span_id if open_span is not None else None
    return RequestContext(
        request_id=f'{_PROC_TAG}-{os.getpid():x}-{next(_req_seq):x}',
        kind=kind,
        enqueue_t=now,
        deadline_t=(now + deadline_ms / 1e3) if deadline_ms is not None else None,
        parent_span_id=parent_span_id,
    )


def record_segment(
    segment: str, seconds: float, request_id: Optional[str] = None,
    **labels: str,
) -> None:
    """One sample of the per-request wall decomposition.

    Lands in ``serve/segment_seconds{segment=...}`` with ``request_id``
    attached as the series' exemplar — the operator's jump from "p99 of
    queue_wait spiked" to one concrete request to ``obsctl trace``.
    Lane-scoped callers (the mesh-replicated flush paths) add a
    ``replica=`` label so the decomposition splits per replica;
    single-lane services pass nothing and the series stays unchanged.
    """
    histogram('serve/segment_seconds', unit='s').observe(
        seconds,
        exemplar={'request_id': request_id} if request_id else None,
        segment=segment,
        **labels,
    )


def record_request_enqueue(ctx: RequestContext, queue_depth: int) -> None:
    """Request admitted to the queue: the trace's opening event."""
    from .trace import current_runlog

    log = current_runlog()
    if log is not None:
        fields: Dict[str, Any] = {
            'request_id': ctx.request_id,
            'request_kind': ctx.kind,
            'queue_depth': queue_depth,
            'parent_span_id': ctx.parent_span_id,
            'deadline_in_s': ctx.remaining_s(),
        }
        if ctx.hop:
            fields['hop'] = ctx.hop
        log.event('request_enqueue', **fields)


def record_request_done(
    ctx: RequestContext,
    status: str,
    wall_s: float,
    *,
    bucket: Optional[int] = None,
    coalesced: Optional[int] = None,
    flush_span_id: Optional[int] = None,
    error: Optional[str] = None,
) -> None:
    """Request resolved (``ok`` | ``error`` | ``expired``): closing event.

    Carries the full segment decomposition accumulated on the context,
    plus the flush it rode (bucket size, how many requests coalesced,
    the flush span id) — everything ``obsctl trace`` needs to rebuild
    the path from one line.
    """
    from .recorder import RECORDER
    from .trace import current_runlog

    # 'request_kind', not 'kind': the flight recorder's ring keys every
    # event by its own 'kind' (= event type), which must stay distinct
    # from the request's traffic kind
    fields: Dict[str, Any] = {
        'request_id': ctx.request_id,
        'request_kind': ctx.kind,
        'status': status,
        'wall_s': wall_s,
        'segments': dict(ctx.segments),
    }
    if ctx.hop:
        fields['hop'] = ctx.hop
    if bucket is not None:
        fields['bucket'] = bucket
    if coalesced is not None:
        fields['coalesced'] = coalesced
    if flush_span_id is not None:
        fields['flush_span_id'] = flush_span_id
    if ctx.parent_span_id is not None:
        fields['parent_span_id'] = ctx.parent_span_id
    if error is not None:
        fields['error'] = error
    RECORDER.record('request_done', **fields)
    log = current_runlog()
    if log is not None:
        log.event('request_done', **fields)
