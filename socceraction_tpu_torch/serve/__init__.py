"""Online serving: micro-batched, shape-bucketed live rating.

Ports of the JAX package's ``socceraction_tpu/serve`` modules:

- :mod:`.batcher` — the thread-safe micro-batching queue
  (:class:`MicroBatcher`): deadline-bounded coalescing, power-of-two
  shape buckets, bounded-queue admission control (:class:`Overloaded`).
- :mod:`.session` — :class:`MatchSession`, live per-match streaming:
  O(new actions) incremental rating with the whole-match ``goalscore``
  carry injected as a dense override.
- :mod:`.service` — :class:`RatingService`, the in-process front end
  (``rate() -> Future``, ``rate_scenarios``, ``open_session``,
  ``swap_model``, ``rollback_model``, ``health``, ``telemetry``,
  ``warmup``) over kernel B1, with SLO admission (:class:`SLOShed`), a
  traffic capture hook, a sampled parity probe and a circuit breaker that
  degrades failing flushes but never a kernel that cannot run.
- :mod:`.registry` — :class:`ModelRegistry`: versioned checkpoints, warm
  device residency, atomic activation and rollback, the candidate
  lifecycle.
- :mod:`.capture` — :class:`TrafficCapture`, the ring of served traffic.

The warm tier and the frontend (ROADMAP A5) and the replica lanes (A6)
come later. Importing this package needs neither
pandas nor msgpack.
"""

from ..obs.context import DeadlineExceeded
from .batcher import MicroBatcher, Overloaded
from .capture import TrafficCapture
from .registry import ModelRegistry
from .service import RatingService, SLOShed
from .session import MatchSession

__all__ = [
    'DeadlineExceeded',
    'MatchSession',
    'MicroBatcher',
    'ModelRegistry',
    'Overloaded',
    'RatingService',
    'SLOShed',
    'TrafficCapture',
]
