"""dispatch_idle_ms.rate (ms, program span): time per traced call in which the
card was idle while the host was inside ``vaep/rate_batch``: the dispatch's
share of the idle, against the caller's copy and wait (cardbench.stages)."""

from cardbench.stages import dispatch_idle_ms as read  # noqa: F401
