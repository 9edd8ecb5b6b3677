"""head_idle_ms.rate (ms, program span): time per traced call in which the card
was idle while the host was inside ``vaep/head`` or ``vaep/formula``
(cardbench.stages)."""

from cardbench.stages import head_idle_ms as read  # noqa: F401
