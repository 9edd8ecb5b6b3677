"""expand_idle_ms.scenario (ms, program span): time per traced request in which
the card was idle while the host was inside ``scenario/expand``, the grid's
fold into the game axis (cardbench.stages)."""

from cardbench.stages import expand_idle_ms as read  # noqa: F401
