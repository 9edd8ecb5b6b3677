"""features_idle_ms.scenario (ms, program span): time per traced call in which the
card was idle while the host was inside ``vaep/pad`` or ``vaep/features``
(cardbench.stages)."""

from cardbench.stages import features_idle_ms as read  # noqa: F401
