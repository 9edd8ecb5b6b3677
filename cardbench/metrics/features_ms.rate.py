"""features_ms.rate (ms, program span): host time per traced call inside the
program's ``vaep/pad`` and ``vaep/features`` spans: the bucket pad and the
feature rows' dispatch (cardbench.stages)."""

from cardbench.stages import features_ms as read  # noqa: F401
