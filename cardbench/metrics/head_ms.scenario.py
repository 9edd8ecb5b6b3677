"""head_ms.scenario (ms, program span): host time per traced call inside the
program's ``vaep/head`` and ``vaep/formula`` spans: the hidden chains'
and the formula's dispatch (cardbench.stages)."""

from cardbench.stages import head_ms as read  # noqa: F401
