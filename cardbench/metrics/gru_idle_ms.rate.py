"""gru_idle_ms.rate (ms, program span): time per traced call in which the card
was idle while the host was inside ``seq/gru``: the recurrence's dispatch
that the card waits on (cardbench.stages)."""

from cardbench.stages import idle_ms


def read(run):
    return idle_ms(run, ('seq/gru',))
