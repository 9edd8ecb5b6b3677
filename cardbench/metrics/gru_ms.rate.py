"""gru_ms.rate (ms, program span): host time per traced call inside the
program's ``seq/gru`` spans: both seq heads' recurrences (cardbench.stages)."""

from cardbench.stages import host_ms


def read(run):
    return host_ms(run, ('seq/gru',))
