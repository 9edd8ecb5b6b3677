"""expand_ms.scenario (ms, program span): mean host time from a request's entry
to the start of the program's ``scenario/dispatch`` span, in the trace: the
fold of the grid into the game axis before the one ``rate_batch``."""

import bisect

from cardbench.readers import mean_ms


def read(run):
    if run.trace is None:
        return None
    starts = [a for a, _ in run.trace.ranges('scenario/dispatch')]
    gaps = []
    for lo, hi in run.trace.calls:
        i = bisect.bisect_left(starts, lo)
        if i < len(starts) and starts[i] < hi:
            gaps.append(starts[i] - lo)
    return mean_ms(gaps)
