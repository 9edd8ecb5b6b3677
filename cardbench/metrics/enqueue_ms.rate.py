"""enqueue_ms.rate (ms, host clock): mean host time from entry into the cell's
entry point (``rate_batch``) to its return, before the values' copy: the
host's dispatch. Taken over the calls after the profiler stopped (all calls
if none were)."""

from cardbench.readers import mean_ms


def read(run):
    calls = run.untraced or run.calls
    return mean_ms(c.t_return - c.t_entry for c in calls if c.ok)
