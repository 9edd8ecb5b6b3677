"""call_p95_ms (ms, host_clock): the 95th percentile over all the window's
calls of one call's time from entry until its values are on the host. The
harness takes it itself, with no trace: from CUDA events it records at entry
and after the values' copy, which ends in a wait for the device, so it is the
call's wall time read on the device's clock (microseconds, where the host's
clock is off by about half a millisecond)."""

import numpy as np


def read(run):
    ms = [c.device_ms for c in run.calls if c.ok]
    return float(np.percentile(ms, 95)) if ms else None
