"""What the metric files under ``cardbench/metrics/`` read from a run.

A reader takes the finished :class:`~cardbench.run.Run` and returns a
number, or ``None`` where the run holds nothing to read (then the harness
leaves the metric out of the line). Rates and tails are taken over all the
window's calls; trace readers over the traced part of the window.
"""

from __future__ import annotations

from typing import Any, Optional

import numpy as np

from . import trace as tracemod
from . import yardstick


def throughput(run: Any, unit: str) -> Optional[float]:
    """Work of every call whose values reached the host, over the window's
    wall time, where the traffic's driver counts its work in ``unit``
    (``actions`` or ``values``)."""
    if run.work_unit != unit:
        return None
    return sum(c.work for c in run.calls if c.ok) / run.wall_s


def idle_share(run: Any) -> Optional[float]:
    """% of the traced window in which the device did no work."""
    if run.trace is None or not run.trace.device:
        return None
    return 100.0 * (1.0 - tracemod.busy_s(run.trace) / run.trace.window_s)


def b1_roofline(run: Any) -> Optional[float]:
    """% of B1's least time (:func:`yardstick.b1_least_seconds`, summed over
    the traced calls) in B1's device time in the trace."""
    peak = yardstick.peaks(run.device_name)
    if run.trace is None or peak is None:
        return None
    measured = tracemod.device_seconds(run.trace, yardstick.B1_KERNEL)
    if measured is None:
        return None
    least = sum(yardstick.b1_least_seconds(run.config, c.work, peak) for c in run.traced if c.ok)
    return 100.0 * least / measured


def mfu(run: Any) -> Optional[float]:
    """% of the card's dense TF32 peak that the model's FLOPs
    (:func:`yardstick.flops_per_action`, the head kind's count, per valid
    action rated) make over the calls after the profiler stopped, from the
    first one's entry to the last one's end: the step's share of the peak
    at full speed, which the profiler's own cost on the host would lower."""
    peak = yardstick.peaks(run.device_name)
    calls = [c for c in run.untraced if c.ok]
    if peak is None or not calls or run.trace is None:
        return None
    flops = yardstick.flops_per_action(run.config, run.head) * sum(c.work for c in calls)
    wall = run.untraced[-1].t_end - run.untraced[0].t_entry
    return 100.0 * flops / wall / peak['flops_tf32']


def mean_ms(values: Any) -> Optional[float]:
    values = list(values)
    return 1e3 * float(np.mean(values)) if values else None
