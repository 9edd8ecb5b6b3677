"""Reading a ``torch.profiler`` trace of part of the window.

The traced run keeps the profiler (host and device activity) on over the
first ``trace_seconds`` of its window, wraps each call in a
``cardbench/call`` range, exports the chrome trace to a temporary file,
reads it back here and deletes it. From it come:

- the traced window: the first call's start to the last call's end;
- the device's busy time: the union of every kernel, copy and memset
  interval inside the window (ranges that spans mark on the device's
  timeline are not work);
- the idle gaps (the window less the busy union), each split over what the
  host's calling thread was doing meanwhile: the innermost host event
  (operator, range or runtime call) open at that time;
- the device operations that took most time.
"""

from __future__ import annotations

import bisect
import json
import os
import tempfile
from collections import defaultdict
from typing import Any, Dict, Iterable, List, NamedTuple, Optional, Tuple

#: The range the harness opens around each call.
CALL_RANGE = 'cardbench/call'
DEVICE_CATS = {'kernel', 'gpu_memcpy', 'gpu_memset'}
HOST_CATS = {'cpu_op', 'user_annotation', 'cuda_runtime', 'cuda_driver'}

Interval = Tuple[float, float, str]


class Trace(NamedTuple):
    """Intervals in seconds on the trace's clock: the device's work, the
    host's events (with their thread), and the harness's call ranges."""

    device: List[Interval]
    host: List[Tuple[float, float, str, Any]]
    calls: List[Tuple[float, float]]

    @property
    def window(self) -> Tuple[float, float]:
        return self.calls[0][0], self.calls[-1][1]

    @property
    def window_s(self) -> float:
        lo, hi = self.window
        return hi - lo

    def ranges(self, name: str) -> List[Tuple[float, float]]:
        """Host ranges named ``name`` (a span's or an operator's)."""
        return sorted((a, b) for a, b, n, _ in self.host if n == name)


def parse(events: Iterable[Dict[str, Any]]) -> Trace:
    """A :class:`Trace` of chrome-trace events (``ts``, ``dur`` in µs)."""
    device, host, calls = [], [], []
    for e in events:
        if e.get('ph') != 'X':
            continue
        cat = str(e.get('cat', '')).lower()
        lo = float(e['ts']) * 1e-6
        hi = lo + float(e.get('dur', 0.0)) * 1e-6
        name = str(e.get('name', ''))
        if cat in DEVICE_CATS:
            device.append((lo, hi, name))
        elif cat in HOST_CATS:
            host.append((lo, hi, name, e.get('tid')))
            if name == CALL_RANGE:
                calls.append((lo, hi))
    device.sort()
    calls.sort()
    return Trace(device, host, calls)


def record(prof: Any) -> Trace:
    """Export a finished profile to a temporary file, read it, delete it."""
    fd, path = tempfile.mkstemp(suffix='.json')
    os.close(fd)
    try:
        prof.export_chrome_trace(path)
        with open(path) as f:
            events = json.load(f)
    finally:
        os.unlink(path)
    return parse(events['traceEvents'] if isinstance(events, dict) else events)


def union(intervals: Iterable[Interval], lo: float, hi: float) -> List[Tuple[float, float]]:
    """Sorted disjoint cover of ``intervals`` clipped to ``[lo, hi]``."""
    out: List[List[float]] = []
    for a, b, _ in sorted(intervals):
        a, b = max(a, lo), min(b, hi)
        if b <= a:
            continue
        if out and a <= out[-1][1]:
            out[-1][1] = max(out[-1][1], b)
        else:
            out.append([a, b])
    return [(a, b) for a, b in out]


def busy_s(trace: Trace) -> float:
    """Seconds of the traced window in which the device did work."""
    return sum(b - a for a, b in union(trace.device, *trace.window))


def gaps(trace: Trace) -> List[Tuple[float, float]]:
    """The traced window less the device's busy time."""
    lo, hi = trace.window
    out, t = [], lo
    for a, b in union(trace.device, lo, hi):
        if a > t:
            out.append((t, a))
        t = max(t, b)
    if hi > t:
        out.append((t, hi))
    return out


def innermost(events: List[Tuple[float, float, str]]) -> List[Interval]:
    """Disjoint segments, each named by the innermost of the (nested) host
    events open over it; time under no event is left out."""
    out: List[Interval] = []
    stack: List[Tuple[float, str]] = []
    t = None
    for a, b, name in sorted(events, key=lambda e: (e[0], -e[1])):
        while stack and stack[-1][0] <= a:
            end, top = stack.pop()
            out.append((t, end, top))
            t = end
        if stack:
            b = min(b, stack[-1][0])
            out.append((t, a, stack[-1][1]))
        stack.append((b, name))
        t = a
    while stack:
        end, top = stack.pop()
        out.append((t, end, top))
        t = end
    return [s for s in out if s[1] > s[0]]


def host_during_gaps(trace: Trace) -> Dict[str, float]:
    """Seconds of idle gap by the innermost host event of the calling
    thread open meanwhile (``(no host event)`` where none is)."""
    threads = {tid for a, b, n, tid in trace.host if n == CALL_RANGE}
    segments = innermost([(a, b, n) for a, b, n, tid in trace.host if tid in threads])
    starts = [s[0] for s in segments]
    out: Dict[str, float] = defaultdict(float)
    for lo, hi in gaps(trace):
        covered = 0.0
        i = max(bisect.bisect_right(starts, lo) - 1, 0)
        while i < len(segments) and segments[i][0] < hi:
            a, b = max(segments[i][0], lo), min(segments[i][1], hi)
            if b > a:
                out[segments[i][2]] += b - a
                covered += b - a
            i += 1
        if hi - lo > covered:
            out['(no host event)'] += hi - lo - covered
    return dict(out)


def top(totals: Dict[str, float], n: int = 10) -> List[List[Any]]:
    return [[name[:200], s] for name, s in sorted(totals.items(), key=lambda kv: -kv[1])[:n]]


def breakdown(trace: Trace) -> Dict[str, List[List[Any]]]:
    """The device operations that took most time in the traced window, and
    the idle time by what the host was doing; ten of each."""
    lo, hi = trace.window
    ops: Dict[str, float] = defaultdict(float)
    for a, b, name in trace.device:
        if lo <= a < hi:
            ops[name] += b - a
    return {'device_ops': top(ops), 'idle_gaps': top(host_during_gaps(trace))}


def device_seconds(trace: Trace, name_part: str) -> Optional[float]:
    """Total seconds of the device operations in the window whose name
    contains ``name_part``; ``None`` when there is none."""
    lo, hi = trace.window
    hits = [b - a for a, b, name in trace.device if name_part in name and lo <= a < hi]
    return sum(hits) if hits else None
