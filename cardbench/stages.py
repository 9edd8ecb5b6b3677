"""The program's stage spans in a traced run: each stage's host time, and the
card's idle time under it.

The port opens a span around each stage of its rating dispatch
(``vaep/pad``, ``vaep/features``, ``vaep/head``, ``vaep/formula`` inside
``vaep/rate_batch``) and around the scenario fold's expansion
(``scenario/expand``). A span runs under
``torch.profiler.record_function``, so it is a host range in the trace
(:mod:`cardbench.trace`), on the same clock as the card's work. A stage is
a set of span names; from the ranges of its names:

- only the calling thread's count: the threads of the harness's call
  ranges, as :func:`cardbench.trace.host_during_gaps` takes them;
- a range's time includes the operators and runtime calls nested under
  it, and nested or overlapping ranges count once (their union, clipped
  to the traced window);
- :func:`host_ms`: the union's length; :func:`idle_ms`: its overlap with
  the window's idle gaps (:func:`cardbench.trace.gaps`); each in ms per
  traced call.

A reader returns ``None`` where the trace holds none of the stage's spans
(a program without them) or no device work: without a card the host
computes inside the spans, so their time is the work itself and not its
dispatch, and there is no idle to read.
"""

from __future__ import annotations

from typing import Any, List, Optional, Sequence, Tuple

from . import trace as tracemod

#: The span names of each stage.
FEATURES = ('vaep/pad', 'vaep/features')
HEAD = ('vaep/head', 'vaep/formula')
DISPATCH = ('vaep/rate_batch',)
EXPAND = ('scenario/expand',)

Span = Tuple[float, float]


def cover(trace: tracemod.Trace, names: Sequence[str]) -> List[Span]:
    """Sorted disjoint cover of the calling thread's ranges named in
    ``names``, clipped to the traced window."""
    threads = {tid for _, _, n, tid in trace.host if n == tracemod.CALL_RANGE}
    ranges = [(a, b, n) for a, b, n, tid in trace.host if n in names and tid in threads]
    return tracemod.union(ranges, *trace.window)


def overlap(xs: List[Span], ys: List[Span]) -> float:
    """Seconds in both of two sorted disjoint interval lists."""
    total, i, j = 0.0, 0, 0
    while i < len(xs) and j < len(ys):
        lo, hi = max(xs[i][0], ys[j][0]), min(xs[i][1], ys[j][1])
        if hi > lo:
            total += hi - lo
        if xs[i][1] < ys[j][1]:
            i += 1
        else:
            j += 1
    return total


def _spans(run: Any, names: Sequence[str]) -> Optional[List[Span]]:
    trace = run.trace
    if trace is None or not trace.calls or not trace.device:
        return None
    return cover(trace, names) or None


def host_ms(run: Any, names: Sequence[str]) -> Optional[float]:
    """Host ms per traced call inside the stage's spans."""
    spans = _spans(run, names)
    if spans is None:
        return None
    return 1e3 * sum(b - a for a, b in spans) / len(run.trace.calls)


def idle_ms(run: Any, names: Sequence[str]) -> Optional[float]:
    """ms per traced call in which the card was idle while the host was
    inside the stage's spans."""
    spans = _spans(run, names)
    if spans is None:
        return None
    return 1e3 * overlap(spans, tracemod.gaps(run.trace)) / len(run.trace.calls)


def features_ms(run: Any) -> Optional[float]:
    return host_ms(run, FEATURES)


def features_idle_ms(run: Any) -> Optional[float]:
    return idle_ms(run, FEATURES)


def head_ms(run: Any) -> Optional[float]:
    return host_ms(run, HEAD)


def head_idle_ms(run: Any) -> Optional[float]:
    return idle_ms(run, HEAD)


def dispatch_idle_ms(run: Any) -> Optional[float]:
    return idle_ms(run, DISPATCH)


def expand_idle_ms(run: Any) -> Optional[float]:
    return idle_ms(run, EXPAND)
