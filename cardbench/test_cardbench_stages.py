"""CPU tests of the stage readers (``cardbench/stages.py``): each stage's host
time and the card's idle time under it, on a hand-built trace, and the
program's stage spans found in a real traced window.

    python -m pytest cardbench/test_cardbench_stages.py -q
"""

from __future__ import annotations

from types import SimpleNamespace

import pytest
import torch

from cardbench import run, spec as specmod, stages, testing, trace

SEED = 2**31 + 29
S = 1e6  # chrome-trace microseconds a second


def x(cat, name, lo, hi, tid=None):
    return {'ph': 'X', 'cat': cat, 'name': name, 'ts': lo * S, 'dur': (hi - lo) * S, 'tid': tid}


def hand_trace(device=True, leave_out=()):
    """Two calls of the calling thread (tid 1) on [0, 10] and [10, 20] s.

    Device work [1, 3], [6, 8], [12, 15], so the idle gaps are [0, 1],
    [3, 6], [8, 12] and [15, 20]. The dispatch ``vaep/rate_batch`` on
    [0.5, 9] and [10.5, 19] holds the pad [0.5, 1.5], the features [1.5, 5]
    (an operator nested in them) and [10.5, 13] (a second ``vaep/features``
    range nested in it), the head [5.5, 7] and [13, 16] and the formula
    [7, 8.5] and [16, 18]. Another thread (tid 2) holds ``vaep/features``
    and ``scenario/expand`` ranges over the whole window. Ranges named in
    ``leave_out`` are left out."""
    ann = 'user_annotation'
    events = [
        x(ann, trace.CALL_RANGE, 0, 10, 1), x(ann, trace.CALL_RANGE, 10, 20, 1),
        x(ann, 'vaep/rate_batch', 0.5, 9, 1), x(ann, 'vaep/rate_batch', 10.5, 19, 1),
        x(ann, 'vaep/pad', 0.5, 1.5, 1), x(ann, 'vaep/features', 1.5, 5, 1),
        x('cpu_op', 'aten::cat', 2, 4, 1),
        x(ann, 'vaep/features', 10.5, 13, 1), x(ann, 'vaep/features', 11, 12, 1),
        x(ann, 'vaep/head', 5.5, 7, 1), x(ann, 'vaep/head', 13, 16, 1),
        x(ann, 'vaep/formula', 7, 8.5, 1), x(ann, 'vaep/formula', 16, 18, 1),
        x(ann, 'vaep/features', 15, 20, 2), x(ann, 'scenario/expand', 0, 20, 2),
        x('gpu_user_annotation', 'vaep/features', 0, 20),
    ]
    if device:
        events += [x('kernel', 'k', 1, 3), x('kernel', 'k', 6, 8), x('gpu_memcpy', 'copy', 12, 15)]
    return trace.parse([e for e in events if e['name'] not in leave_out])


def test_stage_times_by_hand():
    r = SimpleNamespace(trace=hand_trace())
    assert trace.gaps(r.trace) == [(0.0, 1.0), (3.0, 6.0), (8.0, 12.0), (15.0, 20.0)]
    # features: [0.5, 5] and [10.5, 13], 7 s over 2 calls; the nested range
    # [11, 12] and the other thread's [15, 20] add nothing
    assert stages.features_ms(r) == pytest.approx(3500.0)
    # idle under them: [0.5, 1], [3, 5], [10.5, 12]
    assert stages.features_idle_ms(r) == pytest.approx(2000.0)
    # head and formula: [5.5, 8.5] and [13, 18], 8 s; idle [5.5, 6], [8, 8.5], [15, 18]
    assert stages.head_ms(r) == pytest.approx(4000.0)
    assert stages.head_idle_ms(r) == pytest.approx(2000.0)
    # the dispatch: [0.5, 1], [3, 6], [8, 9], [10.5, 12], [15, 19]
    assert stages.dispatch_idle_ms(r) == pytest.approx(5000.0)


def test_a_gap_outside_every_span_counts_in_none():
    """13 s of the window are idle; [0, 0.5], [9, 10] and [19, 20] lie in no
    span, so the dispatch's 10 s are the rest, and its stages fit in it."""
    r = SimpleNamespace(trace=hand_trace())
    idle = sum(b - a for a, b in trace.gaps(r.trace))
    assert idle == pytest.approx(13.0)
    assert stages.dispatch_idle_ms(r) * 2 / 1e3 == pytest.approx(idle - 3.0)
    assert stages.features_idle_ms(r) + stages.head_idle_ms(r) <= stages.dispatch_idle_ms(r)


def test_another_threads_span_counts_in_none():
    """``scenario/expand`` is only on tid 2: nothing to read."""
    r = SimpleNamespace(trace=hand_trace())
    assert stages.cover(r.trace, stages.EXPAND) == []
    assert stages.expand_idle_ms(r) is None


def test_nested_ranges_count_once():
    t = hand_trace()
    assert stages.cover(t, ('vaep/features',)) == [(1.5, 5.0), (10.5, 13.0)]
    assert stages.cover(t, ('vaep/rate_batch',) + stages.FEATURES) == [(0.5, 9.0), (10.5, 19.0)]
    assert stages.overlap([(0.0, 2.0), (3.0, 5.0)], [(1.0, 4.0), (4.5, 9.0)]) == pytest.approx(2.5)


def test_nothing_to_read_without_the_spans_or_the_card():
    """A port without the stage spans (one older than these readers)
    leaves the stage metrics out; a trace with no device work leaves out
    all."""
    r = SimpleNamespace(trace=hand_trace(leave_out=stages.FEATURES + stages.HEAD))
    assert stages.features_ms(r) is None and stages.head_idle_ms(r) is None
    assert stages.dispatch_idle_ms(r) == pytest.approx(5000.0)
    r = SimpleNamespace(trace=hand_trace(device=False))
    assert all(f(r) is None for f in (stages.features_ms, stages.head_ms, stages.dispatch_idle_ms))
    assert stages.features_ms(SimpleNamespace(trace=None)) is None


def test_metric_files_read_the_stages():
    s = specmod.Spec()
    r = SimpleNamespace(trace=hand_trace())
    e2e = {m['name']: m for m in s.bench['end_to_end']}
    for kind, cells in (('rate', ['vaep-season-rate', 'atomic-season-rate']),
                        ('scenario', ['vaep-scenario-grid'])):
        for name in ('features_ms', 'features_idle_ms', 'head_ms', 'head_idle_ms', 'dispatch_idle_ms'):
            assert s.reader(f'{name}.{kind}')(r) == getattr(stages, name)(r)
            (entry,) = [m for m in s.bench['per_layer'] if m['name'] == f'{name}.{kind}']
            # the accepted cells first; a cell added later reports the metric it moves
            assert entry['workloads'][:len(cells)] == cells and entry['source'] == 'program_span'
            assert set(entry['workloads']) <= set(e2e[entry['moves']]['workloads'])
    assert s.reader('expand_idle_ms.scenario')(r) is None


def test_the_programs_stage_spans_are_on_the_calling_thread(tmp_path):
    """A traced window of the tiny scenario cell on the CPU: every traced
    request holds one ``scenario/expand`` and, in its one ``rate_batch``,
    the pad, the features, the head and the formula."""
    tiny = specmod.Spec(testing.tiny_root(tmp_path))
    torch.set_num_threads(2)
    load = run.prepare(tiny, 'vaep-scenario-grid', SEED, torch.device('cpu')).load
    ran = load.window(0.4, torch.device('cpu'), 0.2)
    t = trace.record(ran['prof'])
    assert t.calls
    for name in ('scenario/expand', 'vaep/pad', 'vaep/features', 'vaep/head', 'vaep/formula'):
        starts = [a for a, _ in stages.cover(t, (name,))]
        assert [sum(lo <= a < hi for a in starts) for lo, hi in t.calls] == [1] * len(t.calls), name
