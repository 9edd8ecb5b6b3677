"""The stage spans inside the port's rating dispatch and scenario fold.

``VAEP.rate_batch`` opens ``vaep/rate_batch`` and, inside it, one span a
stage: ``vaep/pad`` (the bucket pad, only when the game count is not a
power of two), ``vaep/features`` and ``vaep/head`` (the fused paths'
feature rows and hidden chain, or the seq path's feature rows and two GRU
heads) and ``vaep/formula``. On the seq path each head opens
``seq/embed``, ``seq/gru`` and ``seq/readout`` inside ``vaep/head``, and
the counter ``seq/gru_rows`` adds the rows that enter the recurrence.
``rate_scenarios_batch`` opens ``scenario/expand`` before
``scenario/dispatch``. A span runs under
``torch.profiler.record_function``, so the benchmark reads these ranges
from the profiler's trace (``cardbench/stages.py``); on the CPU, under the
profiler's CPU activity, these tests check:

- the ranges, their nesting and their order, on both families and the
  seq path;
- the ``seq/gru_rows`` counter;
- the values, bitwise equal with the profiler on and off;
- a run log's ``span_open`` events, each within 1 ms of its range's start
  in the profiler's trace (chrome-trace ``ts`` plus
  ``baseTimeNanoseconds``, epoch microseconds), with the span open around
  it as its parent, so an operator's run log joins a trace of the same
  run.
"""

import json

import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from socceraction_tpu_torch.atomic.vaep.base import AtomicVAEP
from socceraction_tpu_torch.core import batch as tbatch
from socceraction_tpu_torch.core.synthetic import synthetic_batch
from socceraction_tpu_torch.obs import REGISTRY
from socceraction_tpu_torch.obs import trace as ttrace
from socceraction_tpu_torch.ops import fused as tfused
from socceraction_tpu_torch.scenario.engine import rate_scenarios_batch
from socceraction_tpu_torch.scenario.grid import end_location_grid
from socceraction_tpu_torch.seq.classifier import SeqClassifier
from socceraction_tpu_torch.vaep.base import VAEP
from tests.test_torch_atomic import draw_atomic_columns

ENV = 'SOCCERACTION_TPU_RATING_PATH'
STAGES = ('vaep/features', 'vaep/head', 'vaep/formula')
NEW_SPANS = ('vaep/pad',) + STAGES + ('scenario/expand',)
SEQ_STAGES = ('seq/embed', 'seq/gru', 'seq/readout')
TREE = dict(hidden=(8,), batch_size=256, max_epochs=1)
SEQ = dict(embed_dim=8, hidden=16, readout=8)
ACTIONS = 128


def _standard_batch(n_games, seed):
    return synthetic_batch(n_games, ACTIONS, fill=0.8, seed=seed, device='cpu')


def _atomic_batch(n_games, seed):
    cols = draw_atomic_columns([100 + 7 * g for g in range(n_games)], ACTIONS, seed)
    return tbatch.AtomicActionBatch(**{n: torch.from_numpy(a) for n, a in cols.items()})


FAMILIES = {'standard': (VAEP, _standard_batch), 'atomic': (AtomicVAEP, _atomic_batch)}
#: The batch each model rates: both families' MLP pairs, and ``'seq'``,
#: the standard family's pair of GRU heads.
BATCHES = {**{family: make for family, (_, make) in FAMILIES.items()}, 'seq': _standard_batch}


def _seq_model():
    """A VAEP of two seq heads with seeded initial weights and the
    statistics of 4 seeded games."""
    states, layout = tfused.build_train_states(
        _standard_batch(4, seed=5), names=VAEP._default_xfns, k=3)
    mean, std = tfused.packed_feature_stats(states, layout)
    heads = {}
    for seed, col in enumerate(('scores', 'concedes')):
        clf = SeqClassifier(**SEQ, seed=seed, device='cpu')
        clf.module = clf.init_params(layout)
        clf.mean_, clf.std_ = mean, torch.where(std > 0, std, 1.0)
        heads[col] = clf
    model = VAEP(models=heads, device='cpu')
    assert model._rating_path() == 'seq'
    return model


@pytest.fixture(scope='module')
def models():
    """Each family's model, its MLP heads fitted on 4 seeded games, and the
    seq model."""
    fitted = {
        family: cls(device='cpu').fit_packed(make(4, seed=5), tree_params=TREE, random_state=0)
        for family, (cls, make) in FAMILIES.items()
    }
    return {**fitted, 'seq': _seq_model()}


@pytest.fixture(autouse=True)
def _fused(monkeypatch):
    monkeypatch.setenv(ENV, 'fused')


def _traced(tmp_path, fn):
    """``fn()`` under the profiler's CPU activity -> (its value, the
    trace's ``user_annotation`` ranges as ``(start_us, end_us, name)`` in
    epoch microseconds, sorted by start)."""
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        out = fn()
    path = tmp_path / 'trace.json'
    prof.export_chrome_trace(str(path))
    doc = json.loads(path.read_text())
    base_us = doc.get('baseTimeNanoseconds', 0) / 1e3
    ranges = sorted(
        (float(e['ts']) + base_us, float(e['ts']) + base_us + float(e.get('dur', 0.0)), e['name'])
        for e in doc['traceEvents']
        if e.get('ph') == 'X' and e.get('cat') == 'user_annotation'
    )
    return out, ranges


def _named(ranges, *names):
    return [r for r in ranges if r[2] in names]


def _inside(inner, outer):
    return outer[0] <= inner[0] and inner[1] <= outer[1]


def _siblings(ranges):
    """Each range closes before the next opens."""
    return all(a[1] <= b[0] for a, b in zip(ranges, ranges[1:]))


@pytest.mark.parametrize('n_games', [3, 4])
@pytest.mark.parametrize('family', BATCHES)
def test_rate_batch_opens_each_stage_inside_its_span(tmp_path, models, family, n_games):
    """Features, head and formula in that order inside ``vaep/rate_batch``;
    the pad first, and only where the game count is not a power of two.
    Inside ``vaep/head``, the seq path's embedding, recurrence and readout
    of each head in turn, and none of them on the MLP paths."""
    batch = BATCHES[family](n_games, seed=11)
    _, ranges = _traced(tmp_path, lambda: models[family].rate_batch(batch))
    (outer,) = _named(ranges, 'vaep/rate_batch')
    stages = _named(ranges, *NEW_SPANS)
    want = (('vaep/pad',) if n_games & (n_games - 1) else ()) + STAGES
    assert tuple(r[2] for r in stages) == want
    assert all(_inside(r, outer) for r in stages) and _siblings(stages)
    (head,) = _named(ranges, 'vaep/head')
    inner = _named(ranges, *SEQ_STAGES)
    assert tuple(r[2] for r in inner) == (SEQ_STAGES * 2 if family == 'seq' else ())
    assert all(_inside(r, head) for r in inner) and _siblings(inner)


def test_gru_rows_count_the_padded_rows_of_a_call(models):
    """3 games are padded to their bucket of 4: 4 x 128 rows enter the
    recurrence, against the valid actions that ``seq/rated_actions`` adds."""
    batch = _standard_batch(3, seed=13)

    def counts():
        snap = REGISTRY.snapshot()
        return (snap.value('seq/gru_rows', platform='cpu'),
                snap.value('seq/rated_actions', platform='cpu'))

    before = counts()
    models['seq'].rate_batch(batch)
    rows, rated = (a - b for a, b in zip(counts(), before))
    assert rows == 4 * ACTIONS
    assert rated == batch.total_actions < rows


def test_materialized_path_opens_pad_and_formula_only(tmp_path, models, monkeypatch):
    """Off the fused paths there are no feature rows or hidden chain to
    mark; the pad and the formula are still stages of their own."""
    monkeypatch.setenv(ENV, 'materialized')
    batch = _standard_batch(3, seed=11)
    _, ranges = _traced(tmp_path, lambda: models['standard'].rate_batch(batch))
    (outer,) = _named(ranges, 'vaep/rate_batch')
    stages = _named(ranges, *NEW_SPANS)
    assert [r[2] for r in stages] == ['vaep/pad', 'vaep/formula']
    assert all(_inside(r, outer) for r in stages)


def test_scenario_fold_expands_before_its_dispatch(tmp_path, models):
    """``scenario/expand`` closes before ``scenario/dispatch`` opens; the
    folded games' rating, pad included, nests in the dispatch."""
    batch = _standard_batch(3, seed=11)
    grid = end_location_grid(nx=3, ny=2)  # 6 x 3 = 18 folded games, padded to 32
    _, ranges = _traced(tmp_path, lambda: rate_scenarios_batch(models['standard'], batch, grid))
    (expand,) = _named(ranges, 'scenario/expand')
    (dispatch,) = _named(ranges, 'scenario/dispatch')
    (rate,) = _named(ranges, 'vaep/rate_batch')
    assert expand[1] <= dispatch[0]
    assert _inside(rate, dispatch) and not _inside(rate, expand)
    assert [r[2] for r in _named(ranges, *NEW_SPANS) if _inside(r, rate)] == ['vaep/pad', *STAGES]


@pytest.mark.parametrize('family', BATCHES)
def test_values_are_bitwise_equal_with_the_profiler_on_and_off(tmp_path, models, family):
    model, batch = models[family], BATCHES[family](3, seed=13)
    grid = end_location_grid(nx=2, ny=2)
    plain = model.rate_batch(batch), rate_scenarios_batch(model, batch, grid)
    traced, _ = _traced(tmp_path, lambda: (model.rate_batch(batch),
                                           rate_scenarios_batch(model, batch, grid)))
    assert torch.equal(plain[0], traced[0]) and torch.equal(plain[1], traced[1])


def _joins_the_profilers_trace(tmp_path, models, family):
    """Each new span's ``span_open`` (``time.time()``) lies within 1 ms of
    its range's start on the profiler's clock, and names the span open
    around it as its parent: the seq heads' stages ``vaep/head``."""
    model, batch = models[family], _standard_batch(3, seed=17)
    grid = end_location_grid(nx=2, ny=2)
    rate_scenarios_batch(model, batch, grid)  # first calls' costs outside the measure
    log_path = tmp_path / 'obs.jsonl'
    with ttrace.RunLog(str(log_path)):
        _, ranges = _traced(tmp_path, lambda: rate_scenarios_batch(model, batch, grid))
    events = [json.loads(line) for line in log_path.read_text().splitlines()]
    opens = [e for e in events if e['event'] == 'span_open']
    by_id = {e['span_id']: e for e in opens}
    parents = {
        'scenario/expand': None, 'vaep/pad': 'vaep/rate_batch', 'vaep/features': 'vaep/rate_batch',
        'vaep/head': 'vaep/rate_batch', 'vaep/formula': 'vaep/rate_batch',
        **{stage: 'vaep/head' for stage in SEQ_STAGES},
    }
    new = [e for e in opens if e['name'] in NEW_SPANS + SEQ_STAGES]
    heads = SEQ_STAGES * 2 if family == 'seq' else ()
    assert [e['name'] for e in new] == [
        'scenario/expand', 'vaep/pad', 'vaep/features', 'vaep/head', *heads, 'vaep/formula']
    seen = {}
    for e in new:
        parent = by_id.get(e['parent_id'])
        assert (parent and parent['name']) == parents[e['name']], e
        assert e['attrs'] == {}
        nth = seen[e['name']] = seen.get(e['name'], -1) + 1
        r = _named(ranges, e['name'])[nth]
        assert abs(r[0] - 1e6 * e['ts']) < 1e3, (e['name'], r[0] - 1e6 * e['ts'])


def test_run_log_joins_the_profilers_trace(tmp_path, models):
    _joins_the_profilers_trace(tmp_path, models, 'standard')


def test_run_log_joins_the_profilers_trace_on_the_seq_path(tmp_path, models):
    _joins_the_profilers_trace(tmp_path, models, 'seq')


def test_a_span_enters_no_profiler_range_with_no_profiler_on(models, monkeypatch):
    """With no profiler on, a range records nothing: the spans skip
    ``record_function`` (two dispatcher calls a span) on the hot path."""
    entered = []
    real = torch.profiler.record_function

    def counted(name, *args):
        entered.append(name)
        return real(name, *args)

    monkeypatch.setattr(torch.profiler, 'record_function', counted)
    models['standard'].rate_batch(_standard_batch(3, seed=19))
    assert entered == []
    with profile(activities=[ProfilerActivity.CPU]):
        models['standard'].rate_batch(_standard_batch(3, seed=19))
    assert entered == ['vaep/rate_batch', 'vaep/pad', *STAGES]
