"""The port's runtime telemetry against the JAX package's.

- the dispatch observatory (the JAX package's compile observatory):
  signatures, keys, ``signature_diff`` and the retrace-storm detector;
- the live roofline: ``record_dispatch``, ``IdleTracker`` and
  ``perf_snapshot``, with no roofline where there are no peaks (here);
- ``ParityProbe``: its comparison core, sampling, drops, bands and
  ``on_exceed``, with a planted fault;
- memory and residency on the CPU (no card: nothing to read);
- the main paths' telemetry: after ``rate_batch``, ``ExpectedThreat.fit``
  and ``fit_packed`` on the same seeded data, both packages record the
  same metric names and label keys (the compile and dispatch observatories
  aside) and the same counts;
- ``total_actions`` reads no device: a batch carries its host count
  through every copy, and ``rate_batch`` adds no
  ``aten::_local_scalar_dense`` to its dispatch.
"""

import json
import threading

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from socceraction_tpu.core.synthetic import synthetic_batch as jax_synthetic_batch
from socceraction_tpu.obs import metrics as jmetrics
from socceraction_tpu.obs import parity as jparity
from socceraction_tpu.obs import perf as jperf
from socceraction_tpu.obs import residency as jresidency
from socceraction_tpu.obs import xla as jxla
from socceraction_tpu.vaep.base import VAEP as JaxVAEP
from socceraction_tpu.xthreat import ExpectedThreat as JaxExpectedThreat
from socceraction_tpu_torch.core import batch as tbatch
from socceraction_tpu_torch.core.synthetic import synthetic_batch
from socceraction_tpu_torch.obs import dispatch as tdispatch
from socceraction_tpu_torch.obs import memory as tmemory
from socceraction_tpu_torch.obs import metrics as tmetrics
from socceraction_tpu_torch.obs import numerics as tnumerics
from socceraction_tpu_torch.obs import parity as tparity
from socceraction_tpu_torch.obs import perf as tperf
from socceraction_tpu_torch.obs import recorder as trecorder
from socceraction_tpu_torch.obs import residency as tresidency
from socceraction_tpu_torch.obs import trace as ttrace
from socceraction_tpu_torch.pipeline import packed
from socceraction_tpu_torch.scenario import end_location_grid
from socceraction_tpu_torch.scenario.engine import expand_scenarios
from socceraction_tpu_torch.utils import profiling as tprofiling
from socceraction_tpu_torch.vaep.base import VAEP
from socceraction_tpu_torch.xthreat import ExpectedThreat

H100 = 'NVIDIA H100 80GB HBM3'


# -- the dispatch observatory ----------------------------------------------------------


TREES = [
    ((np.zeros((3, 4), np.float32),), {}),
    ((np.zeros((3, 4), np.float32), 1e-5, 7, True), {'eps': 0.5, 'name': 'picard'}),
    (({'b': np.zeros(2, np.int32), 'a': (np.ones(5), None)},), {'k': 3}),
    (([np.zeros(1, np.bool_), 'x'],), {'extra': {'z': 1.0, 'y': np.zeros((2, 2), np.int64)}}),
]


@pytest.mark.parametrize('tree', range(len(TREES)))
def test_signatures_match_jax(tree):
    """``signature_of`` reads an argument tree as the JAX package does:
    the same paths and leaf descriptions, scalars by type, ``None`` empty,
    dict keys sorted; equal keys for a changed scalar value."""
    args, kwargs = TREES[tree]
    assert tdispatch.signature_of(args, kwargs) == jxla.signature_of(args, kwargs, frozenset())
    bumped = tuple(a + 1 if isinstance(a, (int, float)) and not isinstance(a, bool) else a for a in args)
    assert tdispatch.call_key(bumped, kwargs) == tdispatch.call_key(args, kwargs)


def test_tensor_signatures_match_jax_arrays():
    """A torch tensor on the default device (the CPU here) reads like a
    JAX array on its default device; another device gets a suffix."""
    t = torch.zeros((2, 3), dtype=torch.float32)
    j = jnp.zeros((2, 3), jnp.float32)
    assert tdispatch.signature_of((t,), {}) == jxla.signature_of((j,), {}, frozenset())
    meta = torch.zeros((2, 3), device='meta')
    assert tdispatch.signature_of((meta,), {})[0][1] == 'float32[2,3]@meta'
    assert tdispatch.call_key((meta,), {}) != tdispatch.call_key((t,), {})
    module = torch.nn.Linear(3, 2)
    sig = dict(tdispatch.signature_of((module,), {}))
    assert sig == {'[0][0].weight': 'float32[2,3]', '[0][0].bias': 'float32[2]'}


def test_signature_diff_matches_jax():
    old = (('[0][0]', 'float32[4]'), ('[0][1]', 'py_int'), ('[1][\'k\']', "'a'"))
    new = (('[0][0]', 'float32[8]'), ('[0][2]', 'py_float'), ('[1][\'k\']', "'a'"))
    for pair in ((None, new), (old, new), (new, old), (old, old)):
        assert tdispatch.signature_diff(*pair) == jxla.signature_diff(*pair)


def test_retrace_storm_matches_jax():
    """Three new signatures inside the window trip a threshold of three in
    both observatories: one storm each, the same signature diff, the
    counters, the recorder event, and the snapshot's shape."""
    tfn = tdispatch.instrument(lambda x: x * 2, 'storm_probe', storm_threshold=3,
                               cost=lambda x: (x.numel(), 8 * x.numel()))
    jfn = jxla.instrument_jit(lambda x: x * 2, 'storm_probe', storm_threshold=3, cost=False)
    trecorder.RECORDER.clear()
    tmetrics.REGISTRY.reset()
    for n in (2, 3, 2, 4):
        tfn(torch.zeros(n))
        jfn(jnp.zeros(n))
    assert tfn.n_storms == jfn.n_storms == 1
    assert tfn.n_compiles == jfn.n_compiles == 3
    storms = [e for e in trecorder.RECORDER.events() if e['kind'] == 'retrace_storm']
    assert len(storms) == 1
    assert storms[0]['signature_diff'] == jxla.signature_diff(
        jfn.signatures()[1], jfn.signatures()[2]
    )
    snap = tmetrics.REGISTRY.snapshot()
    assert snap.value('dispatch/retrace_storm', fn='storm_probe') == 1
    assert snap.series('dispatch/signatures', fn='storm_probe').last == 3
    assert snap.series('dispatch/first_call_seconds', fn='storm_probe').count == 3
    assert tdispatch.fn_cost('storm_probe') == (4.0, 32.0)
    assert set(tfn.snapshot()) == set(jfn.snapshot()) | {'cost_flops', 'cost_bytes'}
    entry = tdispatch.observatory_snapshot()['storm_probe']
    assert entry['compiles'] >= 3 and entry['retrace_storms'] >= 1
    tfn.drain_storm_window()
    tfn(torch.zeros(5))
    assert tfn.n_storms == 1


def test_kernel_builds_are_counted():
    """An ``nvcc`` build counts into ``dispatch/kernel_builds`` and
    ``dispatch/build_seconds``; a library found on disk only records the
    load event."""
    tmetrics.REGISTRY.reset()
    trecorder.RECORDER.clear()
    tdispatch.record_kernel_build('probe_kernel', 2.5, compiled=True)
    tdispatch.record_kernel_build('probe_kernel', 0.01, compiled=False)
    snap = tmetrics.REGISTRY.snapshot()
    assert snap.value('dispatch/kernel_builds', kernel='probe_kernel') == 1
    assert snap.series('dispatch/build_seconds', kernel='probe_kernel').total == 2.5
    kinds = [(e['kind'], e['compiled']) for e in trecorder.RECORDER.events()]
    assert kinds == [('kernel_build', True), ('kernel_build', False)]


# -- the live roofline -----------------------------------------------------------------


def test_idle_tracker_matches_jax():
    """The same completions on an injected clock give the same idle
    fractions, the window's eviction included."""
    ticks = [0.0, 1.0, 1.5, 4.0, 4.2, 70.0, 70.5]
    busy = [0.5, 0.5, 0.1, 1.0, 0.2, 0.3, 0.25]
    out = {}
    for name, perf in (('jax', jperf), ('torch', tperf)):
        clock = iter(ticks)
        tracker = perf.IdleTracker(window_s=60.0, clock=lambda: next(clock))
        out[name] = [tracker.observe(b) for b in busy]
    assert out['torch'] == out['jax']
    assert out['torch'][0] is None and 0 < out['torch'][3] < 1


def test_record_dispatch_roofline_needs_peaks():
    """On the CPU no peak applies: achieved rates are recorded, no
    roofline; against the H100's peaks the binding wall is the larger
    fraction. The snapshot keeps the JAX package's keys."""
    for perf in (jperf, tperf):
        perf.reset_perf()
    tmetrics.REGISTRY.reset()
    cpu = tperf.record_dispatch('probe_fn', 0.5, bucket=4, flops=1e9, bytes_accessed=1e10)
    jcpu = jperf.record_dispatch('probe_fn', 0.5, bucket=4, flops=1e9, bytes_accessed=1e10,
                                 device_kind='cpu')
    assert 'roofline_frac' not in cpu and set(cpu) == set(jcpu)
    assert cpu['achieved_bytes'] == 2e10 and cpu['achieved_flops'] == 2e9
    card = tperf.record_dispatch('probe_fn', 0.01, flops=6.7e9, bytes_accessed=1e9, device_kind=H100)
    assert card['roofline_frac'] == pytest.approx(max(6.7e11 / 67e12, 1e11 / 3.35e12))
    snap = tmetrics.REGISTRY.snapshot()
    assert snap.series('perf/roofline_frac', fn='probe_fn').count == 1
    assert snap.value('perf/dispatches', fn='probe_fn', bucket='4') == 1
    assert snap.series('perf/device_idle_frac', fn='probe_fn').count == 1
    assert tperf.perf_snapshot()['probe_fn']['dispatches'] == 2
    assert tperf.device_peaks('NVIDIA H100 PCIe') is None and tperf.device_peaks('cpu') is None
    # with no explicit cost the observatory's books are read
    tdispatch.instrument(lambda x: x, 'probe_costed', cost=lambda x: (10.0, 80.0))(torch.ones(2))
    rec = tperf.record_dispatch('probe_costed', 2.0)
    assert (rec['cost_flops'], rec['cost_bytes']) == (10.0, 80.0)
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv('SOCCERACTION_TPU_PERF_SAMPLE_N', '0')
        assert tperf.record_dispatch('probe_fn', 1.0) is None


# -- the parity probe ------------------------------------------------------------------


def test_parity_compare_matches_jax():
    """The comparison core: the same errors, ulps and verdicts on arrays
    with masked padding, NaNs on both sides and on one side."""
    rng = np.random.default_rng(0)
    want = rng.normal(0, 1, (3, 16, 3)).astype(np.float32)
    got = want + rng.normal(0, 1e-6, want.shape).astype(np.float32)
    mask = np.ones((3, 16), bool)
    mask[2, 10:] = False
    got[2, 12] = 100.0  # padding: never compared
    got[0, 1, 0] = want[0, 1, 0] = np.nan
    cases = [(got, want, mask), (got, want, None)]
    one_sided = got.copy()
    one_sided[1, 1, 1] = np.nan
    cases.append((one_sided, want, mask))
    for g, w, m in cases:
        a = jparity.ParityProbe(max_abs_err=1e-5).compare('fused_vs_materialized', g, w, mask=m)
        b = tparity.ParityProbe(max_abs_err=1e-5).compare('fused_vs_materialized', g, w, mask=m)
        assert json.dumps(a, sort_keys=True) == json.dumps(b, sort_keys=True)


def _model():
    from chip_smoke import make_model

    return make_model('cpu', (8,))


@pytest.fixture(scope='module')
def served():
    """A small random-head model and three rated games."""
    model = _model()
    batch = synthetic_batch(3, 256, seed=8, device='cpu')
    return model, batch, model.rate_batch(batch)


def test_parity_probe_samples_and_catches_a_planted_offset(served):
    """Every sampled dispatch is re-rated off-thread within 1e-5; values
    offset by 1e-3 are one exceedance, with its event and hook."""
    model, batch, values = served
    trecorder.RECORDER.clear()
    exceeded = []
    probe = tparity.ParityProbe(sample_rate=1.0, max_abs_err=1e-5, queue_size=8,
                                on_exceed=exceeded.append)
    try:
        for i in range(3):
            assert probe.should_sample()
            assert probe.submit_flush(model, batch, None, values, exemplar=f'r{i}')
        assert probe.flush(timeout=60)
        stats = probe.stats()
        assert stats['probes'] == 3 and stats['exceedances'] == 0 and stats['errors'] == 0
        assert stats['max_abs_err'] <= 1e-5
        assert probe.submit_flush(model, batch, None, values + 1e-3, exemplar='planted')
        assert probe.flush(timeout=60)
        stats = probe.stats()
        assert stats['exceedances'] == 1 and stats['max_abs_err'] == pytest.approx(1e-3, rel=1e-3)
        assert [o['request_id'] for o in exceeded] == ['planted']
        events = [e for e in trecorder.RECORDER.events() if e['kind'] == 'parity_exceeded']
        assert len(events) == 1 and events[0]['pair'] == 'fused_vs_materialized'
    finally:
        probe.close()
    assert not probe.submit_flush(model, batch, None, values)


def test_parity_probe_drops_when_full(served):
    """A full queue drops the sample and counts it; the caller never
    waits. Half-rate sampling is deterministic."""
    model, batch, values = served
    started, gate = threading.Event(), threading.Event()

    class Slow:
        quantize = 'none'

        def rate_batch_reference(self, b, dense_overrides=None):
            started.set()
            gate.wait(timeout=30)
            return model.rate_batch_reference(b)

    tmetrics.REGISTRY.reset()
    probe = tparity.ParityProbe(sample_rate=0.5, queue_size=1)
    try:
        assert [probe.should_sample() for _ in range(4)] == [True, False, True, False]
        accepted = [probe.submit_flush(Slow(), batch, None, values)]
        assert started.wait(timeout=30)  # the worker holds the first
        accepted += [probe.submit_flush(Slow(), batch, None, values) for _ in range(3)]
        gate.set()
        assert probe.flush(timeout=60)
    finally:
        probe.close()
    assert accepted == [True, True, False, False]
    assert tmetrics.REGISTRY.snapshot().value('num/parity_dropped') == 2
    assert probe.stats()['probes'] == 2


# -- memory and residency --------------------------------------------------------------


def test_memory_on_the_cpu_reads_nothing():
    """No card: no stats, no gauges, an unsupported census; the sampler
    stops at its first tick; a span's memory request adds nothing."""
    assert tmemory.device_memory_stats() is None
    assert tmemory.sample_device_memory() == {}
    assert tmemory.live_array_census() == {'supported': False}
    with tmemory.MemorySampler(interval_s=0.01) as sampler:
        sampler._thread.join(timeout=10)
    assert sampler.supported is False and sampler.samples == 0
    with ttrace.span('obs_test/memory') as sp:
        sp.memory()
    assert 'mem_peak_bytes' not in sp.attrs


def test_residency_report_on_the_cpu_matches_jax():
    """The same claims give the same owners and totals in both packages;
    with no card the port's census is unsupported and the report says
    nothing of unattributed or reserved bytes."""
    arrays = {'grid': np.zeros((20, 192), np.float32), 'probs': np.ones((20, 3, 192), np.float32)}
    reports = {}
    for name, residency in (('jax', jresidency), ('torch', tresidency)):
        residency.reset_residency()
        held = residency.claim_bytes('xt_fleet', arrays)
        residency.claim_bytes('pipeline_feed', [np.zeros(1000, np.int32)], key='chunk-0')
        reports[name] = residency.residency_report()
        held.release()
        reports[name + ' after'] = residency.owned_bytes()
        residency.reset_residency()
    t, j = reports['torch'], reports['jax']
    assert t['owners'] == j['owners'] == {'pipeline_feed': 4000, 'xt_fleet': 61440}
    assert t['owned_total_bytes'] == j['owned_total_bytes']
    assert t == {'owners': t['owners'], 'owned_total_bytes': 65440, 'census_supported': False}
    assert reports['torch after'] == reports['jax after'] == {'pipeline_feed': 4000}


def test_profile_trace_writes_a_trace(tmp_path):
    """``profile_trace`` captures a torch.profiler trace (CPU activity
    here) inside a span and writes it as Chrome trace JSON."""
    with tprofiling.profile_trace(str(tmp_path)) as prof:
        torch.ones(64).cumsum(0)
    assert prof is not None
    (path,) = tmp_path.glob('trace-*.json')
    assert json.loads(path.read_text())['traceEvents']
    with tprofiling.profile_trace(str(tmp_path / 'off'), enabled=False) as prof:
        pass
    assert prof is None and not (tmp_path / 'off').exists()


# -- the main paths' telemetry ---------------------------------------------------------


def _recorded(registry):
    """``{name: sorted label-key sets}`` of every series with samples,
    the compile and dispatch observatories aside."""
    out = {}
    for name, inst in registry.snapshot().instruments.items():
        if name.startswith(('xla/', 'dispatch/')):
            continue
        keys = sorted({tuple(sorted(s.labels)) for s in inst.series if s.count})
        if keys:
            out[name] = (inst.kind, inst.unit, keys)
    return out


def test_main_path_telemetry_matches_jax():
    """``fit_packed``, then ``rate_batch`` of three games, then an xT fit
    of the same games, in both packages: equal metric names, kinds,
    units and label keys after each; equal rated actions and sweeps."""
    tree = dict(hidden=(8,), batch_size=256, max_epochs=2)
    steps = {
        'jax': dict(
            fit=lambda: JaxVAEP().fit_packed(jax_synthetic_batch(4, 256, seed=3),
                                             tree_params=tree, random_state=0),
            batch=jax_synthetic_batch(3, 256, seed=1),
            xt=JaxExpectedThreat,
        ),
        'torch': dict(
            fit=lambda: VAEP(device='cpu').fit_packed(synthetic_batch(4, 256, seed=3, device='cpu'),
                                                      tree_params=tree, random_state=0),
            batch=synthetic_batch(3, 256, seed=1, device='cpu'),
            xt=lambda: ExpectedThreat(device='cpu'),
        ),
    }
    # the guard ring is process-wide: drain what earlier tests on this
    # worker left, or a full ring's evictions (num/guard_drops) read as
    # this run's telemetry
    tnumerics.drain_guards()
    out = {}
    for name, metrics in (('jax', jmetrics), ('torch', tmetrics)):
        s = steps[name]
        metrics.REGISTRY.reset()
        model = s['fit']()
        fit = _recorded(metrics.REGISTRY)
        metrics.REGISTRY.reset()
        model.rate_batch(s['batch'])
        rate = _recorded(metrics.REGISTRY)
        snap = metrics.REGISTRY.snapshot()
        labels = {'path': 'fused', 'platform': 'cpu'}
        counts = (
            snap.value('vaep/rated_actions', **labels),
            snap.series('vaep/rate_batch_actions', **labels).total,
        )
        metrics.REGISTRY.reset()
        s['xt']().fit(s['batch'])
        xt = _recorded(metrics.REGISTRY)
        sweeps = [
            s.total for s in metrics.REGISTRY.snapshot().get('xt/solve_iterations').series if s.count
        ]
        out[name] = (fit, rate, xt, counts, sweeps)
    jfit, jrate, jxt, jcounts, jsweeps = out['jax']
    tfit, trate, txt_, tcounts, tsweeps = out['torch']
    assert tfit == jfit
    assert trate == jrate
    assert set(txt_) == set(jxt)
    for name in txt_:
        assert txt_[name] == jxt[name], name
    assert tcounts == jcounts == (768.0, 768.0)
    assert tsweeps == jsweeps and tsweeps[0] > 1
    assert 'train/epoch_seconds' in tfit and 'perf/achieved_bytes' in txt_


def _local_scalar_reads(fn):
    """Count ``aten::_local_scalar_dense`` (a tensor read to a host
    scalar) under torch.profiler while ``fn`` runs."""
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU]) as prof:
        fn()
    return sum(e.count for e in prof.key_averages() if e.key == 'aten::_local_scalar_dense')


def test_total_actions_reads_no_device(served):
    """A batch answers ``total_actions`` from its host count, kept through
    moves, casts, padding, scenario folds and the feed's wire; the
    telemetry adds no tensor read to ``rate_batch``."""
    model, batch, _ = served
    assert _local_scalar_reads(lambda: batch.total_actions) == 0
    made = {
        'to': batch.to('cpu'),
        'astype': batch.astype('float64'),
        'pad': tbatch.pad_batch_games(batch, 4),
        'fold': expand_scenarios(batch, end_location_grid(2, 2))[0],
    }
    host = tbatch.ActionBatch(**{n: t.numpy() for n, t in batch.fields().items()})
    made['shipped'] = packed.ship_host_batch(host, device='cpu')
    want = int(batch.n_actions.sum())
    for name, b in made.items():
        reads = _local_scalar_reads(lambda: b.total_actions)
        assert (name, reads) == (name, 0)
        assert b.total_actions == (4 * want if name == 'fold' else want), name
    # a card batch built field by field has no host count: one read, kept
    meta = tbatch.ActionBatch(**{n: torch.empty_like(t, device='meta') for n, t in batch.fields().items()})
    assert meta._host_total is None
    assert meta.with_total(5).total_actions == 5
    plain = _local_scalar_reads(lambda: model._rate(batch))
    traced = _local_scalar_reads(lambda: model.rate_batch(batch))
    assert traced == plain
