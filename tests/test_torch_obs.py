"""The port's host telemetry against the JAX package's.

The same seeded sequence of metric operations, spans, recorder events and
run-log writes goes through both packages' host modules (stdlib only in
both), on private registries where the API allows it:

- ``prometheus_text`` and ``snapshot_dict`` render equal strings, and
  ``timer_report_compat`` equal dicts;
- a ``RunLog`` holds the same event types, in the same order, with the
  same fields;
- a debug bundle has the same members, and its files the same keys;
- the SLO engine gives equal burn rates and ``should_shed`` verdicts on a
  seeded event stream with an injected clock;
- ``RequestContext`` headers round-trip between the packages;
- the cold-start report has the JAX package's shape and its phase sums.
"""

import json
import tarfile
import time

import numpy as np
import pytest
import torch  # noqa: F401  (the run manifest describes torch's devices once torch is loaded)

from socceraction_tpu.obs import coldstart as jcoldstart
from socceraction_tpu.obs import context as jcontext
from socceraction_tpu.obs import export as jexport
from socceraction_tpu.obs import metrics as jmetrics
from socceraction_tpu.obs import recorder as jrecorder
from socceraction_tpu.obs import slo as jslo
from socceraction_tpu.obs import trace as jtrace
from socceraction_tpu_torch.obs import coldstart as tcoldstart
from socceraction_tpu_torch.obs import context as tcontext
from socceraction_tpu_torch.obs import export as texport
from socceraction_tpu_torch.obs import metrics as tmetrics
from socceraction_tpu_torch.obs import recorder as trecorder
from socceraction_tpu_torch.obs import slo as tslo
from socceraction_tpu_torch.obs import trace as ttrace
from socceraction_tpu_torch.ops import cuda_build
from socceraction_tpu_torch.utils import profiling as tprofiling

def _without_exemplar_stamps(snapshot_dict):
    """A snapshot dict with the exemplars' wall-clock stamps taken out."""
    for inst in snapshot_dict.values():
        for series in inst['series']:
            series.get('exemplar', {}).pop('ts', None)
    return snapshot_dict


PACKAGES = {
    'jax': (jmetrics, jexport, jtrace, jrecorder),
    'torch': (tmetrics, texport, ttrace, trecorder),
}


def _seeded_operations(metrics, seed):
    """A private registry after a seeded sequence of counter, gauge and
    histogram operations with labels, units, exemplars and overflow."""
    rng = np.random.default_rng(seed)
    reg = metrics.MetricRegistry()
    c = reg.counter('area/events', unit='count', help='events seen')
    g = reg.gauge('area/depth', unit='chunks')
    h = reg.histogram('area/latency', unit='s')
    a = reg.histogram('area/rows', unit='actions', on_overflow='overflow')
    for i in range(600):
        op = int(rng.integers(0, 4))
        label = f'k{int(rng.integers(0, 3))}'
        value = float(rng.exponential(0.05))
        if op == 0:
            c.inc(int(rng.integers(1, 4)), kind=label)
        elif op == 1:
            g.set(value * 100, stage=label)
        elif op == 2:
            exemplar = {'request_id': f'r{i}'} if i % 7 == 0 else None
            h.observe(value, exemplar=exemplar, path=label)
        else:
            # 100 label values against a budget of 64: the overflow series fills
            a.observe(float(rng.integers(1, 2000)), bucket=str(int(rng.integers(0, 100))))
    return reg


@pytest.mark.parametrize('seed', [0, 1, 2])
def test_export_strings_equal(seed):
    """Prometheus text, the JSON snapshot (with and without buckets) and
    the legacy report render equal for one seeded operation sequence."""
    out = {}
    for name, (metrics, export, _trace, _rec) in PACKAGES.items():
        snap = _seeded_operations(metrics, seed).snapshot()
        out[name] = (
            export.prometheus_text(snap),
            json.dumps(_without_exemplar_stamps(export.snapshot_dict(snap)), sort_keys=True),
            json.dumps(
                _without_exemplar_stamps(export.snapshot_dict(snap, buckets=False)), sort_keys=True
            ),
            export.timer_report_compat(snap),
            export.timer_report_compat(snap, {'lat': ('area/latency', {'path': 'k1'})}),
        )
    assert out['torch'] == out['jax']
    assert 'area_rows_actions_bucket' in out['torch'][0]
    assert 'overflow="true"' in out['torch'][0]


def test_timer_facade_matches_jax():
    """``timed``, ``record_value`` and ``timer_report`` of the port's
    ``utils/profiling`` report the JAX façade's keys and counts."""
    from socceraction_tpu.utils import profiling as jprofiling

    reports = {}
    for name, (metrics, prof) in {
        'jax': (jmetrics, jprofiling), 'torch': (tmetrics, tprofiling)
    }.items():
        metrics.REGISTRY.reset()
        for _ in range(3):
            with prof.timed('obs_test/stage'):
                pass
        prof.record_value('obs_test/level', 4.0)
        metrics.histogram('pipeline/stage_seconds', unit='s').observe(0.5, stage='pack')
        report = prof.timer_report()
        reports[name] = {
            k: {f: v for f, v in e.items() if f in ('count', 'unit')}
            for k, e in report.items()
            if k.startswith(('obs_test/', 'pipeline/pack'))
        }
    assert reports['torch'] == reports['jax']
    assert reports['torch']['obs_test/stage']['count'] == 3


def _run_log_events(trace, recorder, path):
    """One seeded run through a package's RunLog; its events."""
    recorder.RECORDER.clear()
    with trace.RunLog(str(path), config={'games': 4}) as log:
        with trace.span('obs_test/outer', games=4) as outer:
            outer.annotate(rows=1024)
            with trace.span('obs_test/inner'):
                log.event('custom', value=1.5)
        with pytest.raises(KeyError):
            with trace.span('obs_test/failing'):
                raise KeyError('planted')
        log.metric_snapshot()
    with open(path / 'obs.jsonl') as f:
        return [json.loads(line) for line in f]


def test_runlog_events_match_jax(tmp_path):
    """The same event types in the same order, each with the same fields;
    span nesting by parent id; the manifest's keys."""
    events = {}
    for name, (_m, _e, trace, recorder) in PACKAGES.items():
        (tmp_path / name).mkdir()
        events[name] = _run_log_events(trace, recorder, tmp_path / name)
    jev, tev = events['jax'], events['torch']
    assert [e['event'] for e in tev] == [e['event'] for e in jev]
    for je, te in zip(jev, tev):
        assert set(te) == set(je), te['event']
        if te['event'].startswith('span'):
            for key in ('name', 'attrs', 'status'):
                assert te.get(key) == je.get(key)
    assert set(tev[0]['manifest']) == set(jev[0]['manifest'])
    assert tev[0]['manifest']['device']['platform'] == 'cpu'
    closes = [e for e in tev if e['event'] == 'span_close']
    opens = {e['span_id']: e for e in tev if e['event'] == 'span_open'}
    inner, outer = closes[0], closes[1]
    assert inner['parent_id'] == outer['span_id'] and outer['parent_id'] is None
    assert closes[2]['error'] == "KeyError: 'planted'"
    assert set(opens) == {e['span_id'] for e in closes}


def test_runlog_activation_is_exclusive_and_rotates(tmp_path):
    """One run log at a time; writes past ``max_bytes`` rotate."""
    log = ttrace.RunLog(str(tmp_path), max_bytes=400, keep=2).open()
    try:
        with pytest.raises(RuntimeError, match='already active'):
            ttrace.RunLog(str(tmp_path / 'other')).open()
        for i in range(40):
            log.event('filler', i=i)
    finally:
        log.close()
    assert ttrace.current_runlog() is None
    assert (tmp_path / 'obs.jsonl.1').exists() and not (tmp_path / 'obs.jsonl.3').exists()


def _bundle(trace, recorder, out_dir):
    recorder.RECORDER.clear()
    with trace.span('obs_test/before_crash', step=3):
        pass
    recorder.RECORDER.record('custom', detail='x')
    path = recorder.dump_debug_bundle(str(out_dir), reason='manual', trigger={'why': 'test'})
    with tarfile.open(path) as tar:
        return {m.name: tar.extractfile(m).read().decode() for m in tar.getmembers()}


def test_bundle_layout_matches_jax(tmp_path):
    """Members, manifest keys, ring events and the memory file's keys."""
    bundles = {
        name: _bundle(trace, recorder, tmp_path / name)
        for name, (_m, _e, trace, recorder) in PACKAGES.items()
    }
    jb, tb = bundles['jax'], bundles['torch']
    assert sorted(tb) == sorted(jb) == ['manifest.json', 'memory.json', 'metrics.json', 'ring.jsonl']
    jman, tman = json.loads(jb['manifest.json']), json.loads(tb['manifest.json'])
    assert set(tman) == set(jman) and tman['reason'] == 'manual'
    assert tman['trigger'] == {'why': 'test'}
    jring = [json.loads(line) for line in jb['ring.jsonl'].splitlines()]
    tring = [json.loads(line) for line in tb['ring.jsonl'].splitlines()]
    assert [(e['kind'], set(e)) for e in tring] == [(e['kind'], set(e)) for e in jring]
    tmem = json.loads(tb['memory.json'])
    assert set(tmem) == set(json.loads(jb['memory.json']))
    # no card here: the port's memory report says so
    assert tmem == {'device_memory_stats': None, 'live_arrays': {'supported': False},
                    'supported': False}
    assert trecorder.default_debug_dir() == jrecorder.default_debug_dir()


def _slo_engine(slo, metrics, clock):
    config = slo.SLOConfig.simple(
        latency_ms={'rate': 100.0, 'session': 50.0}, latency_target=0.9, error_target=0.95,
        model_freshness_s=30.0, fast_window_s=1.0, slow_window_s=3.0, min_events=5,
        shed_burn_rate=2.0, eval_interval_s=0.0,
    )
    breaches = []
    engine = slo.SLOEngine(
        config, model_age_s=lambda: clock[0] * 4.0, registry=metrics.MetricRegistry(),
        time_fn=lambda: clock[0], on_breach=lambda name, entry: breaches.append(name),
    )
    return engine, breaches


@pytest.mark.parametrize('seed', [0, 5])
def test_slo_burn_rates_and_verdicts_match_jax(seed):
    """A seeded stream of request outcomes, with bursts of slow and
    failing requests: equal evaluations, verdicts and breach hooks."""
    clocks = {'jax': [0.0], 'torch': [0.0]}
    engines = {
        'jax': _slo_engine(jslo, jmetrics, clocks['jax']),
        'torch': _slo_engine(tslo, tmetrics, clocks['torch']),
    }
    rng = np.random.default_rng(seed)
    verdicts = {'jax': [], 'torch': []}
    for step in range(300):
        dt = float(rng.exponential(0.02))
        bad_phase = 100 <= step < 180
        kind = 'rate' if rng.random() < 0.7 else 'session'
        wall = float(rng.exponential(0.2 if bad_phase else 0.02))
        status = 'error' if rng.random() < (0.3 if bad_phase else 0.01) else 'ok'
        if rng.random() < 0.02:
            status = 'expired'
        for name, (engine, _) in engines.items():
            clocks[name][0] += dt
            engine.observe_request(kind, wall, status)
            if step % 10 == 0:
                verdicts[name].append((
                    engine.should_shed('rate'), engine.should_shed('session'),
                    json.dumps(engine.evaluate(), sort_keys=True, default=str),
                ))
    assert verdicts['torch'] == verdicts['jax']
    assert engines['torch'][1] == engines['jax'][1]
    assert any(shed for (shed, _), _s, _e in verdicts['torch'])


def test_request_context_wire_round_trips():
    """Headers minted by one package are read by the other, and back."""
    for make, read in ((jcontext, tcontext), (tcontext, jcontext)):
        ctx = make.new_request_context('session', deadline_ms=5000.0)
        ctx.hop = 2
        headers = ctx.to_wire()
        got = read.RequestContext.from_wire(json.loads(json.dumps(headers)))
        assert got.request_id == ctx.request_id and got.kind == 'session'
        assert got.hop == 3
        assert 0 < got.remaining_s() <= 5.0
        assert set(got.to_wire()) == set(headers)
    with pytest.raises(ValueError):
        tcontext.RequestContext.from_wire({'kind': 'rate'})


def test_request_lifecycle_records_like_jax(tmp_path):
    """``record_request_enqueue``, ``record_segment`` and
    ``record_request_done`` land the same run-log events and the same
    ``serve/segment_seconds`` series (exemplar attached) in both packages."""
    out = {}
    for name, (metrics, context, trace) in {
        'jax': (jmetrics, jcontext, jtrace), 'torch': (tmetrics, tcontext, ttrace)
    }.items():
        metrics.REGISTRY.reset()
        (tmp_path / name).mkdir()
        with trace.RunLog(str(tmp_path / name)):
            ctx = context.new_request_context(deadline_ms=1000.0)
            context.record_request_enqueue(ctx, queue_depth=3)
            context.record_segment('queue_wait', 0.25, request_id=ctx.request_id)
            ctx.segments['queue_wait'] = 0.25
            context.record_request_done(ctx, 'ok', 0.3, bucket=4, coalesced=2, flush_span_id=7)
        with open(tmp_path / name / 'obs.jsonl') as f:
            events = [json.loads(line) for line in f]
        s = metrics.REGISTRY.snapshot().get('serve/segment_seconds').series_for(segment='queue_wait')
        out[name] = (
            [(e['event'], sorted(e)) for e in events if e['event'].startswith('request')],
            s.count, s.total, s.exemplar['request_id'] == ctx.request_id,
        )
    assert out['torch'] == out['jax']
    assert [e for e, _ in out['torch'][0]] == ['request_enqueue', 'request_done']


def test_coldstart_report_matches_jax_shape():
    """Anchored timelines with the port's phases: the JAX package's report
    keys, phase order, and the phase sum within the wall."""
    reports = {}
    for name, coldstart in (('jax', jcoldstart), ('torch', tcoldstart)):
        tl = coldstart.ColdstartTimeline()
        assert tl.report() == {'supported': False, 'phases': [], 'marks': {}}
        anchor = time.time() - 0.5
        tl.begin(process_start=anchor)
        tl.begin(process_start=anchor - 100)  # the first anchor wins
        for phase in tcoldstart.PHASES:
            with tl.phase(phase, start_unix=anchor if phase == 'import' else None):
                time.sleep(0.002)
        tl.mark('first_rated_action')
        reports[name] = tl.report()
    jr, tr = reports['jax'], reports['torch']
    assert set(tr) == set(jr)
    assert [p['phase'] for p in tr['phases']] == list(tcoldstart.PHASES)
    assert tr['phase_total_s'] == pytest.approx(sum(tr['phase_seconds'].values()))
    assert tr['phase_total_s'] <= tr['wall_s'] + 1e-6
    assert tr['phase_seconds']['import'] >= 0.5
    assert abs(tcoldstart.process_start_unix() - jcoldstart.process_start_unix()) < 1e-6


def test_kernel_build_is_a_coldstart_phase():
    """``load_libraries`` marks the ``kernel_build`` phase of the process
    timeline (with nothing to build here, an empty phase)."""
    before = len(tcoldstart.TIMELINE.report()['phases'])
    assert cuda_build.load_libraries([]) == {}
    phases = tcoldstart.TIMELINE.report()['phases']
    assert len(phases) == before + 1 and phases[-1]['phase'] == 'kernel_build'
