"""The port's rating-service hooks against the JAX package's, on the CPU.

Counterparts of ``tests/test_slo.py``'s service cases (:228-320),
``tests/test_numerics.py::test_parity_probe_matches_reference_via_service``
and ``tests/test_learn.py``'s capture of served traffic. Each case runs the
same frames through both packages' ``RatingService`` on the same weights
and compares what the hook saw:

- SLO admission: the shed request's index, its machine-readable reason
  and the ``health()['slo']`` block are equal; ``slo/shed_total`` counts
  each shed;
- the parity probe under the flushes: the same probes, no exceedance,
  errors within 1e-5, the request id as exemplar; on the port the probe
  gets the flush's own batch, goalscore block and values (not host copies);
- the capture ring: the same frames and session streams, only for
  requests that were served;
- the learner's ``_parity_stats`` and the gate's verdict on them, through
  both packages' loop and gate;
- ``telemetry()``: the service's ``request_p99_s`` and ``breaker_state``
  fleet rows, scraped over a unix socket, equal to its ``health()``.

Windows are wide and coalescing is forced, so no pass depends on timing.
"""

import glob
import threading
from types import SimpleNamespace

import pandas as pd
import pytest
import torch

from socceraction_tpu.core.synthetic import synthetic_actions_frame
from socceraction_tpu.learn import ContinuousLearner as JaxLearner
from socceraction_tpu.learn.gate import GateConfig as JaxGate
from socceraction_tpu.learn.gate import evaluate_gate as jax_evaluate_gate
from socceraction_tpu.obs import REGISTRY as JAX_REGISTRY
from socceraction_tpu.obs.parity import ParityProbe as JaxProbe
from socceraction_tpu.obs.slo import SLOConfig as JaxSLOConfig
from socceraction_tpu.resil import FaultPlan as JaxFaultPlan
from socceraction_tpu.resil import FaultSpec as JaxFaultSpec
from socceraction_tpu.scenario import action_type_sweep as jax_action_type_sweep
from socceraction_tpu.serve import Overloaded as JaxOverloaded
from socceraction_tpu.serve import RatingService as JaxService
from socceraction_tpu.serve import SLOShed as JaxSLOShed
from socceraction_tpu.serve import TrafficCapture as JaxCapture
from socceraction_tpu.vaep.base import load_model as jax_load_model
from socceraction_tpu_torch.core.synthetic import synthetic_batch
from socceraction_tpu_torch.learn import ContinuousLearner
from socceraction_tpu_torch.learn.gate import GateConfig, evaluate_gate
from socceraction_tpu_torch.obs import REGISTRY, drain_guards
from socceraction_tpu_torch.obs.endpoint import serve as serve_telemetry
from socceraction_tpu_torch.obs.fleet import FleetAggregator
from socceraction_tpu_torch.obs.metrics import MetricRegistry
from socceraction_tpu_torch.obs.parity import ParityProbe
from socceraction_tpu_torch.obs.slo import SLOConfig
from socceraction_tpu_torch.ops import fused as fused_ops
from socceraction_tpu_torch.ops.cuda_build import KernelError
from socceraction_tpu_torch.resil import FaultPlan, FaultSpec
from socceraction_tpu_torch.scenario import action_type_sweep
from socceraction_tpu_torch.serve import Overloaded, RatingService, SLOShed, TrafficCapture
from socceraction_tpu_torch.vaep.base import VAEP

HOME = 100
A = 256
ATOL = 1e-5
WAIT = 60.0

PKGS = {
    'jax': SimpleNamespace(Service=JaxService, metrics=JAX_REGISTRY, SLOConfig=JaxSLOConfig,
                           SLOShed=JaxSLOShed, Probe=JaxProbe, Capture=JaxCapture,
                           FaultPlan=JaxFaultPlan, FaultSpec=JaxFaultSpec, Learner=JaxLearner,
                           Gate=JaxGate, evaluate_gate=jax_evaluate_gate),
    'port': SimpleNamespace(Service=RatingService, metrics=REGISTRY, SLOConfig=SLOConfig,
                            SLOShed=SLOShed, Probe=ParityProbe, Capture=TrafficCapture,
                            FaultPlan=FaultPlan, FaultSpec=FaultSpec, Learner=ContinuousLearner,
                            Gate=GateConfig, evaluate_gate=evaluate_gate),
}


@pytest.fixture(scope='module', autouse=True)
def _drain_guards():
    """Leave the process-wide guard ring empty for the next module."""
    yield
    drain_guards()


@pytest.fixture(scope='module')
def models(tmp_path_factory):
    """The same weights in both packages."""
    path = str(tmp_path_factory.mktemp('hooks'))
    model = VAEP(device='cpu').fit_packed(
        synthetic_batch(2, 256, seed=3, device='cpu'),
        tree_params={'hidden': (16,), 'batch_size': 256, 'max_epochs': 2}, random_state=0,
    )
    model.save_model(path)
    return {'port': model, 'jax': jax_load_model(path)}


def _frame(i, n):
    return synthetic_actions_frame(game_id=i, home_team_id=HOME, seed=i, n_actions=n)


def _value(p, name, **labels):
    return p.metrics.snapshot().value(name, **labels) or 0.0


def _service(pkg, models, **kw):
    return PKGS[pkg].Service(models[pkg], max_actions=A, max_batch_size=4, max_wait_ms=1.0, **kw)


# -- SLO admission (tests/test_slo.py:228-320) ---------------------------------------------


def _burning(p):
    """An impossible latency objective: every served request burns. Wide
    windows, so every event of the test is inside both."""
    return p.SLOConfig.simple(
        latency_ms=1e-6, latency_target=0.9, fast_window_s=600.0, slow_window_s=1200.0,
        min_events=4, shed_burn_rate=1.0, eval_interval_s=0.0,
    )


def _burn_until_shed(pkg, models, submit, tmp_path):
    p = PKGS[pkg]
    before = _value(p, 'slo/shed_total', objective='latency')
    with _service(pkg, models, slo=_burning(p), debug_dir=str(tmp_path / pkg)) as svc:
        svc.warmup()
        frame = _frame(5, 80)
        for i in range(10):
            try:
                submit(svc, frame)
            except p.SLOShed as e:
                shed = (i, e.reason)
                break
        else:
            raise AssertionError(f'{pkg}: the burning service never shed')
        slo = svc.health()['slo']
        # the other verbs shed too, before any packing or queueing
        with pytest.raises(p.SLOShed):
            svc.rate_scenarios(frame, None, home_team_id=HOME)
        with pytest.raises(p.SLOShed):
            svc.open_session('live', home_team_id=HOME).add_actions(frame.iloc[:10])
        assert svc._batcher.queue_depth == 0
    dumps = glob.glob(str(tmp_path / pkg / 'debug-*.tar.gz'))
    return shed, slo, _value(p, 'slo/shed_total', objective='latency') - before, bool(dumps)


@pytest.mark.parametrize('verb', ['rate', 'rate_scenarios'])
def test_forced_latency_burn_sheds_with_burn_rate_reason(models, tmp_path, verb):
    """A forced latency burn sheds at the same request in both packages,
    with the same burn-rate reason; ``SLOShed`` is an ``Overloaded``; the
    shed is counted, ``health()`` reads breaching and shedding, and the
    breach dumped a bundle. Scenario traffic burns and sheds the same."""

    def submit(svc, frame):
        if verb == 'rate':
            return svc.rate_sync(frame, home_team_id=HOME, timeout=WAIT)
        sweep = jax_action_type_sweep if isinstance(svc, JaxService) else action_type_sweep
        return svc.rate_scenarios_sync(frame, sweep(type_ids=[0, 1]), home_team_id=HOME,
                                       timeout=WAIT)

    out = {pkg: _burn_until_shed(pkg, models, submit, tmp_path) for pkg in PKGS}
    (index, reason), slo, shed_count, dumped = out['port']
    assert out['port'][0] == out['jax'][0]
    assert index == 4 and reason['objective'] == 'latency'
    assert reason['burn_rate_fast'] > 1.0 and reason['burn_rate_slow'] > 1.0
    assert reason['threshold'] == 1.0 and reason['budget_remaining'] == 0.0
    assert isinstance(SLOShed(reason), Overloaded) and issubclass(JaxSLOShed, JaxOverloaded)
    assert slo['objectives']['latency']['breaching'] is True and slo['shedding'] is True
    for key in ('objectives', 'shed_burn_rate', 'shedding'):
        assert slo[key] == out['jax'][1][key], key
    assert shed_count == out['jax'][2] == 3 and dumped and out['jax'][3]
    assert _value(PKGS['port'], 'serve/debug_dumps', reason='slo_breach') >= 1


def test_the_breach_bundle_is_written_outside_admission(models, tmp_path, monkeypatch):
    """The port writes an SLO breach's debug bundle, whose tensor census
    walks every object the collector tracks, on a thread of its own: the
    request that finds the breach is shed without waiting for the bundle,
    and ``close()`` waits for it."""
    from socceraction_tpu_torch.serve import service as port_service

    held, release, writers = threading.Event(), threading.Event(), []
    real = port_service.dump_debug_bundle

    def held_dump(*args, **kwargs):
        writers.append(threading.current_thread().name)
        held.set()
        release.wait(WAIT)
        return real(*args, **kwargs)

    monkeypatch.setattr(port_service, 'dump_debug_bundle', held_dump)
    p = PKGS['port']
    svc = _service('port', models, slo=_burning(p), debug_dir=str(tmp_path))
    closer = threading.Thread(target=svc.close)
    try:
        svc.warmup()
        frame = _frame(5, 80)
        with pytest.raises(p.SLOShed):
            for _ in range(10):
                svc.rate_sync(frame, home_team_id=HOME, timeout=WAIT)
        assert held.wait(WAIT) and writers == ['slo-breach-dump']
        assert svc.last_dump_path is None  # shed while the bundle is held
        closer.start()
        closer.join(0.2)
        assert closer.is_alive()
    finally:
        release.set()
    closer.join(WAIT)
    assert not closer.is_alive()
    assert glob.glob(str(tmp_path / 'debug-*.tar.gz')) == [svc.last_dump_path]


def test_steady_traffic_under_objective_is_never_shed(models):
    """Traffic inside the objective is never shed, the budget stays whole,
    in both packages."""
    seen = {}
    for pkg, p in PKGS.items():
        slo = p.SLOConfig.simple(latency_ms=600_000.0, fast_window_s=600.0,
                                 slow_window_s=1200.0, min_events=4, shed_burn_rate=1.0,
                                 eval_interval_s=0.0)
        with _service(pkg, models, slo=slo) as svc:
            svc.warmup()
            frame = _frame(6, 80)
            for _ in range(8):
                svc.rate_sync(frame, home_team_id=HOME, timeout=WAIT)
            seen[pkg] = svc.health()['slo']
    for name, entry in seen['port']['objectives'].items():
        assert entry['breaching'] is False and entry['budget_remaining'] == 1.0, (name, entry)
    assert seen['port']['shedding'] is False
    assert seen['port']['objectives'] == seen['jax']['objectives']


def test_health_reports_per_objective_budget_remaining(models):
    seen = {}
    for pkg, p in PKGS.items():
        slo = p.SLOConfig.simple(latency_ms={'rate': 60_000.0, 'session': 60_000.0},
                                 model_freshness_s=3600.0)
        with _service(pkg, models, slo=slo) as svc:
            seen[pkg] = svc.health()['slo']
    objectives = seen['port']['objectives']
    assert set(objectives) == set(seen['jax']['objectives']) == {
        'latency_rate', 'latency_session', 'errors', 'model_freshness'}
    for name, entry in objectives.items():
        assert 'budget_remaining' in entry
        jax_entry = seen['jax']['objectives'][name]
        assert entry.keys() == jax_entry.keys()
        assert {k: v for k, v in entry.items() if k != 'age_s'} == \
            {k: v for k, v in jax_entry.items() if k != 'age_s'}
    fresh = objectives['model_freshness']
    assert fresh['age_s'] is not None and fresh['ok'] is True


def test_service_without_slo_keeps_legacy_health_shape(models):
    for pkg in PKGS:
        with _service(pkg, models) as svc:
            health = svc.health()
        assert 'objectives' not in health['slo']
        assert set(health['slo']) == {'request_p99_ms', 'budget_p99_ms', 'ok'}


# -- the parity probe under the flushes ------------------------------------------------------


def test_parity_probe_matches_reference_via_service(models):
    """Every flush probed at ``sample_rate=1.0``: the same probe counts as
    the JAX service's, no exceedance, errors ≤ 1e-5, the request id as the
    exemplar, the stats in ``health()``; ``close()`` closes the probe."""
    seen = {}
    for pkg, p in PKGS.items():
        probe = p.Probe(sample_rate=1.0, max_abs_err=1e-4)
        with _service(pkg, models, parity=probe) as svc:
            fut = svc.rate(_frame(40, 100), home_team_id=HOME)
            fut.result(timeout=WAIT)
            svc.rate_sync(_frame(41, 150), home_team_id=HOME, timeout=WAIT)
            assert probe.flush(timeout=WAIT)
            stats = probe.stats()
            s = p.metrics.snapshot().series('num/parity_abs_err', pair='fused_vs_materialized')
            assert s is not None and s.exemplar
            assert svc.health()['numerics']['parity'] == probe.stats()
            assert svc.health()['status'] == 'ok'
        assert probe.should_sample() is False
        seen[pkg] = (stats, s.exemplar.get('request_id'), fut.request_id)
    port, jax = seen['port'][0], seen['jax'][0]
    for stats in (port, jax):
        assert stats['evaluated'] and stats['probes'] == 2 and stats['exceedances'] == 0
        assert stats['errors'] == 0 and stats['max_abs_err'] <= 1e-5
    assert {k: port[k] for k in ('probes', 'exceedances', 'errors', 'band')} == \
        {k: jax[k] for k in ('probes', 'exceedances', 'errors', 'band')}
    assert port['last']['n_compared'] == jax['last']['n_compared'] == 450
    assert seen['port'][1] is not None


def test_probe_gets_the_flushs_own_tensors_before_the_values_copy(models, monkeypatch):
    """A sampled flush hands ``submit_flush`` the batch ``rate_batch``
    rated, its goalscore override and the values tensor it returned, all
    on the model's device (the card's, there), before the values' host
    copy; a probe's reference then compares them."""
    model = models['port']
    real_rate = model.rate_batch
    rated, order = [], []

    def rate_batch(batch, **kw):
        out = real_rate(batch, **kw)
        rated.append((batch, kw['dense_overrides'], out))
        return out

    class Stub(ParityProbe):
        def submit_flush(self, model, batch, gs, values, exemplar=None):
            order.append('submit')
            self.received = (model, batch, gs, values, exemplar)
            return super().submit_flush(model, batch, gs, values, exemplar)

    real_cpu = torch.Tensor.cpu

    def cpu(self, *a, **k):
        if rated and self is rated[-1][2]:
            order.append('values_copy')
        return real_cpu(self, *a, **k)

    probe = Stub(sample_rate=1.0)
    monkeypatch.setattr(model, 'rate_batch', rate_batch)
    with _service('port', models, parity=probe) as svc:
        monkeypatch.setattr(torch.Tensor, 'cpu', cpu)
        fut = svc.rate(_frame(42, 90), home_team_id=HOME)
        fut.result(timeout=WAIT)
        monkeypatch.setattr(torch.Tensor, 'cpu', real_cpu)
        assert probe.flush(timeout=WAIT)
    got_model, batch, gs, values, exemplar = probe.received
    (want_batch, overrides, want_values), = rated
    assert got_model is model and batch is want_batch and values is want_values
    assert gs is overrides['goalscore'] and isinstance(gs, torch.Tensor)
    assert isinstance(batch.type_id, torch.Tensor) and batch.device == model.device
    assert exemplar == fut.request_id
    assert order[:2] == ['submit', 'values_copy']
    assert probe.stats()['probes'] == 1 and probe.stats()['max_abs_err'] <= 1e-5


def test_parity_exceedance_dumps_and_degrades_health(models, tmp_path):
    """A probe past its band (here a band below any error) fires the
    service's rate-limited ``parity`` dump and degrades ``health()``, in
    both packages alike."""
    seen = {}
    for pkg, p in PKGS.items():
        probe = p.Probe(sample_rate=1.0, max_abs_err=-1.0)
        before = _value(p, 'serve/debug_dumps', reason='parity')
        with _service(pkg, models, parity=probe, debug_dir=str(tmp_path / pkg)) as svc:
            svc.rate_sync(_frame(43, 60), home_team_id=HOME, timeout=WAIT)
            assert probe.flush(timeout=WAIT)
            health = svc.health()
        seen[pkg] = (health['status'], health['numerics']['ok'],
                     health['numerics']['parity']['exceedances'],
                     _value(p, 'serve/debug_dumps', reason='parity') - before,
                     probe.on_exceed == svc._on_parity_exceed)
    assert seen['port'] == seen['jax'] == ('degraded', False, 1, 1, True)


def test_a_kernel_failure_under_a_sampled_flush_is_never_probed_or_degraded(models, monkeypatch):
    """B1 cannot run under a flush the probe would sample: the request
    fails with ``KernelError``, nothing is probed, the breaker and the
    fallback count stay as they were."""
    probe = ParityProbe(sample_rate=1.0)
    frame = _frame(44, 70)
    with _service('port', models, parity=probe) as svc:
        breaker = svc.breaker.to_dict()
        fallbacks = _value(PKGS['port'], 'serve/fallback_flushes')

        def raising(*args, **kwargs):
            raise KernelError('gather_matmul kernel launch failed: cudaError_t 700')

        with monkeypatch.context() as m:
            m.setattr(fused_ops, 'fused_first_layer_quant', raising)
            with pytest.raises(KernelError, match='kernel launch failed'):
                svc.rate_sync(frame, home_team_id=HOME, timeout=WAIT)
        assert probe.flush(timeout=WAIT)
        assert probe.stats()['probes'] == 0
        assert svc.breaker.to_dict() == breaker
        assert _value(PKGS['port'], 'serve/fallback_flushes') == fallbacks
        svc.rate_sync(frame, home_team_id=HOME, timeout=WAIT)
        assert probe.flush(timeout=WAIT)
        assert probe.stats()['probes'] == 1


# -- the learner reads the probe -------------------------------------------------------------


@pytest.mark.parametrize('case', ['probed', 'no_probe', 'past_band'])
def test_learner_gates_on_the_probes_stats_as_the_jax_loop(models, case):
    """Each package's loop reads its service's probe (``_parity_stats``)
    and its gate judges the stats; the verdicts and reasons agree."""
    seen = {}
    for pkg, p in PKGS.items():
        probe = p.Probe(sample_rate=1.0) if case != 'no_probe' else None
        with _service(pkg, models, parity=probe) as svc:
            svc.rate_sync(_frame(45, 90), home_team_id=HOME, timeout=WAIT)
            if probe is not None:
                assert probe.flush(timeout=WAIT)
            stats = p.Learner._parity_stats(SimpleNamespace(service=svc))
        band = -1.0 if case == 'past_band' else 1e-4
        passed, reasons = p.evaluate_gate(None, {}, p.Gate(max_parity_err=band), parity=stats)
        shape = None if stats is None else {
            k: (v if k in ('evaluated', 'probes', 'exceedances', 'serve_nonfinite_events')
                else type(v).__name__) for k, v in stats.items()}
        seen[pkg] = (passed, [r.split(' ')[0] + r.split(' ')[1] for r in reasons], shape)
    assert seen['port'] == seen['jax']
    want = {'probed': True, 'no_probe': False, 'past_band': False}[case]
    assert seen['port'][0] is want


# -- the capture hook --------------------------------------------------------------------------


def _captured(pkg, models):
    """Serve a request, a failed request, a shed request and two session
    ticks with a capture ring attached; return what the ring holds."""
    p = PKGS[pkg]
    capture = p.Capture(max_frames=32)
    with _service(pkg, models, capture=capture, breaker_failures=0) as svc:
        svc.warmup()
        svc.rate_sync(_frame(70, 120), home_team_id=HOME, timeout=WAIT)
        with p.FaultPlan(seed=0, specs=[p.FaultSpec('serve.dispatch', error=RuntimeError,
                                                    nth=1)]):
            with pytest.raises(RuntimeError, match='injected fault'):
                svc.rate_sync(_frame(72, 60), home_team_id=HOME, timeout=WAIT)
        expired = svc.rate(_frame(73, 60), home_team_id=HOME, deadline_ms=1e-3)
        with pytest.raises(Exception):
            expired.result(timeout=WAIT)
        sess = svc.open_session('live-1', home_team_id=HOME)
        live = _frame(71, 90)
        sess.add_actions(live.iloc[:50], timeout=WAIT)
        sess.add_actions(live.iloc[50:], timeout=WAIT)
        counts = (len(capture), capture.total_actions)
    return counts, capture.frames()


def test_capture_records_only_served_traffic_as_the_jax_service(models):
    """Only a served ``rate`` request and the committed session ticks land
    in the ring, copied; a failed or expired request never does. The two
    packages' rings hold the same frames."""
    got = {pkg: _captured(pkg, models) for pkg in PKGS}
    assert got['port'][0] == got['jax'][0] == (2, 210)
    assert len(got['port'][1]) == len(got['jax'][1]) == 2
    for (pf, ph), (jf, jh) in zip(got['port'][1], got['jax'][1]):
        assert ph == jh
        pd.testing.assert_frame_equal(pf.reset_index(drop=True), jf.reset_index(drop=True))


def test_capture_copies_on_the_callers_thread(models):
    """The ring keeps the frame as it was submitted: a caller mutating its
    frame after ``rate()`` returns changes nothing captured."""
    capture = TrafficCapture(max_frames=4)
    frame = _frame(74, 50)
    want = frame.copy()
    with _service('port', models, capture=capture) as svc:
        fut = svc.rate(frame, home_team_id=HOME)
        frame['start_x'] = -1.0
        fut.result(timeout=WAIT)
    (got, home), = capture.frames()
    assert home == HOME
    pd.testing.assert_frame_equal(got, want)


# -- telemetry() -------------------------------------------------------------------------------


def test_telemetry_scrape_rows_equal_the_services_health(models, tmp_path):
    """``serve(telemetry=svc.telemetry(replica=...))`` on a unix socket:
    one aggregator scrape shows the service's ``request_p99_s`` and
    ``breaker_state`` rows, equal to its ``health()``; ``/health`` is the
    service's own."""
    from socceraction_tpu_torch.obs.endpoint import scrape_health

    with _service('port', models) as svc:
        for i in range(3):
            svc.rate_sync(_frame(80 + i, 60), home_team_id=HOME, timeout=WAIT)
        telemetry = svc.telemetry(replica='serve-0')
        assert telemetry.replica == 'serve-0'
        path = str(tmp_path / 'serve-0.sock')
        with serve_telemetry(telemetry=telemetry, unix_path=path):
            health = svc.health()
            scraped = scrape_health(path, timeout=5.0)
            agg = FleetAggregator({'serve-0': path}, registry=MetricRegistry())
            assert agg.scrape() == {'serve-0': True}
            rows = {r['signal']: r for r in agg.aggregate().divergence}
    assert scraped['status'] == health['status'] == 'ok'
    assert scraped['breaker'] == health['breaker']
    assert rows['request_p99_s']['value'] == pytest.approx(health['slo']['request_p99_ms'] / 1e3,
                                                           rel=1e-12)
    assert rows['breaker_state']['value'] == 0.0 and health['breaker']['state'] == 'closed'
    assert rows['breaker_state']['sick'] is False
