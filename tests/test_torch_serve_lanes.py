"""The rating service's replica lanes against the JAX package's, on the CPU.

Counterparts of ``tests/test_mesh_serve.py``'s N-replica ``RatingService``
cases (one-lane against four-lane values, the breaker topology, the
service-wide swap, one sick lane), plus what the port adds: a kernel that
cannot run on one lane is never degraded, lanes share the model's
weights, and lanes sit on the cards by index. Each scenario runs the same
requests through both packages' services on the same weights (a tiny port
model and the JAX package's load of its checkpoint; the JAX lanes run on
its virtual CPU devices, the port's on the one CPU):

- a four-lane service's values against the one-lane service's: bitwise in
  each package (the same function on the same device, whatever lane);
- the two packages' values: within 1e-5 (the same weights, f32 sums in
  another order);
- errors, ``health()['replicas']`` and the serve-area counts: equal.
"""

import threading
import time

import numpy as np
import pytest
import torch

from socceraction_tpu.resil.breaker import CircuitBreaker as JaxBreaker
from socceraction_tpu.resil.faults import FaultPlan as JaxFaultPlan
from socceraction_tpu.resil.faults import FaultSpec as JaxFaultSpec
from socceraction_tpu_torch.obs import REGISTRY, drain_guards
from socceraction_tpu_torch.obs.parity import ParityProbe
from socceraction_tpu_torch.ops.cuda_build import KernelError
from socceraction_tpu_torch.resil.breaker import CircuitBreaker
from socceraction_tpu_torch.resil.faults import FaultPlan, FaultSpec
from socceraction_tpu_torch.scenario.grid import custom_grid, end_location_grid
from socceraction_tpu_torch.serve import RatingService, service as serve_service
from tests.test_torch_serve import (
    ATOL,
    HOME,
    PKGS,
    WAIT,
    _both_models,
    _fit,
    _frame,
    _reference,
    _request_frames,
    _try,
)

N = 4
A = 256


@pytest.fixture(scope='module', autouse=True)
def _drain_guards():
    """Leave the process-wide guard ring empty for the next module."""
    yield
    drain_guards()


@pytest.fixture(scope='module')
def models(tmp_path_factory):
    return _both_models(_fit(3, (16,)), str(tmp_path_factory.mktemp('lanes-v1')))


@pytest.fixture(scope='module')
def models_b(tmp_path_factory):
    return _both_models(_fit(5, (8,)), str(tmp_path_factory.mktemp('lanes-v2')))


def _fallbacks(p, replica):
    return p.metrics.snapshot().value('serve/fallback_flushes', replica=replica)


# -- values ---------------------------------------------------------------------------------


def test_one_vs_four_lane_service_bitwise_parity(models):
    """The four-lane service is a pure fan-out: its values are bitwise the
    one-lane service's for the same requests in each package, within 1e-5
    across the packages; every lane warms its own ladder and steady
    traffic adds no shape; ``health()`` carries the replicas block."""
    frames = _request_frames(8, rng_seed=7, lo=60, hi=200)
    outs, health, shapes = {}, {}, {}
    for pkg, p in PKGS.items():
        with p.Service(models[pkg], max_actions=A, max_batch_size=4, max_wait_ms=1.0) as svc1:
            ref = [svc1.rate_sync(f, home_team_id=HOME, timeout=WAIT) for f in frames]
        with p.Service(models[pkg], max_actions=A, max_batch_size=4, max_wait_ms=1.0,
                       n_replicas=N) as svc:
            assert svc.replica_ids == ('r0', 'r1', 'r2', 'r3')
            assert svc.warmup() == (1, 2, 4)
            warm = svc.compiled_shapes
            futs = [svc.rate(f, home_team_id=HOME) for f in frames]
            got = [fut.result(timeout=WAIT) for fut in futs]
            for r, out in zip(ref, got):
                assert out.index.equals(r.index)
                np.testing.assert_array_equal(out.to_numpy(), r.to_numpy())
            futs = [svc.rate(f, home_team_id=HOME) for f in frames]
            for fut in futs:
                fut.result(timeout=WAIT)
            shapes[pkg] = (warm, svc.compiled_shapes)
            health[pkg] = svc.health()
        outs[pkg] = [o.to_numpy() for o in got]
    assert shapes['port'] == shapes['jax'] == (3 * N, 3 * N)
    for got, want in zip(outs['port'], outs['jax']):
        np.testing.assert_allclose(got, want, rtol=0, atol=ATOL)
    port, jax = health['port'], health['jax']
    assert set(port) == set(jax)
    assert port['replicas'] == jax['replicas']
    assert port['replicas']['n'] == N and port['replicas']['sick'] == []
    assert port['status'] == jax['status'] == 'ok'


def test_coalesced_takes_on_lanes_match_the_one_lane_service(models):
    """Requests that coalesce into flushes of several games on whatever
    lane takes them come back bitwise as the one-lane service rates them
    (the CPU's kernels give a valid row the same bits at any bucket)."""
    frames = _request_frames(12, rng_seed=11, lo=40, hi=A)
    with RatingService(models['port'], max_actions=A, max_batch_size=4,
                       max_wait_ms=600_000.0) as svc1:
        futs = [svc1.rate(f, home_team_id=HOME) for f in frames]
        svc1.close()
        ref = [f.result(timeout=WAIT).to_numpy() for f in futs]
    with RatingService(models['port'], max_actions=A, max_batch_size=4, max_wait_ms=600_000.0,
                       n_replicas=N) as svc:
        takes = []
        real = svc._batcher._runner

        def runner(payloads, bucket, *, lane=0):
            takes.append((len(payloads), lane))
            return real(payloads, bucket, lane=lane)

        svc._batcher._runner = runner
        futs = [svc.rate(f, home_team_id=HOME) for f in frames]
        got = [f.result(timeout=WAIT).to_numpy() for f in futs]
    assert sum(n for n, _ in takes) == len(frames) and max(n for n, _ in takes) == 4
    for g, r in zip(got, ref):
        np.testing.assert_array_equal(g, r)


def test_scenario_flushes_on_lanes_match_the_one_lane_service(models):
    """A scenario request (a field-update grid, and a custom grid of dense
    overrides, which the lane dispatch carries on the lane's own device)
    on a four-lane service: bitwise the one-lane service's, and within
    1e-5 of the JAX four-lane service's."""
    frame = _frame(61, 180)
    width = models['port']._dense_override_widths()['time_delta']
    grids = {
        'end_location': (end_location_grid(3, 2), None),
        'custom': (custom_grid(dense_overrides={'time_delta': np.random.default_rng(6).normal(
            0, 5, size=(3, 1, A, width)).astype(np.float32)}), 'time_delta'),
    }
    from socceraction_tpu.scenario.grid import custom_grid as jax_custom_grid
    from socceraction_tpu.scenario.grid import end_location_grid as jax_end_location_grid

    jax_grids = {
        'end_location': jax_end_location_grid(3, 2),
        'custom': jax_custom_grid(dense_overrides={
            'time_delta': grids['custom'][0].dense_overrides['time_delta']}),
    }
    with RatingService(models['port'], max_actions=A, max_batch_size=2) as svc1:
        ref = {k: svc1.rate_scenarios_sync(frame, g, home_team_id=HOME, timeout=WAIT)
               for k, (g, _) in grids.items()}
    with RatingService(models['port'], max_actions=A, max_batch_size=2, n_replicas=N) as svc:
        got = {k: svc.rate_scenarios_sync(frame, g, home_team_id=HOME, timeout=WAIT)
               for k, (g, _) in grids.items()}
    with PKGS['jax'].Service(models['jax'], max_actions=A, max_batch_size=2,
                             n_replicas=N) as jsvc:
        jgot = {k: jsvc.rate_scenarios_sync(frame, g, home_team_id=HOME, timeout=WAIT)
                for k, g in jax_grids.items()}
    for k in grids:
        assert got[k].shape == ref[k].shape == (grids[k][0].n_perturbations, len(frame), 3)
        np.testing.assert_array_equal(got[k], ref[k])
        np.testing.assert_allclose(got[k], np.asarray(jgot[k]), rtol=0, atol=ATOL)


# -- topology -------------------------------------------------------------------------------


def test_lane_breaker_topology(models):
    """``n_replicas > 1`` builds one breaker per lane, named
    ``serve.dispatch.r{i}``; a shared instance is refused with the JAX
    package's error; ``breaker_failures=0`` disables every lane's."""
    out = {}
    for pkg, p in PKGS.items():
        breaker_cls = CircuitBreaker if pkg == 'port' else JaxBreaker
        refused = _try(p.Service, models[pkg], max_actions=A, n_replicas=2,
                       breaker=breaker_cls(failure_threshold=2, name='serve.dispatch'))
        with p.Service(models[pkg], max_actions=A, max_batch_size=2, n_replicas=N) as svc:
            names = [b.name for b in svc.breakers]
            first = svc.breaker is svc.breakers[0]
        with p.Service(models[pkg], max_actions=A, max_batch_size=2, n_replicas=2,
                       breaker_failures=0) as svc:
            disabled = svc.breakers
        out[pkg] = (refused, names, first, disabled)
    assert out['port'] == out['jax']
    assert out['port'][0][0] == 'ValueError' and 'per-replica' in out['port'][0][1]
    assert out['port'][1] == [f'serve.dispatch.r{i}' for i in range(N)]
    assert out['port'][3] == (None, None)


def test_lanes_share_the_models_weights_on_its_device(models):
    """Lanes on the model's own device alias the model's fold and heads:
    one copy of the weights however many lanes; each lane on the CPU has
    no stream."""
    model = models['port']
    with RatingService(model, max_actions=A, max_batch_size=2, n_replicas=N) as svc:
        dispatcher = svc._dispatcher_for(model)
        prep = model._prepared_pair()
        heads = [h.module for h in model._heads()]
        assert svc._lane_devices == (torch.device('cpu'),) * N
        assert svc._lane_streams == [None] * N
        for lane_prep, mod_a, mod_b in dispatcher._lanes:
            assert lane_prep.tables.data is prep.tables.data
            assert lane_prep.w_dense.data is prep.w_dense.data
            assert lane_prep.bias is prep.bias
            assert [mod_a, mod_b] == heads
        assert svc._dispatcher_for(model) is dispatcher


def test_lanes_sit_on_cards_by_index(monkeypatch):
    """Lane ``i`` sits on card ``i`` modulo the process's cards: four lanes
    on one card share it, on four cards each has its own."""
    for count, want in ((1, [0, 0, 0, 0]), (2, [0, 1, 0, 1]), (4, [0, 1, 2, 3])):
        monkeypatch.setattr(torch.cuda, 'device_count', lambda count=count: count)
        devices = serve_service._lane_devices(torch.device('cuda', 0), N)
        assert [d.index for d in devices] == want
        assert {d.type for d in devices} == {'cuda'}
    assert serve_service._lane_devices(torch.device('cpu'), 3) == (torch.device('cpu'),) * 3


def test_lanes_refuse_a_model_off_the_fused_path(models, monkeypatch):
    """A lane serves the fused dispatch only: a model that rates through
    the materialized path is refused when the service is built, as in the
    JAX package."""
    monkeypatch.setenv('SOCCERACTION_TPU_RATING_PATH', 'materialized')
    out = {pkg: _try(p.Service, models[pkg], max_actions=A, n_replicas=2)
           for pkg, p in PKGS.items()}
    assert out['port'][0] == out['jax'][0] == 'ValueError'
    assert 'fused dispatch path only' in out['port'][1]


# -- swaps ----------------------------------------------------------------------------------


def _swap_on_lanes(pkg, models, models_b, root):
    """v1 and v2 published; a fault on lane 1's first warm call aborts the
    swap; after it clears the swap lands on every lane and rolls back."""
    p = PKGS[pkg]
    plan_cls, spec_cls = (FaultPlan, FaultSpec) if pkg == 'port' else (JaxFaultPlan, JaxFaultSpec)
    reg = p.registry(str(root / pkg))
    reg.publish('vaep', '1', models[pkg])
    reg.publish('vaep', '2', models_b[pkg])
    reg.activate('vaep', '1')
    frame = _frame(90, 150)
    ref_a = _reference(pkg, models[pkg], frame)
    ref_b = _reference(pkg, models_b[pkg], frame)
    assert not np.array_equal(ref_a, ref_b)
    with p.Service(registry=reg, max_actions=A, max_batch_size=4, max_wait_ms=1.0,
                   n_replicas=N) as svc:
        svc.warmup()
        # lane 0 takes the warm calls 1..len(ladder), lane 1 the next
        k = len(svc.ladder) + 2
        plan = plan_cls(seed=0, specs=[spec_cls('serve.dispatch', error=RuntimeError,
                                                on_calls=(k,))])
        with plan:
            failed = _try(svc.swap_model, 'vaep', '2')
        points = [h['point'] for h in plan.history]
        during = [svc.rate_sync(frame, home_team_id=HOME, timeout=WAIT).to_numpy()
                  for _ in range(N)]
        health = svc.health()
        swapped = svc.swap_model('vaep', '2')
        after = svc.rate_sync(frame, home_team_id=HOME, timeout=WAIT).to_numpy()
        back = svc.rollback_model()
        rolled = svc.rate_sync(frame, home_team_id=HOME, timeout=WAIT).to_numpy()
    for v in during + [rolled]:
        np.testing.assert_array_equal(v, ref_a)
    np.testing.assert_array_equal(after, ref_b)
    return (failed[0], points, health['model']['version'], health['status'], swapped, back), after


def test_swap_aborts_on_every_lane_when_a_later_lane_fails_to_warm(tmp_path, models, models_b):
    """Every lane warms before any serves the target: a fault in lane 1's
    warm (lane 0 already warm) aborts the swap everywhere, every request
    still serves v1 bitwise, and once the fault clears the same swap lands
    on every lane and rolls back; as in the JAX package."""
    out, after = {}, {}
    for pkg in PKGS:
        out[pkg], after[pkg] = _swap_on_lanes(pkg, models, models_b, tmp_path)
    assert out['port'] == out['jax']
    assert out['port'] == ('RuntimeError', ['serve.dispatch'], '1', 'ok', ('vaep', '2'),
                           ('vaep', '1'))
    np.testing.assert_allclose(after['port'], after['jax'], rtol=0, atol=ATOL)


# -- degradation ----------------------------------------------------------------------------


def test_single_sick_lane_degrades_alone(models):
    """One lane's open breaker degrades that lane alone onto the
    materialized fallback: the other lanes stay fused, every caller gets
    correct values, and ``health()['replicas']`` names the sick lane key
    for key as the JAX service does."""
    sick, rid = 2, 'r2'
    frames = _request_frames(4, rng_seed=80, lo=80, hi=120)
    out = {}
    for pkg, p in PKGS.items():
        expected = [_reference(pkg, models[pkg], f) for f in frames]
        before = p.metrics.snapshot()
        with p.Service(models[pkg], max_actions=A, max_batch_size=2, max_wait_ms=1.0,
                       n_replicas=N, breaker_failures=2, breaker_recovery_s=1000.0) as svc:
            svc.warmup()
            svc.breakers[sick].record_failure(RuntimeError('induced device fault'))
            svc.breakers[sick].record_failure(RuntimeError('induced device fault'))
            health = svc.health()
            served = False
            deadline = time.monotonic() + 60.0
            while not served and time.monotonic() < deadline:
                futs = [svc.rate(f, home_team_id=HOME) for f in frames]
                for fut, exp in zip(futs, expected):
                    np.testing.assert_allclose(fut.result(timeout=WAIT).to_numpy(), exp,
                                               rtol=0, atol=1e-4)
                served = _fallbacks(p, rid) > before.value('serve/fallback_flushes', replica=rid)
            assert served, f'{pkg}: the sick lane never took a flush in 60 s'
            others = {r: _fallbacks(p, r) - before.value('serve/fallback_flushes', replica=r)
                      for r in svc.replica_ids if r != rid}
            state = svc.breakers[sick].state
        replicas = health['replicas']
        for entry in replicas['per_replica'].values():
            entry['breaker'].pop('open_for_s')  # a clock reading
        out[pkg] = (health['status'], replicas, others, state)
    assert out['port'] == out['jax']
    assert out['port'][0] == 'degraded' and out['port'][1]['sick'] == [rid]
    assert set(out['port'][2].values()) == {0.0} and out['port'][3] == 'open'


def _lane_payloads(svc, frames):
    """Host payloads of ``frames`` as ``rate`` packs them."""
    from socceraction_tpu_torch.core.batch import pack_actions

    out = []
    for f in frames:
        staging, _ = pack_actions(f, home_team_id=HOME, max_actions=A, as_numpy=True)
        gs = svc._frame_goalscore(f, HOME) if svc._gs_enabled else None
        out.append(serve_service._Payload(staging, gs, keep=(0, len(f))))
    return out


def test_kernel_error_on_one_lane_is_never_degraded(models, monkeypatch):
    """B1 cannot run on lane 2 (its dispatch raises ``KernelError``): that
    lane's flush fails with it, its breaker does not move and no fallback
    flush is counted; the other lanes serve fused, and lane 2 serves again
    once the kernel runs. The JAX service would serve the flush through
    the reference."""
    model = models['port']
    frames = _request_frames(2, rng_seed=3, lo=60, hi=120)
    with RatingService(model, max_actions=A, max_batch_size=2, max_wait_ms=1.0,
                       n_replicas=N, breaker_failures=1) as svc:
        svc.warmup()
        dispatcher = svc._dispatcher_for(model)
        real = dispatcher.dispatch
        calls = []

        def dispatch(replica, batch, overrides=None):
            calls.append(replica)
            if replica == 2:
                raise KernelError('gather_matmul kernel launch failed: cudaError_t 700')
            return real(replica, batch, overrides)

        monkeypatch.setattr(dispatcher, 'dispatch', dispatch)
        before = REGISTRY.snapshot()
        breakers = [b.to_dict() for b in svc.breakers]
        payloads = _lane_payloads(svc, frames)
        with pytest.raises(KernelError, match='cudaError_t 700'):
            svc._flush(payloads, 2, lane=2)
        # the same take on the other lanes: served fused
        for lane in (0, 1, 3):
            got = svc._flush(payloads, 2, lane=lane)
            for f, v in zip(frames, got):
                np.testing.assert_array_equal(v, _reference('port', model, f))
        # through the batcher: whichever lane takes a request, a failure
        # is the kernel's own and nothing degrades
        futs = [svc.rate(f, home_team_id=HOME) for f in frames * 8]
        outcomes = [_try(f.result, timeout=WAIT) for f in futs]
        failed = {o[0] for o in outcomes if o[0] != 'ok'}
        assert failed <= {'KernelError'}
        assert [b.to_dict() for b in svc.breakers] == breakers
        after = REGISTRY.snapshot()
        for rid in svc.replica_ids:
            assert after.value('serve/fallback_flushes', replica=rid) == \
                before.value('serve/fallback_flushes', replica=rid)
        assert svc.health()['status'] == 'ok'
        monkeypatch.undo()
        served = svc._flush(payloads, 2, lane=2)
    for f, v in zip(frames, served):
        np.testing.assert_array_equal(v, _reference('port', model, f))
    assert calls[0] == 2


def test_lane_series_carry_the_replica_label(models):
    """Every serve-area series of a lane takes ``replica=``: shape traces
    at warm-up, flushes, and the flush segments."""
    with RatingService(models['port'], max_actions=A, max_batch_size=2, max_wait_ms=1.0,
                       n_replicas=2) as svc:
        svc.warmup()
        svc.rate_sync(_frame(64, 90), home_team_id=HOME, timeout=WAIT)
    snap = REGISTRY.snapshot()
    for rid in ('r0', 'r1'):
        assert snap.series('serve/shape_traces', bucket='1', replica=rid) is not None
    segments = snap.get('serve/segment_seconds')
    labelled = {s.labels.get('replica') for s in segments.series
                if s.labels.get('segment') == 'dispatch'}
    assert labelled & {'r0', 'r1'}


def test_parity_probe_samples_every_lanes_flushes(models):
    """A probe on a four-lane service sees every fused flush of every lane,
    each within the f32 band of the reference."""
    probe = ParityProbe(sample_rate=1.0, max_abs_err=1e-5, queue_size=64)
    frames = _request_frames(8, rng_seed=21, lo=60, hi=160)
    with RatingService(models['port'], max_actions=A, max_batch_size=2, max_wait_ms=1.0,
                       n_replicas=N, parity=probe) as svc:
        flushes = []
        real = svc._batcher._runner
        lock = threading.Lock()

        def runner(payloads, bucket, *, lane=0):
            with lock:
                flushes.append(lane)
            return real(payloads, bucket, lane=lane)

        svc._batcher._runner = runner
        for fut in [svc.rate(f, home_team_id=HOME) for f in frames]:
            fut.result(timeout=WAIT)
        assert probe.flush(timeout=WAIT)
        stats = probe.stats()
    assert stats['probes'] == len(flushes) and stats['exceedances'] == 0
    assert stats['max_abs_err'] <= 1e-5


def test_jax_lane_counts_after_warmup_match(models):
    """Warm-up dispatches every rung on every lane in both packages: the
    shape-trace counts by lane agree."""
    counts = {}
    for pkg, p in PKGS.items():
        before = p.metrics.snapshot()
        with p.Service(models[pkg], max_actions=A, max_batch_size=2, n_replicas=2) as svc:
            svc.warmup()
        after = p.metrics.snapshot()
        counts[pkg] = {
            (rid, b): after.value('serve/shape_traces', bucket=b, replica=rid)
            - before.value('serve/shape_traces', bucket=b, replica=rid)
            for rid in ('r0', 'r1') for b in ('1', '2')
        }
    assert counts['port'] == counts['jax'] == {k: 1.0 for k in counts['port']}

