"""The port's rating service under faults, against the JAX package's.

- ``tests/test_chaos.py``'s two breaker-in-serving cases run through both
  packages: injected ``serve.dispatch`` failures are served through the
  materialized reference, trip the breaker, degrade ``health()`` and
  recover through one half-open probe; with ``breaker_failures=0`` a
  failure fails its flush's futures. States, health, counter deltas and
  fault histories are equal; values within 1e-4 of each package's own
  reference (the JAX test's bound) and within 1e-5 across packages.
- The kernel's own failures are never degraded: a ``KernelError`` (or a
  CUDA error, or B1's refusal of the model's widths) raised from B1's
  wrapper (patched: on the CPU the wrapper runs its plain version) fails
  the flush's futures and leaves the
  breaker, ``serve/fallback_flushes`` and ``health()`` as they were, as
  the JAX service does for a failed flush with ``breaker_failures=0``.
  So does an ``OSError`` from the CUDA side of the real wrapper (its
  operands moved off the CPU), which the wrapper raises as a
  ``KernelError``. ``warmup()`` raises it before any traffic, and a model
  B1 refuses raises there too. The same errors injected at
  ``serve.dispatch`` degrade in both packages alike.
- The flusher's death fails fast, dumps a bundle and reads
  ``flusher-dead`` in both packages (``tests/test_obs_runtime.py``).
- The learning loop with a service (``ContinuousLearner(service=...)``):
  a promotion swaps the service's active version, ``rollback`` goes
  through ``service.rollback_model()``, and the served values follow the
  version, in both packages.
- The fleet plane reads the service: the wire document of the registry a
  port service served into, its breaker left open, gives the same
  ``request_p99_s`` and ``breaker_state`` rows in both packages'
  aggregators.
"""

import json
import os
import tarfile
import time
from types import SimpleNamespace

import numpy as np
import pytest

from socceraction_tpu.core.batch import pack_actions as jax_pack_actions
from socceraction_tpu.core.batch import unpack_values as jax_unpack_values
from socceraction_tpu.core.synthetic import (
    append_synthetic_games,
    synthetic_actions_frame,
    write_synthetic_season,
)
from socceraction_tpu.learn import ContinuousLearner as JaxLearner
from socceraction_tpu.learn import GateConfig as JaxGate
from socceraction_tpu.learn import LearnConfig as JaxConfig
from socceraction_tpu.obs import REGISTRY as JAX_REGISTRY
from socceraction_tpu.obs import fleet as jfleet
from socceraction_tpu.obs import metrics as jmetrics
from socceraction_tpu.pipeline.store import SeasonStore as JaxStore
from socceraction_tpu.resil import CircuitBreaker as JaxBreaker
from socceraction_tpu.resil import FaultPlan as JaxFaultPlan
from socceraction_tpu.resil import FaultSpec as JaxFaultSpec
from socceraction_tpu.serve import ModelRegistry as JaxRegistry
from socceraction_tpu.serve import RatingService as JaxService
from socceraction_tpu.vaep.base import load_model as jax_load_model
from socceraction_tpu_torch.core.batch import pack_actions, unpack_values
from socceraction_tpu_torch.core.synthetic import synthetic_batch
from socceraction_tpu_torch.learn import ContinuousLearner, GateConfig, LearnConfig
from socceraction_tpu_torch.obs import REGISTRY, drain_guards
from socceraction_tpu_torch.obs import fleet as tfleet
from socceraction_tpu_torch.obs import metrics as tmetrics
from socceraction_tpu_torch.obs import wire as twire
from socceraction_tpu_torch.ops import fused as fused_ops
from socceraction_tpu_torch.ops.cuda_build import KernelError, KernelRefused
from socceraction_tpu_torch.pipeline.store import SeasonStore
from socceraction_tpu_torch.resil import CircuitBreaker, FaultPlan, FaultSpec
from socceraction_tpu_torch.serve import ModelRegistry, RatingService
from socceraction_tpu_torch.vaep.base import VAEP, load_model

HOME = 100
A = 256
#: the port's served values against the JAX package's (same weights, f32)
ATOL = 1e-5
#: a degraded flush against the package's own fused reference
#: (``tests/test_chaos.py``'s bound: the materialized path sums otherwise)
FALLBACK_ATOL = 1e-4
WAIT = 60.0

PKGS = {
    'jax': SimpleNamespace(
        Service=JaxService, Breaker=JaxBreaker, FaultPlan=JaxFaultPlan, FaultSpec=JaxFaultSpec,
        metrics=JAX_REGISTRY, registry=JaxRegistry, Learner=JaxLearner, Config=JaxConfig,
        Gate=JaxGate, Store=JaxStore,
    ),
    'port': SimpleNamespace(
        Service=RatingService, Breaker=CircuitBreaker, FaultPlan=FaultPlan, FaultSpec=FaultSpec,
        metrics=REGISTRY, registry=lambda root: ModelRegistry(root, device='cpu'),
        Learner=ContinuousLearner, Config=LearnConfig, Gate=GateConfig, Store=SeasonStore,
    ),
}


@pytest.fixture(scope='module', autouse=True)
def _drain_guards():
    """Leave the process-wide guard ring empty for the next module."""
    yield
    drain_guards()


@pytest.fixture(scope='module')
def v1_checkpoint(tmp_path_factory):
    path = str(tmp_path_factory.mktemp('v1'))
    VAEP(device='cpu').fit_packed(
        synthetic_batch(2, 256, seed=3, device='cpu'),
        tree_params={'hidden': (16,), 'batch_size': 256, 'max_epochs': 2}, random_state=0,
    ).save_model(path)
    return path


@pytest.fixture(scope='module')
def models(v1_checkpoint):
    """The same weights in both packages."""
    return {'port': load_model(v1_checkpoint, device='cpu'),
            'jax': jax_load_model(v1_checkpoint)}


def _frame(i, n):
    return synthetic_actions_frame(game_id=i, home_team_id=HOME, seed=i, n_actions=n)


def _reference(pkg, model, frame, max_actions=A):
    if pkg == 'jax':
        batch, _ = jax_pack_actions(frame, home_team_id=HOME, max_actions=max_actions)
        return np.asarray(jax_unpack_values(model.rate_batch(batch, bucket=False), batch))
    batch, _ = pack_actions(frame, home_team_id=HOME, max_actions=max_actions, device='cpu')
    return unpack_values(model.rate_batch(batch, bucket=False), batch)


def _value(p, name, **labels):
    return p.metrics.snapshot().value(name, **labels)


def _outcome(fut):
    try:
        return ('ok', fut.result(timeout=WAIT))
    except Exception as e:  # the outcome under comparison
        return (type(e).__name__, str(e))


def _breaker_view(svc):
    d = svc.breaker.to_dict()
    return (d['state'], d['consecutive_failures'], d['trips'], d['last_error'])


# -- tests/test_chaos.py through both packages -------------------------------------------


def _trip_degrade_recover(pkg, model, frame):
    p = PKGS[pkg]
    clock = {'t': 0.0}
    before = _value(p, 'serve/fallback_flushes')
    outs, seen = [], []
    with p.Service(model, max_actions=A, max_batch_size=2, max_wait_ms=1.0,
                   breaker=p.Breaker(failure_threshold=2, recovery_time_s=1000.0,
                                     name='serve.dispatch', clock=lambda: clock['t'])) as svc:
        plan = p.FaultPlan(seed=5, specs=[
            p.FaultSpec('serve.dispatch', error=RuntimeError, on_calls=(1, 2))])
        with plan:
            for step in range(4):
                if step == 3:
                    clock['t'] += 2000.0  # past the dwell: the next flush probes
                outs.append(svc.rate_sync(frame, home_team_id=HOME, timeout=WAIT).to_numpy())
                health = svc.health()
                seen.append((_breaker_view(svc), health['status'], health['breaker']['state']))
        history = [h['point'] for h in plan.history]
    state = p.metrics.snapshot().value('resil/breaker_state', stat='last')
    return outs, (seen, history, _value(p, 'serve/fallback_flushes') - before, state)


def test_breaker_trips_degrades_and_recovers_as_in_jax(models):
    frame = _frame(40, 80)
    runs = {pkg: _trip_degrade_recover(pkg, models[pkg], frame) for pkg in PKGS}
    assert runs['port'][1] == runs['jax'][1]
    seen, history, fallbacks, state = runs['port'][1]
    assert [s[1] for s in seen] == ['ok', 'degraded', 'degraded', 'ok']
    assert [s[0][0] for s in seen] == ['closed', 'open', 'open', 'closed']
    assert history == ['serve.dispatch'] * 2 and fallbacks == 3 and state == 0
    for pkg, (outs, _) in runs.items():
        ref = _reference(pkg, models[pkg], frame)
        for out in outs:
            np.testing.assert_allclose(out, ref, rtol=0, atol=FALLBACK_ATOL)
    for got, want in zip(runs['port'][0], runs['jax'][0]):
        np.testing.assert_allclose(got, want, rtol=0, atol=ATOL)


def test_breaker_disabled_failures_fail_futures_as_in_jax(models):
    frame = _frame(41, 60)
    out = {}
    for pkg, p in PKGS.items():
        with p.Service(models[pkg], max_actions=A, max_batch_size=2, max_wait_ms=1.0,
                       breaker_failures=0) as svc:
            assert svc.breaker is None
            with p.FaultPlan(seed=0, specs=[p.FaultSpec('serve.dispatch', error=RuntimeError,
                                                        nth=1)]):
                failed = _outcome(svc.rate(frame, home_team_id=HOME))
            after = svc.rate_sync(frame, home_team_id=HOME, timeout=WAIT)
            out[pkg] = (failed[0], 'injected fault' in failed[1], len(after),
                        svc.health()['status'])
    assert out['port'] == out['jax'] == ('RuntimeError', True, len(frame), 'ok')


# -- the kernel's own failures are never degraded ----------------------------------------


def _b1_raising(error):
    def wrapper(*args, **kwargs):
        raise error

    return wrapper


@pytest.mark.parametrize('error', ['KernelError', 'KernelRefused', 'AcceleratorError'])
def test_kernel_failure_fails_the_flush_and_never_moves_the_breaker(models, monkeypatch, error):
    """B1 cannot run: the flush's futures fail with its error, nothing is
    served through the reference, the breaker and ``health()`` stay as they
    were — as the JAX service treats a failed flush with
    ``breaker_failures=0``; once B1 runs again the next request is served
    fused."""
    import torch

    exc = {
        'KernelError': lambda: KernelError('gather_matmul kernel launch failed: cudaError_t 700'),
        'KernelRefused': lambda: KernelRefused('a launch ... over the 232448 a block can use'),
        'AcceleratorError': lambda: torch.AcceleratorError('CUDA error: illegal address'),
    }[error]()
    frame = _frame(42, 70)
    with RatingService(models['port'], max_actions=A, max_batch_size=2,
                       max_wait_ms=1.0) as svc:
        svc.rate_sync(frame, home_team_id=HOME, timeout=WAIT)
        breaker = svc.breaker.to_dict()
        fallbacks = _value(PKGS['port'], 'serve/fallback_flushes')
        with monkeypatch.context() as m:
            m.setattr(fused_ops, 'fused_first_layer_quant', _b1_raising(exc))
            fut = svc.rate(frame, home_team_id=HOME)
            with pytest.raises(type(exc), match='kernel launch failed|illegal address|block can use'):
                fut.result(timeout=WAIT)
            port_health = svc.health()
        assert svc.breaker.to_dict() == breaker
        assert _value(PKGS['port'], 'serve/fallback_flushes') == fallbacks
        served = svc.rate_sync(frame, home_team_id=HOME, timeout=WAIT).to_numpy()
        assert svc.breaker.to_dict() == breaker
    np.testing.assert_array_equal(served, _reference('port', models['port'], frame))
    # the JAX service's failed flush with breaker_failures=0 reads the same
    with JaxService(models['jax'], max_actions=A, max_batch_size=2, max_wait_ms=1.0,
                    breaker_failures=0) as jsvc:
        with JaxFaultPlan(seed=0, specs=[JaxFaultSpec('serve.dispatch', error=RuntimeError,
                                                      nth=1)]):
            assert _outcome(jsvc.rate(frame, home_team_id=HOME))[0] == 'RuntimeError'
        jax_health = jsvc.health()
    for key in ('status', 'flusher_alive', 'flusher_error', 'queue_depth', 'numerics'):
        assert port_health[key] == jax_health[key], key
    assert port_health['status'] == 'ok' and port_health['breaker']['state'] == 'closed'


def test_b1_oserror_fails_the_flush_and_never_moves_the_breaker(models, monkeypatch):
    """An ``OSError`` on the CUDA side of B1's wrapper (a library that does
    not load) reaches the service as a ``KernelError``: the flush's future
    fails with it, nothing is served through the reference, the breaker
    and ``serve/fallback_flushes`` are untouched. The real wrapper runs;
    its operands go to the meta device, so it takes its CUDA side here."""
    from socceraction_tpu_torch.ops import gather_matmul as gm

    real = gm.fused_first_layer_quant
    frame = _frame(45, 70)
    with RatingService(models['port'], max_actions=A, max_batch_size=2,
                       max_wait_ms=1.0) as svc:
        svc.rate_sync(frame, home_team_id=HOME, timeout=WAIT)
        breaker = svc.breaker.to_dict()
        fallbacks = _value(PKGS['port'], 'serve/fallback_flushes')
        with monkeypatch.context() as m:
            m.setattr(gm, '_forward_cuda', _b1_raising(
                OSError('libgather_matmul.so: cannot open shared object file')))
            m.setattr(fused_ops, 'fused_first_layer_quant',
                      lambda *ops: real(*(t.to('meta') for t in ops)))
            with pytest.raises(KernelError, match='gather_matmul cannot run: OSError') as info:
                svc.rate_sync(frame, home_team_id=HOME, timeout=WAIT)
        assert isinstance(info.value.__cause__, OSError)
        assert svc.breaker.to_dict() == breaker
        assert _value(PKGS['port'], 'serve/fallback_flushes') == fallbacks
        assert svc.health()['status'] == 'ok'


@pytest.mark.parametrize('error', [RuntimeError, ValueError, OSError])
def test_plain_error_at_dispatch_degrades_as_in_jax(models, error):
    """An error the same as B1's own, injected at ``serve.dispatch`` instead
    of raised by the kernel, degrades exactly as the JAX service degrades
    it: served through the reference, the breaker open, one fallback."""
    frame = _frame(43, 70)
    seen = {}
    for pkg, p in PKGS.items():
        before = _value(p, 'serve/fallback_flushes')
        with p.Service(models[pkg], max_actions=A, max_batch_size=2, max_wait_ms=1.0,
                       breaker_failures=1, breaker_recovery_s=1000.0) as svc:
            with p.FaultPlan(seed=0, specs=[p.FaultSpec('serve.dispatch', error=error, nth=1)]):
                out = svc.rate_sync(frame, home_team_id=HOME, timeout=WAIT).to_numpy()
            health = svc.health()
            seen[pkg] = (health['status'], health['breaker']['state'],
                         health['breaker']['trips'], _value(p, 'serve/fallback_flushes') - before)
        np.testing.assert_allclose(out, _reference(pkg, models[pkg], frame), rtol=0,
                                   atol=FALLBACK_ATOL)
    assert seen['port'] == seen['jax'] == ('degraded', 'open', 1, 1)


def test_kernel_failure_in_a_half_open_probe_frees_the_probe(models, monkeypatch):
    """The probe flush hits B1's failure: the request fails, the breaker
    stays half-open with its probe slot free, and once B1 runs again the
    next flush is the probe that closes it."""
    frame = _frame(44, 60)
    clock = {'t': 0.0}
    breaker = CircuitBreaker(failure_threshold=1, recovery_time_s=10.0, clock=lambda: clock['t'])
    with RatingService(models['port'], max_actions=A, max_batch_size=2, max_wait_ms=1.0,
                       breaker=breaker) as svc:
        with FaultPlan(seed=0, specs=[FaultSpec('serve.dispatch', error=RuntimeError, nth=1)]):
            svc.rate_sync(frame, home_team_id=HOME, timeout=WAIT)
        assert breaker.state == 'open'
        clock['t'] = 20.0
        fallbacks = _value(PKGS['port'], 'serve/fallback_flushes')
        with monkeypatch.context() as m:
            m.setattr(fused_ops, 'fused_first_layer_quant', _b1_raising(KernelError('no toolkit')))
            with pytest.raises(KernelError):
                svc.rate_sync(frame, home_team_id=HOME, timeout=WAIT)
        assert (breaker.state, breaker.trips) == ('half_open', 1)
        assert _value(PKGS['port'], 'serve/fallback_flushes') == fallbacks
        out = svc.rate_sync(frame, home_team_id=HOME, timeout=WAIT).to_numpy()
        assert breaker.state == 'closed' and svc.health()['status'] == 'ok'
    np.testing.assert_array_equal(out, _reference('port', models['port'], frame))


@pytest.mark.parametrize('exc', [
    KernelError('nvcc failed to build gather_matmul.cu (exit 1)'),
    KernelRefused('a launch for D = 4096 dense columns and k = 3 tables needs 300000 bytes of '
                  'shared memory per block, over the 232448 a block can use'),
])
def test_warmup_raises_what_b1_cannot_run(models, monkeypatch, exc):
    """``warmup()`` dispatches every rung past the breaker: a B1 that cannot
    build or launch, or a model whose widths B1 refuses, raises out of it
    before any traffic, with the breaker untouched."""
    with RatingService(models['port'], max_actions=A, max_batch_size=2) as svc:
        breaker = svc.breaker.to_dict()
        with monkeypatch.context() as m:
            m.setattr(fused_ops, 'fused_first_layer_quant', _b1_raising(exc))
            with pytest.raises(type(exc), match=str(exc)[:20]):
                svc.warmup()
        assert svc.breaker.to_dict() == breaker
        assert svc.warmup() == (1, 2)


def _bundle_reason(path):
    with tarfile.open(path) as tar:
        member = next(m for m in tar.getmembers() if m.name.endswith('manifest.json'))
        return json.load(tar.extractfile(member))['reason']


def test_flusher_death_fails_fast_dumps_and_degrades_health(models, tmp_path):
    frame = _frame(45, 60)
    out = {}
    for pkg, p in PKGS.items():
        with p.Service(models[pkg], max_actions=A, max_batch_size=4, max_wait_ms=50.0,
                       debug_dir=str(tmp_path / pkg), dump_interval_s=0.0) as svc:
            def dies():
                raise RuntimeError('injected death')

            svc._batcher._take = dies
            failed = _outcome(svc.rate(frame, home_team_id=HOME))
            deadline = time.monotonic() + WAIT  # the crash hook dumps after the futures fail
            while svc.last_dump_path is None and time.monotonic() < deadline:
                time.sleep(0.01)
            health = svc.health()
            later = None
            try:
                svc.rate(frame, home_team_id=HOME)
            except RuntimeError as e:
                later = 'flusher thread died' in str(e)
            out[pkg] = (failed[0], 'flusher thread died' in failed[1], health['status'],
                        'injected death' in health['flusher_error'],
                        health['last_dump'] == svc.last_dump_path, later,
                        _bundle_reason(svc.last_dump_path))
    assert out['port'] == out['jax'] == ('RuntimeError', True, 'flusher-dead', True, True, True,
                                         'flusher_crash')


# -- the learning loop through the service ------------------------------------------------


def _learn_with_service(pkg, root, v1):
    p = PKGS[pkg]
    store_path = os.path.join(root, 'season')
    write_synthetic_season(store_path, n_games=2, n_actions=64)
    registry = p.registry(os.path.join(root, 'registry'))
    registry.publish('vaep', '1', jax_load_model(v1) if pkg == 'jax' else load_model(v1, device='cpu'))
    registry.activate('vaep', '1')
    cfg = p.Config(
        model_name='vaep', max_actions=64, games_per_batch=2, fallback_replay_games=2,
        random_state=0, debug_dir=os.path.join(root, 'debug'),
        train_params={'hidden': (16,), 'max_epochs': 1, 'batch_size': 256},
        gate=p.Gate(n_boot=8, max_ece_regression=1.0, max_brier_regression=1.0),
    )
    frame = _frame(46, 60)
    swaps = (_value(p, 'serve/model_swaps'), _value(p, 'serve/model_swaps', reason='rollback'))
    with p.Store(store_path, mode='a') as store, p.Service(
            registry=registry, max_actions=64, max_batch_size=1, max_wait_ms=1.0) as svc:
        learner = p.Learner(store, registry, service=svc, config=cfg)
        served = [svc.rate_sync(frame, home_team_id=HOME, timeout=WAIT).to_numpy()]
        append_synthetic_games(store_path, 2, n_actions=64, seed=50)
        report = learner.run_once()
        active = registry.active()[:2]
        served.append(svc.rate_sync(frame, home_team_id=HOME, timeout=WAIT).to_numpy())
        rolled = learner.rollback()
        served.append(svc.rate_sync(frame, home_team_id=HOME, timeout=WAIT).to_numpy())
        shapes = svc.compiled_shapes
    refs = [_reference(pkg, registry.load('vaep', v), frame, max_actions=64) for v in '121']
    for got, want in zip(served, refs):
        np.testing.assert_array_equal(got, want)
    deltas = (_value(p, 'serve/model_swaps') - swaps[0],
              _value(p, 'serve/model_swaps', reason='rollback') - swaps[1])
    return (report.verdict, report.candidate_version, active, rolled, registry.active()[:2],
            deltas, shapes), served


def test_learner_promotes_and_rolls_back_through_the_service(tmp_path, v1_checkpoint):
    runs = {}
    for pkg in PKGS:
        root = str(tmp_path / pkg)
        os.makedirs(root)
        runs[pkg] = _learn_with_service(pkg, root, v1_checkpoint)
    assert runs['port'][0] == runs['jax'][0]
    assert runs['port'][0][:5] == ('promoted', '2', ('vaep', '2'), ('vaep', '1'), ('vaep', '1'))
    assert runs['port'][0][5][1] == 1
    served = runs['port'][1]
    assert not np.array_equal(served[0], served[1])  # the promotion moved the values
    np.testing.assert_array_equal(served[2], served[0])
    np.testing.assert_allclose(served[0], runs['jax'][1][0], rtol=0, atol=ATOL)


# -- the fleet plane reads the service ----------------------------------------------------


def test_fleet_rows_from_a_served_registry(models):
    """A port service serves a few requests, its breaker left open by an
    injected fault; both packages' aggregators build the same
    ``request_p99_s`` row and a sick ``breaker_state`` row from the wire
    document of that registry."""
    frame = _frame(47, 80)
    with RatingService(models['port'], max_actions=A, max_batch_size=2, max_wait_ms=1.0,
                       breaker_failures=1, breaker_recovery_s=1e9) as svc:
        for _ in range(3):
            svc.rate_sync(frame, home_team_id=HOME, timeout=WAIT)
        with FaultPlan(seed=0, specs=[FaultSpec('serve.dispatch', error=RuntimeError, nth=1)]):
            svc.rate_sync(frame, home_team_id=HOME, timeout=WAIT)
        assert svc.health()['breaker']['state'] == 'open'
        doc = twire.encode_snapshot(REGISTRY.snapshot(), replica='replica-0',
                                    registry=twire.ReplicaRegistry())
    rows = {}
    for pkg, (fleet, metrics) in {'port': (tfleet, tmetrics), 'jax': (jfleet, jmetrics)}.items():
        agg = fleet.FleetAggregator(registry=metrics.MetricRegistry(), time_fn=lambda: 0.0)
        assert agg.ingest(doc) == 'replica-0'
        rows[pkg] = {r['signal']: r for r in agg.aggregate().divergence}
    assert rows['port'] == rows['jax']
    p99 = rows['port']['request_p99_s']
    assert p99['value'] > 0 and p99['sick'] is False
    assert rows['port']['breaker_state']['value'] == 2.0
    assert rows['port']['breaker_state']['sick'] is True
