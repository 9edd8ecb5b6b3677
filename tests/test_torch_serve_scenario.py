"""The port's serving scenario verb against the JAX package's, on the CPU.

Counterparts of ``tests/test_scenario_serve.py``'s eight service cases
(its two frontend cases wait for the port's frontend). Each case runs the
same frame and grid through both packages' ``RatingService`` on the same
weights (a tiny port model and the JAX package's load of its checkpoint):

- the port's ``rate_scenarios`` against its own looped oracle (one
  ``rate_batch`` a perturbation, carrying the factual goalscore block):
  **bitwise**, the JAX test's bound;
- the two packages' results: within 1e-5 (the same weights, f32 sums in
  another order); errors (type and message), shape counts and
  ``scenario/*`` counter deltas: equal.

Beside them, what the port adds: a scenario flush whose B1 cannot run fails
with ``KernelError`` and is never served through the looped reference, the
breaker left as it was. Coalescing is forced (``close()`` drains one take),
never timed.
"""

import numpy as np
import pandas as pd
import pytest
import torch

from socceraction_tpu.core.synthetic import synthetic_actions_frame
from socceraction_tpu.obs import REGISTRY as JAX_REGISTRY
from socceraction_tpu.obs.context import DeadlineExceeded as JaxDeadlineExceeded
from socceraction_tpu.scenario import action_type_sweep as jax_action_type_sweep
from socceraction_tpu.scenario import custom_grid as jax_custom_grid
from socceraction_tpu.scenario import end_location_grid as jax_end_location_grid
from socceraction_tpu.serve import RatingService as JaxService
from socceraction_tpu.vaep.base import load_model as jax_load_model
from socceraction_tpu_torch.core.batch import pack_actions, unpack_values
from socceraction_tpu_torch.core.synthetic import synthetic_batch
from socceraction_tpu_torch.obs import REGISTRY, drain_guards
from socceraction_tpu_torch.obs.context import DeadlineExceeded
from socceraction_tpu_torch.ops import fused as fused_ops
from socceraction_tpu_torch.ops.cuda_build import KernelError
from socceraction_tpu_torch.scenario import (
    action_type_sweep,
    custom_grid,
    decision_surface,
    end_location_grid,
    rate_scenarios_looped,
)
from socceraction_tpu_torch.serve import RatingService
from socceraction_tpu_torch.vaep.base import VAEP

HOME = 100
A = 256
#: the port's values against the JAX package's (same weights, f32)
ATOL = 1e-5
#: a degraded scenario flush against the fused one (the JAX test's bound)
FALLBACK_ATOL = 1e-4
NEVER_MS = 600_000.0
WAIT = 60.0

PKGS = {
    'jax': dict(Service=JaxService, metrics=JAX_REGISTRY, sweep=jax_action_type_sweep,
                ends=jax_end_location_grid, custom=jax_custom_grid),
    'port': dict(Service=RatingService, metrics=REGISTRY, sweep=action_type_sweep,
                 ends=end_location_grid, custom=custom_grid),
}


@pytest.fixture(scope='module', autouse=True)
def _drain_guards():
    """Leave the process-wide guard ring empty for the next module."""
    yield
    drain_guards()


@pytest.fixture(scope='module')
def models(tmp_path_factory):
    """The same weights in both packages."""
    path = str(tmp_path_factory.mktemp('scn'))
    model = VAEP(device='cpu').fit_packed(
        synthetic_batch(2, 256, seed=3, device='cpu'),
        tree_params={'hidden': (16,), 'batch_size': 256, 'max_epochs': 2}, random_state=0,
    )
    model.save_model(path)
    return {'port': model, 'jax': jax_load_model(path)}


def _frame(n_actions=120, game_id=90):
    return synthetic_actions_frame(game_id=game_id, seed=game_id, n_actions=n_actions)


def _value(pkg, name, **labels):
    return PKGS[pkg]['metrics'].snapshot().value(name, **labels) or 0.0


def _looped_oracle(svc, model, frame, grid):
    """What the port's verb must match bitwise: one ``rate_batch`` a
    perturbation over the request's batch, with the factual goalscore
    block."""
    staging, _ = pack_actions(frame, home_team_id=HOME, max_actions=svc.max_actions, device='cpu')
    gs = torch.from_numpy(svc._frame_goalscore(frame, HOME))
    looped = rate_scenarios_looped(model, staging, grid, dense_overrides={'goalscore': gs},
                                   bucket=False)
    return np.stack([unpack_values(looped[p], staging) for p in range(looped.shape[0])])


def _serve(pkg, models, frame, grid_of, warm_scenarios=None, **kw):
    p = PKGS[pkg]
    with p['Service'](models[pkg], max_actions=A, max_batch_size=4, max_wait_ms=1.0, **kw) as svc:
        svc.warmup(scenario_buckets=warm_scenarios)
        return svc, svc.rate_scenarios_sync(frame, grid_of(p), home_team_id=HOME, timeout=WAIT)


# -- the verb ----------------------------------------------------------------------------


@pytest.mark.parametrize('grid_of', [
    lambda p: p['sweep'](type_ids=[0, 1, 2, 11, 21]),
    lambda p: p['custom'](dense_overrides={
        'time_delta': np.random.default_rng(7).normal(size=(3, 1, A, 2)).astype(np.float32)}),
    lambda p: p['custom'](field_updates={
        'end_x': np.random.default_rng(8).uniform(0, 105, size=(2, 1, A)).astype(np.float32)}),
], ids=['type_sweep', 'dense_override', 'per_action_update'])
def test_rate_scenarios_matches_looped_oracle_bitwise(models, grid_of):
    """The fold equals the port's looped oracle bitwise, and the JAX
    service's within 1e-5: a field sweep, a custom dense-override block (the
    extra-overrides path) and a per-action field rewrite."""
    frame = _frame(120)
    out = {pkg: _serve(pkg, models, frame, grid_of) for pkg in PKGS}
    svc, got = out['port']
    grid = grid_of(PKGS['port'])
    assert got.shape == (grid.n_perturbations, len(frame), 3)
    np.testing.assert_array_equal(got, _looped_oracle(svc, models['port'], frame, grid))
    np.testing.assert_allclose(got, out['jax'][1], rtol=0, atol=ATOL)


def test_rate_scenarios_end_location_grid_and_product_flow(models):
    """An end-location sweep served (P = 12 snaps to bucket 16), then
    folded into a heatmap, as in both packages."""
    frame = _frame(80, game_id=91)
    out = {pkg: _serve(pkg, models, frame, lambda p: p['ends'](nx=4, ny=3))[1] for pkg in PKGS}
    grid = end_location_grid(nx=4, ny=3)
    with RatingService(models['port'], max_actions=A, max_batch_size=4, max_wait_ms=1.0) as svc:
        np.testing.assert_array_equal(out['port'], _looped_oracle(svc, models['port'], frame, grid))
    np.testing.assert_allclose(out['port'], out['jax'], rtol=0, atol=ATOL)
    surf = decision_surface(out['port'], grid, game=0, action=3)
    assert surf.shape == (3, 4)
    np.testing.assert_array_equal(surf.ravel(), out['port'][:, 3, 2])


def test_scenario_zero_steady_state_retraces_after_warmup(models):
    """Warming the scenario rungs makes scenario traffic add no shape; the
    whole plateau is one ``scenario/shape_traces`` of bucket 8, in both
    packages."""
    frame = _frame(100, game_id=92)
    seen = {}
    for pkg, p in PKGS.items():
        with p['Service'](models[pkg], max_actions=A, max_batch_size=4, max_wait_ms=1.0,
                          max_perturbations=8) as svc:
            assert svc.scenario_ladder == (1, 2, 4, 8)
            svc.warmup(scenario_buckets=svc.scenario_ladder)
            shapes = svc.compiled_shapes
            traces = _value(pkg, 'scenario/shape_traces', n_perturbations_bucket='8')
            dispatches = _value(pkg, 'scenario/dispatches', n_perturbations_bucket='8')
            outs = []
            for _ in range(2):
                for n in (5, 7):
                    grid = p['sweep'](type_ids=list(range(n)))
                    outs.append(svc.rate_scenarios_sync(frame, grid, home_team_id=HOME,
                                                        timeout=WAIT))
                    assert outs[-1].shape == (n, len(frame), 3)
            seen[pkg] = (shapes, svc.compiled_shapes,
                         _value(pkg, 'scenario/shape_traces', n_perturbations_bucket='8') - traces,
                         _value(pkg, 'scenario/dispatches', n_perturbations_bucket='8') - dispatches,
                         outs)
    assert seen['port'][:4] == seen['jax'][:4]
    assert seen['port'][0] == seen['port'][1] and seen['port'][2:4] == (1, 4)
    for got, want in zip(seen['port'][4], seen['jax'][4]):
        np.testing.assert_allclose(got, want, rtol=0, atol=ATOL)


def _boom(*args, **kwargs):
    raise RuntimeError('injected device failure')


def test_scenario_breaker_fallback_serves_correct_values(models, monkeypatch):
    """A failing folded dispatch degrades the verb onto the looped
    materialized reference: the future resolves within the JAX test's band,
    one scenario fallback and one fallback flush are counted, in both
    packages."""
    frame = _frame(60, game_id=93)
    seen = {}
    for pkg, p in PKGS.items():
        with p['Service'](models[pkg], max_actions=A, max_batch_size=4,
                          max_wait_ms=1.0) as svc:
            grid = p['sweep'](type_ids=[0, 1, 2])
            fused = svc.rate_scenarios_sync(frame, grid, home_team_id=HOME, timeout=WAIT)
            before = (_value(pkg, 'scenario/fallbacks'), _value(pkg, 'serve/fallback_flushes'))
            with monkeypatch.context() as m:
                m.setattr(svc, '_device_rate', _boom)
                degraded = svc.rate_scenarios_sync(frame, grid, home_team_id=HOME, timeout=WAIT)
            np.testing.assert_allclose(degraded, fused, rtol=0, atol=FALLBACK_ATOL)
            seen[pkg] = (_value(pkg, 'scenario/fallbacks') - before[0],
                         _value(pkg, 'serve/fallback_flushes') - before[1],
                         svc.breaker.to_dict()['consecutive_failures'], degraded)
    assert seen['port'][:3] == seen['jax'][:3] == (1, 1, 1)
    np.testing.assert_allclose(seen['port'][3], seen['jax'][3], rtol=0, atol=ATOL)


def test_scenario_deadline_shed(models):
    """A scenario request still queued past its deadline fails with
    ``DeadlineExceeded`` and is never dispatched, in both packages."""
    frame = _frame(50, game_id=94)
    for pkg, exc in (('port', DeadlineExceeded), ('jax', JaxDeadlineExceeded)):
        p = PKGS[pkg]
        with p['Service'](models[pkg], max_actions=A, max_batch_size=8,
                          max_wait_ms=200.0) as svc:
            fut = svc.rate_scenarios(frame, p['sweep'](type_ids=[0, 1]), home_team_id=HOME,
                                     deadline_ms=5)
            with pytest.raises(exc):
                fut.result(timeout=WAIT)
        assert 'queue_wait' in fut.context.segments
        assert 'dispatch' not in fut.context.segments


def test_mixed_flush_partitions_and_reassembles_in_order(models):
    """One take mixing rate and scenario payloads (coalesced by ``close()``
    draining the queue): the rate payloads dispatch together at their
    bucket, the scenario payload at its own, and every future gets its own
    result, equal to the same request served alone."""
    rate_frame = _frame(70, game_id=95)
    scn_frame = _frame(40, game_id=96)
    out = {}
    for pkg, p in PKGS.items():
        grid = p['sweep'](type_ids=[0, 1, 2])
        with p['Service'](models[pkg], max_actions=A, max_batch_size=8,
                          max_wait_ms=1.0) as svc:
            rate_ref = svc.rate_sync(rate_frame, home_team_id=HOME, timeout=WAIT).to_numpy()
            scn_ref = svc.rate_scenarios_sync(scn_frame, grid, home_team_id=HOME, timeout=WAIT)
        svc = p['Service'](models[pkg], max_actions=A, max_batch_size=8, max_wait_ms=NEVER_MS)
        takes = []
        real = svc._batcher._runner

        def runner(payloads, bucket, *, lane=0, real=real, takes=takes):
            takes.append((len(payloads), bucket))
            return real(payloads, bucket, lane=lane)

        svc._batcher._runner = runner
        futs = [svc.rate(rate_frame, home_team_id=HOME),
                svc.rate_scenarios(scn_frame, grid, home_team_id=HOME),
                svc.rate(rate_frame, home_team_id=HOME)]
        svc.close()
        r1, s, r2 = (f.result(timeout=WAIT) for f in futs)
        assert takes == [(3, 4)]
        np.testing.assert_array_equal(r1.to_numpy(), rate_ref)
        np.testing.assert_array_equal(r2.to_numpy(), rate_ref)
        np.testing.assert_array_equal(s, scn_ref)
        out[pkg] = (r1.to_numpy(), s, r2.to_numpy())
    for got, want in zip(out['port'], out['jax']):
        np.testing.assert_allclose(got, want, rtol=0, atol=ATOL)


def _outcome(fn):
    try:
        fn()
        return 'ok'
    except Exception as e:  # the outcome under comparison
        return type(e).__name__, str(e)


def test_rate_scenarios_caller_thread_validation(models):
    """Malformed calls fail on the caller's thread with the JAX service's
    error types and messages (the model's own dense-block message aside)."""
    frame = _frame(30, game_id=97)
    multi = pd.concat([frame, _frame(30, game_id=98)], ignore_index=True)
    seen = {}
    for pkg, p in PKGS.items():
        bad_shape = p['custom'](field_updates={'end_x': np.zeros((2, 1, 99), dtype=np.float32)})
        bad_dense = p['custom'](dense_overrides={
            'actiontype_onehot': np.zeros((2, 1, A, 23), dtype=np.float32)})
        with p['Service'](models[pkg], max_actions=A, max_batch_size=4, max_wait_ms=1.0,
                          max_perturbations=4) as svc:
            calls = [
                lambda: svc.rate_scenarios(frame, {'end_x': [1.0]}, home_team_id=HOME),
                lambda: svc.rate_scenarios(frame, p['sweep'](), home_team_id=HOME),
                lambda: svc.rate_scenarios(frame.iloc[:0], p['sweep'](type_ids=[0]),
                                           home_team_id=HOME),
                lambda: svc.rate_scenarios(multi, p['sweep'](type_ids=[0]), home_team_id=HOME),
                lambda: svc.rate_scenarios(frame, bad_shape, home_team_id=HOME),
                lambda: svc.rate_scenarios(frame, bad_dense, home_team_id=HOME),
            ]
            seen[pkg] = [_outcome(c) for c in calls]
            assert svc._batcher.queue_depth == 0
    assert seen['port'][:5] == seen['jax'][:5]
    assert [o[0] for o in seen['port']] == ['TypeError'] + ['ValueError'] * 5
    assert 'max_perturbations=4' in seen['port'][1][1]
    assert '(P, 1, max_actions)' in seen['port'][4][1]
    for pkg in PKGS:
        assert 'not a dense feature block' in seen[pkg][5][1]


def test_rate_scenarios_validates_max_perturbations_config(models):
    for pkg, p in PKGS.items():
        with pytest.raises(ValueError, match='max_perturbations'):
            p['Service'](models[pkg], max_actions=64, max_perturbations=0)
    with RatingService(models['port'], max_actions=64, max_perturbations=8192) as svc:
        assert svc.scenario_ladder[-1] == 8192 and len(svc.scenario_ladder) == 14


# -- a kernel that cannot run is never degraded --------------------------------------------


def test_scenario_b1_oserror_fails_with_kernel_error_and_never_moves_the_breaker(
    models, monkeypatch,
):
    """An ``OSError`` on the CUDA side of B1's wrapper under a scenario
    flush (the real wrapper, its operands sent to the meta device so it
    takes its CUDA side here) fails the request with ``KernelError``: not
    served through the looped reference, the breaker, ``serve/fallback_flushes``
    and ``scenario/fallbacks`` untouched; the next request is served fused."""
    from socceraction_tpu_torch.ops import gather_matmul as gm

    real = gm.fused_first_layer_quant
    frame = _frame(60, game_id=99)
    grid = action_type_sweep(type_ids=[0, 1, 2])
    with RatingService(models['port'], max_actions=A, max_batch_size=4,
                       max_wait_ms=1.0) as svc:
        want = svc.rate_scenarios_sync(frame, grid, home_team_id=HOME, timeout=WAIT)
        breaker = svc.breaker.to_dict()
        before = (_value('port', 'serve/fallback_flushes'), _value('port', 'scenario/fallbacks'))

        def no_library(*args, **kwargs):
            raise OSError('libgather_matmul.so: cannot open shared object file')

        with monkeypatch.context() as m:
            m.setattr(gm, '_forward_cuda', no_library)
            m.setattr(fused_ops, 'fused_first_layer_quant',
                      lambda *ops: real(*(t.to('meta') for t in ops)))
            with pytest.raises(KernelError, match='gather_matmul cannot run: OSError') as info:
                svc.rate_scenarios_sync(frame, grid, home_team_id=HOME, timeout=WAIT)
        assert isinstance(info.value.__cause__, OSError)
        assert svc.breaker.to_dict() == breaker
        assert (_value('port', 'serve/fallback_flushes'), _value('port', 'scenario/fallbacks')) \
            == before
        assert svc.health()['status'] == 'ok'
        again = svc.rate_scenarios_sync(frame, grid, home_team_id=HOME, timeout=WAIT)
    np.testing.assert_array_equal(again, want)


def test_scenario_kernel_error_in_a_half_open_probe_frees_the_probe(models, monkeypatch):
    """A scenario flush that is the breaker's half-open probe and hits B1's
    failure gives the probe slot back: the breaker stays half-open, no
    fallback is counted, and the next scenario flush closes it."""
    from socceraction_tpu_torch.resil import CircuitBreaker, FaultPlan, FaultSpec

    frame = _frame(50, game_id=100)
    grid = action_type_sweep(type_ids=[0, 1])
    clock = {'t': 0.0}
    breaker = CircuitBreaker(failure_threshold=1, recovery_time_s=10.0, clock=lambda: clock['t'])
    with RatingService(models['port'], max_actions=A, max_batch_size=4, max_wait_ms=1.0,
                       breaker=breaker) as svc:
        with FaultPlan(seed=0, specs=[FaultSpec('serve.dispatch', error=RuntimeError, nth=1)]):
            svc.rate_scenarios_sync(frame, grid, home_team_id=HOME, timeout=WAIT)
        assert breaker.state == 'open'
        clock['t'] = 20.0
        fallbacks = _value('port', 'serve/fallback_flushes')

        def raising(*args, **kwargs):
            raise KernelError('no toolkit')

        with monkeypatch.context() as m:
            m.setattr(fused_ops, 'fused_first_layer_quant', raising)
            with pytest.raises(KernelError):
                svc.rate_scenarios_sync(frame, grid, home_team_id=HOME, timeout=WAIT)
        assert (breaker.state, breaker.trips) == ('half_open', 1)
        assert _value('port', 'serve/fallback_flushes') == fallbacks
        out = svc.rate_scenarios_sync(frame, grid, home_team_id=HOME, timeout=WAIT)
        assert breaker.state == 'closed' and svc.health()['status'] == 'ok'
    np.testing.assert_array_equal(out, _looped_oracle(svc, models['port'], frame, grid))
