"""The port's rating service against the JAX package's, on the CPU.

Counterparts of ``tests/test_serve.py``'s service, session and hot-swap
cases and ``tests/test_obs_runtime.py``'s health case. Each scenario runs
the same requests through both packages' ``RatingService`` on the same
weights (a tiny port model and the JAX package's load of its checkpoint)
and compares the outcomes:

- each package's served values against its own per-request ``rate_batch``
  of the same frame: **bitwise** (the JAX test's bound) — the port pads a
  flush with masked games and rows, and torch's CPU kernels give every
  valid row the same bits whatever the bucket;
- the two packages' served values: within 1e-5 (the same weights, f32
  sums in another order);
- errors (type and message), shape counts, ``serve/*`` counter deltas and
  the ``health()`` keys and time-independent values: equal.

Coalescing is forced, never timed: a flush is due when the queue is full
or the service closes (``max_wait_ms`` is far beyond any test), so no pass
depends on two requests landing within a wall-clock window.
"""

import os
import threading
from types import SimpleNamespace

import numpy as np
import pytest
import torch

from socceraction_tpu.core.batch import pack_actions as jax_pack_actions
from socceraction_tpu.core.batch import unpack_values as jax_unpack_values
from socceraction_tpu.core.synthetic import synthetic_actions_frame
from socceraction_tpu.obs import REGISTRY as JAX_REGISTRY
from socceraction_tpu.serve import ModelRegistry as JaxRegistry
from socceraction_tpu.serve import Overloaded as JaxOverloaded
from socceraction_tpu.serve import RatingService as JaxService
from socceraction_tpu.spadl import config as spadlconfig
from socceraction_tpu.vaep.base import load_model as jax_load_model
from socceraction_tpu_torch.core.batch import (
    bucket_games,
    bucket_ladder,
    pack_actions,
    unpack_values,
    window_ladder,
)
from socceraction_tpu_torch.core.synthetic import synthetic_batch
from socceraction_tpu_torch.obs import REGISTRY, drain_guards
from socceraction_tpu_torch.serve import ModelRegistry, Overloaded, RatingService, TrafficCapture
from socceraction_tpu_torch.vaep.base import VAEP

HOME = 100
A = 256
#: the port's served values against the JAX package's (same weights, f32)
ATOL = 1e-5
NEVER_MS = 600_000.0
WAIT = 60.0

PKGS = {
    'jax': SimpleNamespace(Service=JaxService, Overloaded=JaxOverloaded, metrics=JAX_REGISTRY,
                           registry=JaxRegistry),
    'port': SimpleNamespace(Service=RatingService, Overloaded=Overloaded, metrics=REGISTRY,
                            registry=lambda root: ModelRegistry(root, device='cpu')),
}


@pytest.fixture(scope='module', autouse=True)
def _drain_guards():
    """Leave the process-wide guard ring empty for the next module."""
    yield
    drain_guards()


def _both_models(model, path):
    """The same weights in both packages: ``model`` and the JAX package's
    load of its checkpoint."""
    model.save_model(path)
    return {'port': model, 'jax': jax_load_model(path)}


def _fit(seed, hidden, **kw):
    return VAEP(device='cpu', **kw).fit_packed(
        synthetic_batch(2, 256, seed=seed, device='cpu'),
        tree_params={'hidden': hidden, 'batch_size': 256, 'max_epochs': 2}, random_state=0,
    )


@pytest.fixture(scope='module')
def models(tmp_path_factory):
    return _both_models(_fit(3, (16,)), str(tmp_path_factory.mktemp('v1')))


@pytest.fixture(scope='module')
def models_b(tmp_path_factory):
    """Same feature layout, other head weights (the hot-swap partner)."""
    return _both_models(_fit(5, (8,)), str(tmp_path_factory.mktemp('v2')))


def _frame(i, n):
    return synthetic_actions_frame(game_id=i, seed=i, n_actions=n)


def _request_frames(n, rng_seed=0, lo=40, hi=A):
    rng = np.random.default_rng(rng_seed)
    return [_frame(50 + i, int(rng.integers(lo, hi))) for i in range(n)]


def _reference(pkg, model, frame, max_actions=A):
    """``rate_batch`` of one frame alone, unpacked, in ``pkg``."""
    if pkg == 'jax':
        batch, _ = jax_pack_actions(frame, home_team_id=HOME, max_actions=max_actions)
        return np.asarray(jax_unpack_values(model.rate_batch(batch, bucket=False), batch))
    batch, _ = pack_actions(frame, home_team_id=HOME, max_actions=max_actions, device='cpu')
    return unpack_values(model.rate_batch(batch, bucket=False), batch)


def _flushes(p):
    inst = p.metrics.snapshot().get('serve/flushes')
    return sum(s.total for s in inst.series) if inst else 0.0


def _try(fn, *args, **kwargs):
    try:
        return ('ok', fn(*args, **kwargs))
    except Exception as e:  # the outcome under comparison
        return (type(e).__name__, str(e))


def _agree(values):
    """Each package's arrays equal in length and within ATOL of the other's."""
    for got, want in zip(values['port'], values['jax']):
        got, want = np.asarray(got), np.asarray(want)
        assert got.shape == want.shape
        np.testing.assert_allclose(got, want, rtol=0, atol=ATOL)


# -- coalescing ---------------------------------------------------------------------------


def test_coalesced_flush_matches_per_request_rate_batch(models):
    """Five requests of different lengths coalesce into ONE flush padded
    to the 8-bucket (three padding games); each request's values equal
    its own ``rate_batch`` bitwise, in both packages."""
    frames = _request_frames(5)
    outs = {}
    for pkg, p in PKGS.items():
        before = _flushes(p)
        svc = p.Service(models[pkg], max_actions=A, max_batch_size=8, max_wait_ms=NEVER_MS)
        futs = [svc.rate(f, home_team_id=HOME) for f in frames]
        assert svc._batcher.queue_depth == 5 and not any(f.done() for f in futs)
        svc.close()  # the close flush takes all five
        outs[pkg] = [f.result(timeout=WAIT) for f in futs]
        assert _flushes(p) - before == 1
        for frame, out in zip(frames, outs[pkg]):
            assert list(out.columns) == ['offensive_value', 'defensive_value', 'vaep_value']
            assert out.index.equals(frame.index)
            np.testing.assert_array_equal(out.to_numpy(), _reference(pkg, models[pkg], frame))
        lat = p.metrics.snapshot().series('serve/request_seconds', kind='rate')
        assert lat is not None and lat.count >= len(frames)
    _agree({pkg: [o.to_numpy() for o in out] for pkg, out in outs.items()})


def test_flush_held_on_its_runner_coalesces_the_rest(models):
    """The first request's flush holds the flusher until three more are
    queued; they coalesce into the next take (a full 4-bucket flush)."""
    frames = _request_frames(4, rng_seed=1)
    outs = {}
    for pkg, p in PKGS.items():
        with p.Service(models[pkg], max_actions=A, max_batch_size=4,
                       max_wait_ms=0.0) as svc:
            entered, release = threading.Event(), threading.Event()
            takes = []
            real = svc._batcher._runner

            def held(payloads, bucket, real=real, takes=takes):
                takes.append((len(payloads), bucket))
                if len(takes) == 1:
                    entered.set()
                    release.wait(timeout=WAIT)
                return real(payloads, bucket)

            svc._batcher._runner = held
            first = svc.rate(frames[0], home_team_id=HOME)
            assert entered.wait(timeout=WAIT)
            rest = [svc.rate(f, home_team_id=HOME) for f in frames[1:]]
            release.set()
            outs[pkg] = [f.result(timeout=WAIT).to_numpy() for f in [first, *rest]]
        assert takes == [(1, 1), (3, 4)]
        for frame, out in zip(frames, outs[pkg]):
            np.testing.assert_array_equal(out, _reference(pkg, models[pkg], frame))
    _agree(outs)


def test_many_clients_under_a_short_switch_interval(models):
    """More client threads than cores, the interpreter switching threads
    every microsecond: every request comes back as its own frame's values
    (a payload sliced into the wrong request, or a lost one, would break
    it), and the batcher accounts for each exactly once."""
    import sys

    frames = _request_frames(8, rng_seed=5, lo=20, hi=120)
    refs = [_reference('port', models['port'], f) for f in frames]
    n_clients, per_client = 2 * (os.cpu_count() or 4), 4
    results, errors = {}, []
    before = REGISTRY.snapshot().value('serve/requests', kind='rate')
    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        with RatingService(models['port'], max_actions=A, max_batch_size=8,
                           max_wait_ms=0.5) as svc:
            def client(c):
                try:
                    for k in range(per_client):
                        i = (c + k) % len(frames)
                        out = svc.rate_sync(frames[i], home_team_id=HOME, timeout=WAIT)
                        results[(c, k)] = (i, out.to_numpy())
                except Exception as e:  # reported below
                    errors.append(e)

            threads = [threading.Thread(target=client, args=(c,)) for c in range(n_clients)]
            for t in threads:
                t.start()
            for t in threads:
                t.join(timeout=WAIT)
            assert not any(t.is_alive() for t in threads)
    finally:
        sys.setswitchinterval(interval)
    assert not errors, errors
    assert len(results) == n_clients * per_client
    for i, out in results.values():
        np.testing.assert_array_equal(out, refs[i])
    assert REGISTRY.snapshot().value('serve/requests', kind='rate') - before == len(results)


def test_rate_sync_matches_the_jax_service(models):
    frames = _request_frames(3, rng_seed=2)
    outs = {}
    for pkg, p in PKGS.items():
        with p.Service(models[pkg], max_actions=A, max_batch_size=4, max_wait_ms=1.0) as svc:
            outs[pkg] = [svc.rate_sync(f, home_team_id=HOME, timeout=WAIT).to_numpy()
                         for f in frames]
    _agree(outs)


def test_shapes_plateau_after_warmup_under_randomized_sizes(models):
    rng = np.random.default_rng(7)
    frames = _request_frames(12, rng_seed=3)
    picks = [int(i) for i in rng.integers(0, len(frames), size=12)]
    seen = {}
    for pkg, p in PKGS.items():
        before = p.metrics.snapshot()
        with p.Service(models[pkg], max_actions=A, max_batch_size=4, max_wait_ms=1.0) as svc:
            warmed = svc.warmup()
            after_warmup = svc.compiled_shapes
            for group in range(4):
                futs = [svc.rate(frames[i], home_team_id=HOME) for i in picks[3 * group:3 * group + 3]]
                for f in futs:
                    f.result(timeout=WAIT)
            seen[pkg] = (warmed, after_warmup, svc.compiled_shapes, list(svc.ladder))
        traces = p.metrics.snapshot().get('serve/shape_traces')
        for s in traces.series:
            b = int(s.labels['bucket'])
            assert b == bucket_games(b)
        seen[pkg] += (sum(p.metrics.snapshot().value('serve/shape_traces', bucket=str(b))
                          - before.value('serve/shape_traces', bucket=str(b)) for b in (1, 2, 4)),)
    assert seen['port'] == seen['jax']
    assert seen['port'][1] == seen['port'][2] == 3 == seen['port'][4]


def test_rejections_match_the_jax_service(models):
    """Oversized, multi-game, empty and unlabeled requests, and an unfitted
    model, raise the same errors in both packages."""
    long = _frame(60, A + 1)
    two = _frame(61, 50)
    two.loc[two.index[25:], 'game_id'] = 62
    short = _frame(63, 30)
    out = {}
    for pkg, p in PKGS.items():
        with p.Service(models[pkg], max_actions=A, max_batch_size=4, max_wait_ms=1.0) as svc:
            out[pkg] = [
                _try(svc.rate, long, home_team_id=HOME),
                _try(svc.rate, two, home_team_id=HOME),
                _try(svc.rate, short.iloc[:0], home_team_id=HOME),
                _try(svc.rate, short.drop(columns=['home_team_id'], errors='ignore')),
                _try(svc.swap_model, 'vaep', '1'),
                _try(svc.rollback_model),
            ]
        unfitted = VAEP(device='cpu') if pkg == 'port' else type(models['jax'])()
        out[pkg].append(_try(p.Service, unfitted))
        out[pkg].append(_try(p.Service))
    assert out['port'] == out['jax']
    assert all(kind != 'ok' for kind, _ in out['port'])
    assert 'exceed the service window (max_actions=256)' in out['port'][0][1]
    assert out['port'][6] == ('ValueError', 'the serving model must be fitted')


def test_health_matches_the_jax_service(models):
    frame = _frame(64, 150)
    health = {}
    for pkg, p in PKGS.items():
        with p.Service(models[pkg], max_actions=A, max_batch_size=4, max_wait_ms=1.0,
                       slo_p99_ms=60_000.0) as svc:
            svc.warmup()
            svc.rate_sync(frame, home_team_id=HOME, timeout=WAIT)
            health[pkg] = svc.health()
    port, jax = health['port'], health['jax']
    assert set(port) == set(jax)
    for key in ('status', 'queue_depth', 'max_queue', 'flusher_alive', 'flusher_error',
                'numerics', 'breaker', 'flusher_restarts', 'ladder', 'compiled_shapes', 'aot',
                'last_dump'):
        assert port[key] == jax[key], key
    for block in ('model', 'slo', 'capacity'):
        assert set(port[block]) == set(jax[block]), block
    assert {k: port['model'][k] for k in ('name', 'version', 'quantize')} == {
        k: jax['model'][k] for k in ('name', 'version', 'quantize')}
    # the JAX block names its first-layer lowering; the port's names the
    # rating path and B1's launches by instantiation (none on the CPU)
    assert port['model']['kernel'] == {'path': 'fused', 'plans': {}}
    assert port['slo']['budget_p99_ms'] == jax['slo']['budget_p99_ms'] == 60_000.0
    assert port['slo']['ok'] is jax['slo']['ok'] is True
    assert port['status'] == 'ok' and port['aot'] == {'available': False,
                                                     'compile_cache': {'dir': None}}


# -- sessions -----------------------------------------------------------------------------


def _goal_rows(frame):
    shots = frame['type_id'].isin(
        [spadlconfig.SHOT, spadlconfig.SHOT_PENALTY, spadlconfig.SHOT_FREEKICK])
    return np.flatnonzero((shots & (frame['result_id'] == spadlconfig.SUCCESS)).to_numpy())


def _session_run(models, frame, chunks, max_actions=A, **svc_kw):
    """Stream ``frame`` in ``chunks`` through a session of each package."""
    outs = {}
    for pkg, p in PKGS.items():
        with p.Service(models[pkg], max_actions=max_actions, max_batch_size=4,
                       max_wait_ms=1.0, **svc_kw) as svc:
            sess = svc.open_session('m', home_team_id=HOME)
            for lo, hi in chunks:
                out = sess.add_actions(frame.iloc[lo:hi])
                assert out.index.equals(frame.index[lo:hi])
            assert sess.n_actions == len(frame)
            outs[pkg] = sess.ratings().to_numpy()
        np.testing.assert_array_equal(outs[pkg], _reference(pkg, models[pkg], frame, max_actions=A))
    _agree({pkg: [o] for pkg, o in outs.items()})
    return outs


def test_session_incremental_matches_full_replay(models):
    frame = _frame(9, 240)
    assert len(_goal_rows(frame)) > 0  # the whole-match goalscore carry is live
    rng = np.random.default_rng(1)
    chunks, i = [], 0
    while i < len(frame):
        m = int(rng.integers(1, 48))
        chunks.append((i, i + m))
        i += m
    _session_run(models, frame, chunks)


def test_session_single_action_ticks(models):
    frame = _frame(11, 30)
    _session_run(models, frame, [(i, i + 1) for i in range(len(frame))])


def _flaky_submit(svc, fail_on, p):
    orig = svc._submit_window
    calls = {'n': 0}

    def flaky(*args, **kw):
        calls['n'] += 1
        if calls['n'] == fail_on:
            raise p.Overloaded('queue full')
        return orig(*args, **kw)

    svc._submit_window = flaky
    return orig


def test_session_tick_failure_leaves_the_carry_untouched(models):
    """A rejected tick that holds a goal commits nothing; the retry stays
    exact."""
    frame = _frame(9, 240)
    cut = int(_goal_rows(frame)[0]) + 1
    assert cut > 5
    outs = {}
    for pkg, p in PKGS.items():
        with p.Service(models[pkg], max_actions=A, max_batch_size=4, max_wait_ms=1.0) as svc:
            sess = svc.open_session('m10', home_team_id=HOME)
            sess.add_actions(frame.iloc[: cut - 5])
            orig = _flaky_submit(svc, 1, p)
            with pytest.raises(p.Overloaded):
                sess.add_actions(frame.iloc[cut - 5 : cut + 5])
            svc._submit_window = orig
            state = (sess.n_actions, sess._score_a, sess._score_b, len(sess._tail))
            sess.add_actions(frame.iloc[cut - 5 : cut + 5])
            sess.add_actions(frame.iloc[cut + 5 :])
            outs[pkg] = (state, sess.ratings().to_numpy())
        np.testing.assert_array_equal(outs[pkg][1], _reference(pkg, models[pkg], frame))
    assert outs['port'][0] == outs['jax'][0]
    _agree({pkg: [o[1]] for pkg, o in outs.items()})


def test_oversized_tick_is_atomic(models):
    """A tick larger than the window splits into sub-windows but commits
    once: a failure on the second leaves the session untouched."""
    frame = _frame(12, 240)
    outs = {}
    for pkg, p in PKGS.items():
        with p.Service(models[pkg], max_actions=128, max_batch_size=8, max_wait_ms=1.0) as svc:
            sess = svc.open_session('m12', home_team_id=HOME)
            orig = _flaky_submit(svc, 2, p)
            with pytest.raises(p.Overloaded):
                sess.add_actions(frame)
            untouched = (sess.n_actions, sess.ratings().empty, sess._tail is None)
            svc._submit_window = orig
            out = sess.add_actions(frame)
            outs[pkg] = (untouched, sess.n_actions, out.to_numpy())
        np.testing.assert_array_equal(outs[pkg][2], _reference(pkg, models[pkg], frame))
    assert outs['port'][:2] == outs['jax'][:2] == ((0, True, True), len(frame))
    _agree({pkg: [o[2]] for pkg, o in outs.items()})


def test_concurrent_sessions(models):
    frames = {mid: _frame(mid, 90) for mid in (21, 22, 23)}
    results = {}
    for pkg, p in PKGS.items():
        got = {}
        with p.Service(models[pkg], max_actions=A, max_batch_size=8, max_wait_ms=1.0) as svc:
            def play(mid, svc=svc, got=got):
                sess = svc.open_session(mid, home_team_id=HOME)
                f = frames[mid]
                for i in range(0, len(f), 30):
                    sess.add_actions(f.iloc[i : i + 30])
                got[mid] = sess.ratings().to_numpy()

            threads = [threading.Thread(target=play, args=(mid,)) for mid in frames]
            for t in threads:
                t.start()
            for t in threads:
                t.join(timeout=WAIT)
        for mid, f in frames.items():
            np.testing.assert_array_equal(got[mid], _reference(pkg, models[pkg], f))
        results[pkg] = [got[mid] for mid in sorted(got)]
    _agree(results)


def test_service_without_goalscore_kernel(tmp_path):
    """A model whose features exclude goalscore serves without the host
    goalscore work, and its sessions stay exact."""
    xfns = ['actiontype_onehot', 'bodypart_onehot', 'startlocation', 'movement']
    both = _both_models(_fit(3, (8,), xfns=xfns), str(tmp_path / 'nogs'))
    frames = [_frame(0, 160), _frame(1, 160)]
    outs = {}
    for pkg, p in PKGS.items():
        with p.Service(both[pkg], max_actions=A, max_batch_size=4, max_wait_ms=1.0) as svc:
            assert svc._gs_enabled is False
            one = svc.rate_sync(frames[0], home_team_id=HOME, timeout=WAIT).to_numpy()
            sess = svc.open_session('nogs', home_team_id=HOME)
            for i in range(0, len(frames[1]), 40):
                sess.add_actions(frames[1].iloc[i : i + 40])
            live = sess.ratings().to_numpy()
        for out, frame in ((one, frames[0]), (live, frames[1])):
            np.testing.assert_array_equal(out, _reference(pkg, both[pkg], frame))
        outs[pkg] = [one, live]
    _agree(outs)


def test_seq_head_warms_and_serves_its_window_rungs(tmp_path):
    """A seq model warms every (bucket, window rung) shape; a short request
    dispatches at its rung (128 of 256) and adds no shape."""
    model = VAEP(device='cpu').fit_packed(
        synthetic_batch(2, 256, seed=3, device='cpu'), learner='seq',
        tree_params={'embed_dim': 8, 'hidden': 16, 'readout': 16, 'batch_size': 256,
                     'max_epochs': 1}, random_state=0,
    )
    both = _both_models(model, str(tmp_path / 'seq'))
    frames = [_frame(30, 100), _frame(31, 220)]
    seen, outs = {}, {}
    for pkg, p in PKGS.items():
        before = p.metrics.snapshot().value('seq/window_slices', window='128')
        with p.Service(both[pkg], max_actions=A, max_batch_size=1, max_wait_ms=1.0) as svc:
            svc.warmup()
            warm = svc.compiled_shapes
            outs[pkg] = [svc.rate_sync(f, home_team_id=HOME, timeout=WAIT).to_numpy()
                         for f in frames]
            seen[pkg] = (warm, svc.compiled_shapes,
                         p.metrics.snapshot().value('seq/window_slices', window='128') - before)
        for out, frame in zip(outs[pkg], frames):
            np.testing.assert_array_equal(out, _reference(pkg, both[pkg], frame))
    assert seen['port'] == seen['jax'] == (len(window_ladder(A)), len(window_ladder(A)), 2)
    _agree(outs)


# -- the registry and hot swap ------------------------------------------------------------


def _registry(pkg, root, models, models_b):
    reg = PKGS[pkg].registry(os.path.join(root, pkg))
    reg.publish('vaep', '1', models[pkg])
    reg.publish('vaep', '2', models_b[pkg])
    reg.activate('vaep', '1')
    return reg


def _swaps(p, **labels):
    return p.metrics.snapshot().value('serve/model_swaps', **labels)


def test_activate_swap_and_rollback(tmp_path, models, models_b):
    frame = _frame(31, 150)
    outs, counts = {}, {}
    for pkg, p in PKGS.items():
        reg = _registry(pkg, str(tmp_path), models, models_b)
        swaps, rollbacks = _swaps(p), _swaps(p, reason='rollback')
        with p.Service(registry=reg, max_actions=A, max_batch_size=4, max_wait_ms=1.0) as svc:
            svc.warmup()
            shapes = svc.compiled_shapes
            one = svc.rate_sync(frame, home_team_id=HOME, timeout=WAIT).to_numpy()
            swapped = svc.swap_model('vaep', '2')
            two = svc.rate_sync(frame, home_team_id=HOME, timeout=WAIT).to_numpy()
            rolled = svc.rollback_model()
            back = svc.rate_sync(frame, home_team_id=HOME, timeout=WAIT).to_numpy()
            counts[pkg] = (swapped, rolled, reg.active()[:2], shapes, svc.compiled_shapes,
                           _swaps(p) - swaps, _swaps(p, reason='rollback') - rollbacks)
        np.testing.assert_array_equal(one, _reference(pkg, models[pkg], frame))
        np.testing.assert_array_equal(two, _reference(pkg, models_b[pkg], frame))
        np.testing.assert_array_equal(back, one)
        outs[pkg] = [one, two, back]
    assert counts['port'] == counts['jax']
    assert counts['port'][:3] == (('vaep', '2'), ('vaep', '1'), ('vaep', '1'))
    assert counts['port'][3] == counts['port'][4] and counts['port'][6] == 1
    _agree(outs)


def test_concurrent_hot_swap_consistency(tmp_path, models, models_b):
    """Every result is EXACTLY one version's output under rapid swapping."""
    frame = _frame(33, 100)
    for pkg, p in PKGS.items():
        reg = _registry(pkg, str(tmp_path), models, models_b)
        ref1 = _reference(pkg, models[pkg], frame)
        ref2 = _reference(pkg, models_b[pkg], frame)
        assert not np.array_equal(ref1, ref2)
        stop = threading.Event()
        seen = set()
        with p.Service(registry=reg, max_actions=A, max_batch_size=4, max_wait_ms=1.0) as svc:
            def swapper(svc=svc):
                v = 2
                while not stop.is_set():
                    svc.swap_model('vaep', str(v))
                    v = 3 - v

            t = threading.Thread(target=swapper)
            t.start()
            try:
                for _ in range(12):
                    got = svc.rate_sync(frame, home_team_id=HOME, timeout=WAIT).to_numpy()
                    match = [np.array_equal(got, ref) for ref in (ref1, ref2)]
                    assert match.count(True) == 1
                    seen.add(match.index(True))
            finally:
                stop.set()
                t.join(timeout=WAIT)


def test_swap_rejects_a_layout_change(tmp_path, models):
    out = {}
    for pkg, p in PKGS.items():
        reg = p.registry(os.path.join(str(tmp_path), pkg))
        reg.publish('vaep', '1', models[pkg])
        reg.activate('vaep', '1')
        other = (VAEP(nb_prev_actions=2, device='cpu') if pkg == 'port'
                 else type(models['jax'])(nb_prev_actions=2))
        other._models = dict(models[pkg]._models)  # fitted, but k differs
        reg._loaded[('vaep', '99')] = other
        os.makedirs(reg._dir('vaep', '99'))
        with open(os.path.join(reg._dir('vaep', '99'), 'meta.json'), 'w') as f:
            f.write('{}')
        with p.Service(registry=reg, max_actions=A, max_batch_size=2, max_wait_ms=1.0,
                       debug_dir=str(tmp_path / pkg / 'debug'), dump_interval_s=0.0) as svc:
            out[pkg] = (_try(svc.swap_model, 'vaep', '99'), reg.active()[:2],
                        svc.last_dump_path is not None)
    assert out['port'] == out['jax']
    assert out['port'][0][0] == 'ValueError' and 'feature layout' in out['port'][0][1]
    assert out['port'][1:] == (('vaep', '1'), True)


# -- options ------------------------------------------------------------------------------


def test_every_jax_option_constructs(models):
    """``slo=``, ``capture=``, ``parity=`` and a ``max_perturbations`` past
    the default build a service, as in the JAX package; each is wired in."""
    from socceraction_tpu_torch.obs.parity import ParityProbe
    from socceraction_tpu_torch.obs.slo import SLOConfig

    probe, capture = ParityProbe(), TrafficCapture()
    with RatingService(models['port'], max_actions=A, max_batch_size=2,
                       slo=SLOConfig.simple(latency_ms=1000.0), capture=capture,
                       parity=probe, max_perturbations=8192) as svc:
        assert (svc.capture, svc.parity) == (capture, probe)
        assert probe.on_exceed == svc._on_parity_exceed
        assert svc.scenario_ladder == bucket_ladder(8192)
        assert svc.health()['slo']['shedding'] is False


def test_warmup_with_scenario_buckets_warms_their_rungs(models):
    """``warmup(scenario_buckets=)`` adds the perturbation rungs to the
    ladder it warms, as the JAX service does."""
    out = {}
    for pkg, p in PKGS.items():
        with p.Service(models[pkg], max_actions=A, max_batch_size=2) as svc:
            out[pkg] = (svc.warmup(scenario_buckets=(4, 16)), svc.compiled_shapes)
    assert out['port'] == out['jax'] == ((1, 2, 4, 16), 4)


def test_telemetry_serves_the_services_health(models):
    """``telemetry()`` is the fleet plane's exposition bundle over this
    service's ``health``, as in the JAX package."""
    from socceraction_tpu_torch.obs.endpoint import Telemetry

    with RatingService(models['port'], max_actions=A, max_batch_size=2) as svc:
        telemetry = svc.telemetry(replica='serve-a')
        assert isinstance(telemetry, Telemetry) and telemetry.replica == 'serve-a'
        assert telemetry.health()['model'] == svc.health()['model']


def test_defaults_are_the_jax_services():
    import inspect

    port = inspect.signature(RatingService.__init__).parameters
    jax = inspect.signature(JaxService.__init__).parameters
    assert list(port) == list(jax)
    assert {k: v.default for k, v in port.items()} == {k: v.default for k, v in jax.items()}


def test_a_model_on_the_cpu_serves_on_the_cpu(models):
    """The flush rates on the model's device: a CPU model's values come
    from CPU tensors, whatever the default device is."""
    seen = []
    real = models['port'].rate_batch

    def spy(batch, **kw):
        seen.append(batch.device)
        return real(batch, **kw)

    models['port'].rate_batch = spy
    try:
        with RatingService(models['port'], max_actions=A, max_batch_size=2,
                           max_wait_ms=1.0) as svc:
            svc.rate_sync(_frame(70, 50), home_team_id=HOME, timeout=WAIT)
    finally:
        del models['port'].rate_batch
    assert seen == [torch.device('cpu')]
