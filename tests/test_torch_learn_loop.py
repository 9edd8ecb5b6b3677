"""The port's continuous-learning loop against the JAX package's, on the CPU.

Counterparts of ``tests/test_learn.py``'s ingest and loop tests and
``tests/test_chaos.py``'s learner-restart cases, with no rating service
(the port's learner activates through the registry; the full loop records
its capture frames directly). Each scenario runs through both packages on
the same store (the JAX package's ``write_synthetic_season`` and
``append_synthetic_games``; the port has no synthetic frame writer yet)
from the same version 1, and the two runs must agree on the verdicts,
candidate versions, replay sources, journal stages, registry versions and
manifests' game ids. A checkpoint the port promoted rates in the JAX
package within 1e-5 of the port's model; the port's shadow replay of it is
within 1e-6 of the JAX package's (bin counts bitwise). Journals and
registries written by one package carry on under the other.
"""

import os
from types import SimpleNamespace

import numpy as np
import pytest
import torch

from socceraction_tpu.core.synthetic import (
    append_synthetic_games,
    synthetic_actions_frame,
    write_synthetic_season,
)
from socceraction_tpu.core.synthetic import synthetic_batch as jax_synthetic_batch
from socceraction_tpu.learn import ContinuousLearner as JaxLearner
from socceraction_tpu.learn import GateConfig as JaxGate
from socceraction_tpu.learn import LearnConfig as JaxConfig
from socceraction_tpu.learn import SeasonWatcher as JaxWatcher
from socceraction_tpu.learn import calibration as jcal
from socceraction_tpu.learn import extend_packed as jax_extend_packed
from socceraction_tpu.learn import newest_game_ids as jax_newest_game_ids
from socceraction_tpu.learn import shadow_replay as jax_shadow_replay
from socceraction_tpu.learn.drift import DriftConfig as JaxDrift
from socceraction_tpu.learn.shadow import pack_replay_batch as jax_pack_replay_batch
from socceraction_tpu.obs import REGISTRY as JAX_REGISTRY
from socceraction_tpu.pipeline.store import SeasonStore as JaxStore
from socceraction_tpu.resil import FaultPlan as JaxFaultPlan
from socceraction_tpu.resil import FaultSpec as JaxFaultSpec
from socceraction_tpu.resil import IterationJournal as JaxJournal
from socceraction_tpu.serve import ModelRegistry as JaxRegistry
from socceraction_tpu.serve import TrafficCapture as JaxCapture
from socceraction_tpu.vaep.base import load_model as jax_load_model
from socceraction_tpu_torch.core.synthetic import synthetic_batch
from socceraction_tpu_torch.learn import (
    ContinuousLearner,
    DriftConfig,
    DriftWatch,
    GateConfig,
    LearnConfig,
    SeasonWatcher,
    build_drift_reference,
    extend_packed,
    newest_game_ids,
    pack_replay_batch,
    reliability_curve,
    shadow_replay,
)
from socceraction_tpu_torch.obs import REGISTRY, drain_guards
from socceraction_tpu_torch.pipeline.packed import ensure_packed
from socceraction_tpu_torch.pipeline.store import SeasonStore
from socceraction_tpu_torch.resil import FaultPlan, FaultSpec, IterationJournal
from socceraction_tpu_torch.serve import ModelRegistry, RatingService, TrafficCapture
from socceraction_tpu_torch.vaep.base import VAEP, load_model

HOME = 100
A_MAX = 64  # the restart scenarios' max_actions (== stored game length)
#: the port's ratings against the JAX package's of one checkpoint (f32)
ATOL = 1e-5


@pytest.fixture(scope='module', autouse=True)
def _drain_guards():
    """Leave the process-wide guard ring empty for the next module: this
    one's ratings note guards no test here drains."""
    yield
    drain_guards()

PKGS = {
    'jax': SimpleNamespace(
        Store=JaxStore, Learner=JaxLearner, Config=JaxConfig, Gate=JaxGate, Drift=JaxDrift,
        Capture=JaxCapture, FaultPlan=JaxFaultPlan, FaultSpec=JaxFaultSpec, Journal=JaxJournal,
        registry=lambda root: JaxRegistry(root), metrics=JAX_REGISTRY,
    ),
    'port': SimpleNamespace(
        Store=SeasonStore, Learner=ContinuousLearner, Config=LearnConfig, Gate=GateConfig,
        Drift=DriftConfig, Capture=TrafficCapture, FaultPlan=FaultPlan, FaultSpec=FaultSpec,
        Journal=IterationJournal, registry=lambda root: ModelRegistry(root, device='cpu'),
        metrics=REGISTRY,
    ),
}


@pytest.fixture(scope='module')
def v1_checkpoint(tmp_path_factory):
    """Version 1 of every scenario: a port model's checkpoint, which both
    packages load (the same weights on both sides)."""
    path = str(tmp_path_factory.mktemp('v1'))
    VAEP(device='cpu').fit_packed(
        synthetic_batch(2, 256, seed=3, device='cpu'),
        tree_params={'hidden': (16,), 'batch_size': 256, 'max_epochs': 2}, random_state=0,
    ).save_model(path)
    return path


def _frame(i, n=40):
    return synthetic_actions_frame(
        game_id=i, home_team_id=HOME, away_team_id=HOME + 1, seed=i, n_actions=n,
    )


def _env(pkg, root, v1, n_games=2, n_actions=A_MAX, active=True):
    """A season store and a registry (with version 1 active unless
    ``active`` is False) under ``root``."""
    store_path = os.path.join(root, 'season')
    write_synthetic_season(store_path, n_games=n_games, n_actions=n_actions)
    registry = PKGS[pkg].registry(os.path.join(root, 'registry'))
    if active:
        model = jax_load_model(v1) if pkg == 'jax' else load_model(v1, device='cpu')
        registry.publish('vaep', '1', model)
        registry.activate('vaep', '1')
    return store_path, registry


def _config(pkg, root, **extra):
    """The restart scenarios' config (``tests/test_chaos.py``'s)."""
    p = PKGS[pkg]
    base = dict(
        model_name='vaep', max_actions=A_MAX, games_per_batch=2, fallback_replay_games=2,
        train_params={'max_epochs': 0}, gate=p.Gate(n_boot=8),
        journal_path=os.path.join(root, 'journal.jsonl'), debug_dir=os.path.join(root, 'debug'),
    )
    base.update(extra)
    return p.Config(**base)


def _report(r):
    return (r.verdict, r.candidate_version, r.replay.get('source'), r.replay.get('frames'),
            r.replay.get('actions'), sorted(r.new_games), len(r.reasons) > 0)


def _trail(registry, root):
    """What a run leaves: registry versions, active and previous, staged
    candidates, each version's manifest game ids, the journal's stages."""
    manifests = {}
    for v in registry.versions('vaep'):
        m = registry.load_manifest('vaep', v)
        manifests[v] = None if m is None else {
            k: m.get(k) for k in ('trained_game_ids', 'new_game_ids', 'drift_reference_games')
        }
    journal = os.path.join(root, 'journal.jsonl')
    stages = [(e['stage'], e.get('verdict'), e.get('version'))
              for e in JaxJournal(journal).entries()] if os.path.exists(journal) else []
    active = registry.active()[:2] if registry._active is not None else None
    return {'versions': registry.versions('vaep'), 'active': active,
            'previous': registry.previous(), 'candidates': len(registry.candidates('vaep')),
            'manifests': manifests, 'journal': stages}


def _both(tmp_path, scenario, *args):
    """Run ``scenario(pkg, root, *args)`` for both packages; their results."""
    out = {}
    for pkg in PKGS:
        root = str(tmp_path / pkg)
        os.makedirs(root)
        out[pkg] = scenario(pkg, root, *args)
    return out


# -- ingest ---------------------------------------------------------------------------------


@pytest.mark.parametrize('ids,n', [
    ([9000, 9999, 10000, 12072, 'friendly-b', 'friendly-a'], 2),
    ([9000, 9999, 10000, 12072], 2),
    ([9000, 9999, 10000, 12072], 0),
    ([3, 1, 2], 5),
    (['-5', 7, 'x', '10', 2], 3),
])
def test_newest_game_ids_is_numeric_aware(ids, n):
    assert newest_game_ids(ids, n) == jax_newest_game_ids(ids, n)
    assert newest_game_ids([9000, 9999, 10000, 12072], 2) == [10000, 12072]


def test_watcher_poll_commit_prime(tmp_path):
    store_path = str(tmp_path / 'season')
    write_synthetic_season(store_path, n_games=3, n_actions=64)
    with SeasonStore(store_path, mode='a') as store, JaxStore(store_path, mode='a') as jstore:
        fresh, jfresh = SeasonWatcher(store), JaxWatcher(jstore)
        assert fresh.poll() == jfresh.poll() and len(fresh.poll()) == 3
        fresh.commit(fresh.poll())
        assert fresh.poll() == [] and fresh.seen == set(jfresh.poll())
        primed, jprimed = SeasonWatcher(store, prime=True), JaxWatcher(jstore, prime=True)
        assert primed.poll() == []
        new_ids = append_synthetic_games(store_path, 2, n_actions=64, seed=50)
        assert set(primed.poll()) == set(new_ids)
        assert set(primed.poll()) == set(new_ids)  # read-only until commit
        assert primed.poll() == jprimed.poll()


def _fields(batch):
    return {k: v.numpy() for k, v in batch.fields().items()}


def test_extend_packed_is_incremental_and_bitwise(tmp_path):
    store_path = str(tmp_path / 'season')
    cache = str(tmp_path / 'cache')
    write_synthetic_season(store_path, n_games=5, n_actions=64)
    before = REGISTRY.snapshot().value('learn/cache_games', source='reused')
    with SeasonStore(store_path, mode='a') as store:
        assert extend_packed(store, max_actions=64, cache_dir=cache)[1:] == (0, 5)
        assert extend_packed(store, max_actions=64, cache_dir=cache)[1:] == (5, 0)
        new_ids = append_synthetic_games(store_path, 2, n_actions=64, seed=9)
    with SeasonStore(store_path, mode='a') as store:
        season, reused, packed = extend_packed(store, max_actions=64, cache_dir=cache)
        assert (reused, packed) == (5, 2)
        assert set(new_ids) <= set(season.game_ids)
        cold = ensure_packed(store, max_actions=64, cache_dir=str(tmp_path / 'cold'))
    assert REGISTRY.snapshot().value('learn/cache_games', source='reused') == before + 5
    assert season.game_ids == cold.game_ids
    a, _ = season.take(season.game_ids, device='cpu')
    b, _ = cold.take(cold.game_ids, device='cpu')
    for name, want in _fields(b).items():
        np.testing.assert_array_equal(_fields(a)[name], want, err_msg=name)
    # and the files are the cold build's, byte for byte
    for f in sorted(os.listdir(cache)):
        if f.endswith('.npy'):
            assert open(os.path.join(cache, f), 'rb').read() == \
                open(os.path.join(str(tmp_path / 'cold'), f), 'rb').read(), f


def test_extend_packed_seeds_from_a_jax_built_cache(tmp_path):
    """The incremental build reads a stale cache the JAX package wrote."""
    store_path = str(tmp_path / 'season')
    cache = str(tmp_path / 'cache')
    write_synthetic_season(store_path, n_games=4, n_actions=64)
    with JaxStore(store_path, mode='a') as jstore:
        assert jax_extend_packed(jstore, max_actions=64, cache_dir=cache)[1:] == (0, 4)
    append_synthetic_games(store_path, 1, n_actions=64, seed=3)
    with SeasonStore(store_path, mode='a') as store:
        season, reused, packed = extend_packed(store, max_actions=64, cache_dir=cache)
        assert (reused, packed) == (4, 1)
        cold = ensure_packed(store, max_actions=64, cache_dir=str(tmp_path / 'cold'))
    a, _ = season.take(season.game_ids, device='cpu')
    b, _ = cold.take(cold.game_ids, device='cpu')
    for name, want in _fields(b).items():
        np.testing.assert_array_equal(_fields(a)[name], want, err_msg=name)
    with JaxStore(store_path, mode='a') as jstore:
        assert jax_extend_packed(jstore, max_actions=64, cache_dir=cache)[1:] == (5, 0)


# -- the full loop --------------------------------------------------------------------------

FULL_A = 192  # max_actions of the full loop (== valid actions per stored game)


def _full_loop(pkg, root):
    """``tests/test_learn.py``'s acceptance run without a service: a
    bootstrap, traffic recorded into the capture ring, a degraded candidate
    blocked, a warm-started retrain promoted, a rollback."""
    p = PKGS[pkg]
    store_path = os.path.join(root, 'season')
    write_synthetic_season(store_path, n_games=6, n_actions=FULL_A, seed=0)
    registry = p.registry(os.path.join(root, 'registry'))
    base = dict(model_name='vaep', max_actions=FULL_A, games_per_batch=4, random_state=0,
                debug_dir=os.path.join(root, 'debug'),
                gate=p.Gate(n_boot=32, max_ece_regression=0.05, max_brier_regression=0.02))
    good = p.Config(**base, train_params={'hidden': (16,), 'max_epochs': 40, 'batch_size': 512,
                                          'patience': 8})
    bad = p.Config(**{**base, 'warm_start': False},
                   train_params={'hidden': (16,), 'max_epochs': 0, 'batch_size': 1024})
    reports = []
    with p.Store(store_path, mode='a') as store:
        boot = p.Learner(store, registry, config=good)
        reports.append(boot.run_once())
        capture = p.Capture(max_frames=32)
        capture.record_frame(_frame(70, n=120), HOME)
        live = _frame(71, n=90)
        capture.record_session('live-1', live.iloc[:50], HOME)
        capture.record_session('live-1', live.iloc[50:], HOME)
        learner_bad = p.Learner(store, registry, capture=capture, config=bad)
        learner_good = p.Learner(store, registry, capture=capture, config=good)
        reports.append(learner_bad.run_once())
        new_ids = append_synthetic_games(store_path, 3, n_actions=FULL_A, seed=77)
        reused = p.metrics.snapshot().value('learn/cache_games', source='reused')
        reports.append(learner_bad.run_once())
        staged = registry.candidates('vaep')
        reports.append(learner_good.run_once())
        reused = p.metrics.snapshot().value('learn/cache_games', source='reused') - reused
        promoted = registry.active()[2]
        rolled = learner_good.rollback()
    return {'reports': [_report(r) for r in reports], 'new_ids': sorted(new_ids),
            'staged': len(staged), 'reused': reused, 'rolled': rolled,
            'trail': _trail(registry, root), 'promoted': promoted, 'registry': registry,
            'rejected_reasons': reports[2].reasons, 'heads': reports[3].heads}


@pytest.fixture(scope='module')
def full_loops(tmp_path_factory):
    return _both(tmp_path_factory.mktemp('full'), _full_loop)


def test_full_loop_agrees_with_the_jax_package(full_loops):
    port, jax_ = full_loops['port'], full_loops['jax']
    for key in ('reports', 'new_ids', 'staged', 'reused', 'rolled', 'trail'):
        assert port[key] == jax_[key], key
    verdicts = [r[0] for r in port['reports']]
    assert verdicts == ['promoted', 'no_new_data', 'rejected', 'promoted']
    assert [r[1] for r in port['reports']] == ['1', None, None, '2']
    assert port['reports'][2][2] == port['reports'][3][2] == 'capture'
    assert port['reports'][2][3:5] == (2, 210)
    assert port['reused'] >= 6
    assert port['rolled'] == ('vaep', '1')
    assert port['trail']['active'] == ('vaep', '1')
    assert port['trail']['manifests']['2']['new_game_ids'] == port['new_ids']
    assert any('regressed' in r for r in port['rejected_reasons'])
    for col in ('scores', 'concedes'):
        assert 'ece_ci' in port['heads'][col]['candidate'] and 'delta_ece' in port['heads'][col]


def test_port_promoted_checkpoint_rates_in_the_jax_package(full_loops):
    port = full_loops['port']
    path = os.path.join(port['registry'].root, 'vaep', '2')
    jmodel = jax_load_model(path)
    tb = synthetic_batch(3, 192, fill=0.8, seed=8, device='cpu')
    jb = jax_synthetic_batch(3, 192, fill=0.8, seed=8)
    mask = tb.mask.numpy()
    np.testing.assert_allclose(
        port['promoted'].rate_batch(tb).numpy()[mask], np.asarray(jmodel.rate_batch(jb))[mask],
        rtol=0, atol=ATOL,
    )
    # the shadow replay of that candidate: point statistics within 1e-6,
    # bin counts bitwise (the bootstrap draws are each package's own)
    frames = [(_frame(20, n=60), HOME), (_frame(21, n=80), HOME), (_frame(22, n=192), HOME)]
    got = shadow_replay(port['promoted'], frames, max_actions=192, n_boot=8)
    want = jax_shadow_replay(jmodel, frames, max_actions=192, n_boot=8)
    assert (got.n_frames, got.n_actions) == (want.n_frames, want.n_actions) == (3, 332)
    batch = pack_replay_batch(frames, max_actions=192, device='cpu')
    jbatch = jax_pack_replay_batch(frames, max_actions=192)
    for col in ('scores', 'concedes'):
        g, w = got.summaries[col], want.summaries[col]
        assert g.n == w.n
        for key in ('ece', 'brier', 'brier_reliability', 'brier_resolution', 'brier_uncertainty'):
            assert abs(getattr(g, key) - getattr(w, key)) <= 1e-6, (col, key)
        np.testing.assert_allclose(got.probs[col].numpy(), np.asarray(want.probs[col]),
                                   rtol=0, atol=ATOL)
        bins = reliability_curve(got.probs[col], batch.mask.float(), batch.mask.float(),
                                 device='cpu')[2]
        jbins = jcal.reliability_curve(want.probs[col], jbatch.mask, jbatch.mask)[2]
        np.testing.assert_array_equal(bins, np.asarray(jbins))


# -- failure paths --------------------------------------------------------------------------


def _fails_closed(pkg, root, v1):
    p = PKGS[pkg]
    store_path, registry = _env(pkg, root, v1)
    cfg = p.Config(max_actions=64, games_per_batch=2, warm_start=False, fallback_replay_games=0,
                   train_params={'hidden': (16,), 'max_epochs': 0, 'batch_size': 256})
    with p.Store(store_path, mode='a') as store:
        learner = p.Learner(store, registry, config=cfg, prime_watcher=False)
        reports = [learner.run_once(), learner.run_once()]
    return {'reports': [_report(r) for r in reports], 'reasons': reports[0].reasons,
            'trail': _trail(registry, root)}


def _publish_fails(pkg, root, v1):
    p = PKGS[pkg]
    store_path, registry = _env(pkg, root, v1)
    cfg = p.Config(max_actions=64, games_per_batch=2, fallback_replay_games=2,
                   train_params={'max_epochs': 0}, gate=p.Gate(n_boot=8))

    def boom(*_a, **_k):
        raise RuntimeError('registry volume is full')

    registry.promote_candidate = boom
    before = p.metrics.snapshot().value('learn/promotions', verdict='publish_failed')
    with p.Store(store_path, mode='a') as store:
        learner = p.Learner(store, registry, config=cfg, prime_watcher=False)
        with pytest.raises(RuntimeError, match='volume is full'):
            learner.run_once()
    after = p.metrics.snapshot().value('learn/promotions', verdict='publish_failed')
    return {'reports': [_report(learner.last_report)], 'reasons': learner.last_report.reasons,
            'counted': after - before, 'trail': _trail(registry, root)}


def _noop(pkg, root, v1):
    p = PKGS[pkg]
    store_path, registry = _env(pkg, root, v1)
    before = registry.active()[2]
    with p.Store(store_path, mode='a') as store:
        learner = p.Learner(store, registry, config=p.Config(max_actions=64, games_per_batch=2))
        report = learner.run_once()
    return {'reports': [_report(report)], 'same': registry.active()[2] is before,
            'trail': _trail(registry, root)}


FAILURES = {'fails closed without replay traffic': _fails_closed,
            'publish failure recorded then raised': _publish_fails,
            'no new data keeps the active model': _noop}


@pytest.mark.parametrize('case', list(FAILURES))
def test_failure_paths_agree_with_the_jax_package(tmp_path, v1_checkpoint, case):
    out = _both(tmp_path, FAILURES[case], v1_checkpoint)
    port = out['port']
    assert port == out['jax']
    assert port['trail']['active'] == ('vaep', '1') and port['trail']['versions'] == ['1']
    if case.startswith('fails closed'):
        assert [r[0] for r in port['reports']] == ['rejected', 'no_new_data']
        assert 'no replay traffic' in port['reasons'][0]
    elif case.startswith('publish'):
        assert port['reports'][0][0] == 'publish_failed' and port['counted'] == 1
        assert 'volume is full' in port['reasons'][0]
    else:
        assert port['reports'][0][0] == 'no_new_data' and port['same']


# -- restarts over the journal --------------------------------------------------------------


def _killed_at_publish(pkg, root, v1):
    p = PKGS[pkg]
    store_path, registry = _env(pkg, root, v1)
    cfg = _config(pkg, root)
    out = {}
    with p.Store(store_path, mode='a') as store:
        learner1 = p.Learner(store, registry, config=cfg)
        with p.FaultPlan(seed=1, specs=[p.FaultSpec('learn.publish', error=RuntimeError, nth=1)]):
            with pytest.raises(RuntimeError, match='injected fault'):
                learner1.run_once()
        out['first'] = _report(learner1.last_report)
        out['after_crash'] = (registry.versions('vaep'), learner1.journal.replay().pending_stage)
        before = p.metrics.snapshot().value('resil/recoveries', outcome='completed_publish')
        learner2 = p.Learner(store, registry, config=cfg)
        out['recovery'] = learner2.last_recovery['outcome']
        out['counted'] = p.metrics.snapshot().value(
            'resil/recoveries', outcome='completed_publish') - before
        out['closed'] = learner2.journal.replay().open_iteration is None
        out['again'] = _report(learner2.run_once())
        new_ids = append_synthetic_games(store_path, 1, n_actions=A_MAX, seed=91)
    with p.Store(store_path, mode='a') as store:
        out['new'] = (_report(p.Learner(store, registry, config=cfg).run_once()), sorted(new_ids))
    out['trail'] = _trail(registry, root)
    return out


def test_learner_killed_at_publish_resumes_without_retraining(tmp_path, v1_checkpoint):
    out = _both(tmp_path, _killed_at_publish, v1_checkpoint)
    port = out['port']
    assert port == out['jax']
    assert port['first'][0] == 'publish_failed'
    assert port['after_crash'] == (['1'], 'intent_publish')
    assert (port['recovery'], port['counted'], port['closed']) == ('completed_publish', 1, True)
    assert port['again'][0] == 'no_new_data'
    assert port['new'][0][5] == port['new'][1]
    assert port['trail']['versions'][:2] == ['1', '2']


CRASH_STAGES = {
    'consumed': [],
    'verdict_promoted': [('verdict', {'verdict': 'promoted'})],
    'intent_publish': [('verdict', {'verdict': 'promoted'}), ('intent_publish', {'version': '2'})],
    'intent_publish_rename_landed': [
        ('verdict', {'verdict': 'promoted'}), ('intent_publish', {'version': '2'})],
    'published': [('verdict', {'verdict': 'promoted'}), ('intent_publish', {'version': '2'}),
                  ('published', {'version': '2'})],
}


def _restart_at(pkg, root, v1, crash_stage, writer):
    p = PKGS[pkg]
    store_path, registry = _env(pkg, root, v1)
    cfg = _config(pkg, root)
    model = registry.load('vaep', '1')
    tag, _ = registry.stage_candidate('vaep', model, tag='cand-x')
    with p.Store(store_path, mode='a') as store:
        games = store.game_ids()
        j = PKGS[writer].Journal(cfg.journal_path)
        j.append('consumed', games=list(games), tag=tag, model_name='vaep')
        for stage, fields in CRASH_STAGES[crash_stage]:
            j.append(stage, tag=tag, model_name='vaep', **fields)
        if crash_stage in ('intent_publish_rename_landed', 'published'):
            registry.promote_candidate('vaep', '2', tag)
        learner = p.Learner(store, registry, config=cfg)
        state = learner.journal.replay()
        out = {
            'recovery': learner.last_recovery['outcome'],
            'staged': tag in registry.candidates('vaep'),
            'closed': state.open_iteration is None,
            'consumed': state.consumed_games == set(games),
            'loads': bool(registry.load('vaep', registry.versions('vaep')[-1])._models),
            'again': _report(learner.run_once()),
        }
    out['trail'] = _trail(registry, root)
    return out


@pytest.mark.parametrize('writer', ['port', 'jax'])
@pytest.mark.parametrize('crash_stage', list(CRASH_STAGES))
def test_learner_restart_at_every_journal_stage(tmp_path, v1_checkpoint, crash_stage, writer):
    """Each package restarts over a journal the ``writer`` package left."""
    out = _both(tmp_path, _restart_at, v1_checkpoint, crash_stage, writer)
    port = out['port']
    assert port == out['jax']
    assert port['closed'] and port['consumed'] and port['loads']
    assert port['again'][0] == 'no_new_data'
    if crash_stage == 'consumed':
        assert port['recovery'] == 'abandoned' and port['staged']
        assert port['trail']['versions'] == ['1'] and port['trail']['active'] == ('vaep', '1')
    else:
        assert port['recovery'] == 'completed_publish' and not port['staged']
        assert port['trail']['versions'] == ['1', '2'] and port['trail']['active'] == ('vaep', '2')


def _rejected_closes(pkg, root, v1):
    p = PKGS[pkg]
    store_path, registry = _env(pkg, root, v1)
    cfg = _config(pkg, root, fallback_replay_games=0)
    with p.Store(store_path, mode='a') as store:
        learner = p.Learner(store, registry, config=cfg)
        report = learner.run_once()
        state = learner.journal.replay()
        learner2 = p.Learner(store, registry, config=cfg)
        return {'report': _report(report), 'state': (state.open_iteration, state.iterations),
                'recovery': learner2.last_recovery['outcome'],
                'again': _report(learner2.run_once()), 'trail': _trail(registry, root)}


def _prime_gap(pkg, root, v1):
    p = PKGS[pkg]
    store_path, registry = _env(pkg, root, v1)
    cfg = _config(pkg, root)
    with p.Store(store_path, mode='a') as store:
        first = _report(p.Learner(store, registry, config=cfg).run_once())
    landed = append_synthetic_games(store_path, 2, n_actions=A_MAX, seed=55)
    no_journal = p.Config(**{**{f: getattr(cfg, f) for f in (
        'model_name', 'max_actions', 'games_per_batch', 'fallback_replay_games', 'train_params',
        'gate', 'debug_dir')}, 'journal_path': None})
    with p.Store(store_path, mode='a') as store:
        learner3 = p.Learner(store, registry, config=no_journal)  # primes before the retrain
        second = _report(p.Learner(store, registry, config=cfg).run_once())
        third = _report(learner3.run_once())
    return {'reports': [first, second, third], 'landed': sorted(landed),
            'trail': _trail(registry, root)}


def test_rejected_verdict_closes_the_iteration(tmp_path, v1_checkpoint):
    out = _both(tmp_path, _rejected_closes, v1_checkpoint)
    port = out['port']
    assert port == out['jax']
    assert port['report'][0] == 'rejected' and port['state'] == (None, 1)
    assert port['recovery'] is None and port['again'][0] == 'no_new_data'


def test_journal_prime_covers_the_restart_gap(tmp_path, v1_checkpoint):
    out = _both(tmp_path, _prime_gap, v1_checkpoint)
    port = out['port']
    assert port == out['jax']
    assert port['reports'][0][0] == 'promoted'
    assert port['reports'][1][5] == port['landed']
    assert port['reports'][2][0] == 'no_new_data'


def test_drift_watch_from_manifest_matches_in_process_bit_for_bit(tmp_path, v1_checkpoint):
    """A watch rebuilt from the promoted version's manifest carries the
    reference the learner froze; the JAX package's learner writes the same
    reference games (the candidate is version 1's weights, 0 epochs)."""
    out = {}
    for pkg in PKGS:
        root = str(tmp_path / pkg)
        store_path, registry = _env(pkg, root, v1_checkpoint, n_games=3)
        drift = PKGS[pkg].Drift(min_actions=32, reference_games=2, n_bins=8)
        cfg = _config(pkg, root, drift=drift)
        with PKGS[pkg].Store(store_path, mode='a') as store:
            report = PKGS[pkg].Learner(store, registry, config=cfg).run_once()
            assert report.verdict == 'promoted'
            manifest = registry.load_manifest('vaep', report.candidate_version)
            assert manifest['trained_game_ids'] == sorted(store.game_ids(), key=str)
            if pkg == 'port':
                restarted = DriftWatch.from_manifest(manifest, drift)
                home = store.home_team_ids()
                frames = [(store.get_actions(g), home.get(g))
                          for g in manifest['drift_reference_games']]
                batch = pack_replay_batch(frames, max_actions=A_MAX, device='cpu')
                inproc = build_drift_reference(
                    registry.load('vaep', report.candidate_version), batch, drift)
                assert restarted.reference.names == inproc.names
                np.testing.assert_array_equal(restarted.reference.lo, inproc.lo)
                np.testing.assert_array_equal(restarted.reference.hi, inproc.hi)
                np.testing.assert_array_equal(restarted.reference.props, inproc.props)
                assert restarted.reference.n_actions == inproc.n_actions
        out[pkg] = manifest
    port, jax_ = out['port'], out['jax']
    for key in ('trained_game_ids', 'new_game_ids', 'drift_reference_games', 'model_name'):
        assert port[key] == jax_[key], key
    pref, jref = port['drift_reference'], jax_['drift_reference']
    assert pref['names'] == jref['names'] and pref['n_actions'] == jref['n_actions']
    np.testing.assert_allclose(pref['lo'], jref['lo'], rtol=0, atol=ATOL)
    np.testing.assert_allclose(pref['hi'], jref['hi'], rtol=0, atol=ATOL)


# -- across the packages --------------------------------------------------------------------


def test_journal_and_registry_carry_on_across_the_packages(tmp_path, v1_checkpoint):
    """The JAX package's learner bootstraps; the port's carries on over its
    journal and registry; the JAX package's reads the result."""
    root = str(tmp_path)
    store_path = os.path.join(root, 'season')
    write_synthetic_season(store_path, n_games=2, n_actions=A_MAX)
    jreg = JaxRegistry(os.path.join(root, 'registry'))
    jcfg = _config('jax', root)
    with JaxStore(store_path, mode='a') as jstore:
        boot = JaxLearner(jstore, jreg, config=JaxConfig(**{
            **{f: getattr(jcfg, f) for f in ('model_name', 'max_actions', 'games_per_batch',
                                               'fallback_replay_games', 'gate', 'journal_path',
                                               'debug_dir')},
            'train_params': {'hidden': (16,), 'max_epochs': 2, 'batch_size': 256}}))
        assert boot.run_once().verdict == 'promoted'
    registry = ModelRegistry(jreg.root, device='cpu')
    registry.activate('vaep', '1')
    cfg = _config('port', root)
    with SeasonStore(store_path, mode='a') as store:
        learner = ContinuousLearner(store, registry, config=cfg)
        assert learner.last_recovery['outcome'] is None
        assert learner.last_recovery['consumed_games'] == 2
        assert learner.run_once().verdict == 'no_new_data'
        new_ids = append_synthetic_games(store_path, 1, n_actions=A_MAX, seed=91)
        report = learner.run_once()
        assert (report.verdict, report.candidate_version) == ('promoted', '2')
        assert report.new_games == new_ids
    assert [e['stage'] for e in JaxJournal(cfg.journal_path).entries()] == [
        'consumed', 'verdict', 'intent_publish', 'published', 'activated'] * 2
    with JaxStore(store_path, mode='a') as jstore:
        jreg.activate('vaep', '2')
        restarted = JaxLearner(jstore, jreg, config=jcfg)
        assert restarted.last_recovery['consumed_games'] == 3
        assert restarted.run_once().verdict == 'no_new_data'
    tb = synthetic_batch(2, A_MAX, fill=0.8, seed=8, device='cpu')
    jb = jax_synthetic_batch(2, A_MAX, fill=0.8, seed=8)
    mask = tb.mask.numpy()
    np.testing.assert_allclose(registry.active()[2].rate_batch(tb).numpy()[mask],
                               np.asarray(jreg.active()[2].rate_batch(jb))[mask], rtol=0, atol=ATOL)


def test_a_service_with_a_capture_ring_builds_over_the_learners_registry(tmp_path, v1_checkpoint):
    """What the JAX loop reads through a service (its capture ring) builds
    over the learner's registry."""
    registry = ModelRegistry(str(tmp_path / 'registry'), device='cpu')
    registry.publish('vaep', '1', load_model(v1_checkpoint, device='cpu'))
    registry.activate('vaep', '1')
    capture = TrafficCapture()
    with RatingService(registry=registry, capture=capture) as svc:
        assert svc.capture is capture


def test_bootstrap_builds_a_default_vaep_on_the_learners_device(tmp_path):
    store_path = str(tmp_path / 'season')
    write_synthetic_season(store_path, n_games=2, n_actions=A_MAX)
    registry = ModelRegistry(str(tmp_path / 'registry'), device='cpu')
    cfg = LearnConfig(max_actions=A_MAX, games_per_batch=2, gate=GateConfig(n_boot=8),
                      train_params={'hidden': (8,), 'max_epochs': 1, 'batch_size': 256})
    with SeasonStore(store_path, mode='a') as store:
        learner = ContinuousLearner(store, registry, config=cfg)
        assert learner.device == registry.device == torch.device('cpu')
        report = learner.run_once()
    assert (report.verdict, report.candidate_version) == ('promoted', '1')
    assert report.replay['source'] == 'store_fallback_in_sample'
    assert report.archs == {'scores': 'mlp', 'concedes': 'mlp'}
    model = registry.active()[2]
    assert type(model) is VAEP and model.device.type == 'cpu'
    assert report.stage_seconds.keys() >= {'ingest', 'train', 'shadow', 'gate', 'publish'}
    train = REGISTRY.snapshot().series('learn/stage_seconds', stage='train')
    assert train is not None and train.count >= 1
