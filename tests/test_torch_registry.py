"""The port's model registry, iteration journal and traffic ring against the
JAX package's.

Counterparts of ``tests/test_learn.py``'s registry and capture tests,
``tests/test_resil.py``'s registry-load retry and journal tests, and the
manifest case of ``tests/test_chaos.py``, on the CPU. Each registry
scenario runs the same operations on both packages' registries, on the same
weights, and their outcomes (values, errors, paths under the root, counter
deltas) must be equal. Journals and registries are read across the
packages: a journal either package writes
replays to the same state in both, and a registry either package writes
loads in the other (ratings within 1e-5: the same weights, f32 sums in
another order).
"""

import os
from types import SimpleNamespace

import numpy as np
import pytest
import torch

from socceraction_tpu.core.synthetic import synthetic_actions_frame
from socceraction_tpu.core.synthetic import synthetic_batch as jax_synthetic_batch
from socceraction_tpu.obs import REGISTRY as JAX_REGISTRY
from socceraction_tpu.resil import FaultPlan as JaxFaultPlan
from socceraction_tpu.resil import FaultSpec as JaxFaultSpec
from socceraction_tpu.resil import IterationJournal as JaxJournal
from socceraction_tpu.serve import ModelRegistry as JaxRegistry
from socceraction_tpu.serve import TrafficCapture as JaxCapture
from socceraction_tpu.vaep.base import load_model as jax_load_model
from socceraction_tpu_torch.core.synthetic import synthetic_batch
from socceraction_tpu_torch.obs import REGISTRY, drain_guards, owned_bytes
from socceraction_tpu_torch.resil import FaultPlan, FaultSpec, IterationJournal, JournalState
from socceraction_tpu_torch.serve import ModelRegistry, TrafficCapture
from socceraction_tpu_torch.vaep.base import VAEP

HOME = 100
#: port against JAX ratings of the same checkpoint (f32, another sum order)
ATOL = 1e-5


@pytest.fixture(scope='module', autouse=True)
def _drain_guards():
    """Leave the process-wide guard ring empty for the next module: this
    one's ratings note guards no test here drains."""
    yield
    drain_guards()


def _snap(name, **labels):
    return REGISTRY.snapshot().value(name, **labels)


@pytest.fixture(scope='module')
def tiny_model():
    return VAEP(device='cpu').fit_packed(
        synthetic_batch(2, 256, seed=3, device='cpu'),
        tree_params={'hidden': (16,), 'batch_size': 256, 'max_epochs': 2}, random_state=0,
    )


def _registry(tmp_path):
    return ModelRegistry(str(tmp_path / 'reg'), device='cpu')


@pytest.fixture(scope='module')
def models(tiny_model, tmp_path_factory):
    """The same weights in both packages: the port's tiny model and the JAX
    package's load of its checkpoint."""
    path = str(tmp_path_factory.mktemp('ckpt'))
    tiny_model.save_model(path)
    return {'port': tiny_model, 'jax': jax_load_model(path)}


PKGS = {
    'jax': SimpleNamespace(registry=JaxRegistry, metrics=JAX_REGISTRY,
                           FaultPlan=JaxFaultPlan, FaultSpec=JaxFaultSpec),
    'port': SimpleNamespace(registry=lambda root: ModelRegistry(root, device='cpu'),
                            metrics=REGISTRY, FaultPlan=FaultPlan, FaultSpec=FaultSpec),
}


def _rel(value, root):
    """``value`` with the registry's root written as ``<root>``."""
    if isinstance(value, str):
        return value.replace(root, '<root>')
    if isinstance(value, (list, tuple)):
        return type(value)(_rel(v, root) for v in value)
    return value


def _try(root, fn, *args, **kwargs):
    """What one registry call gives: ``('ok', value)``, or its error's type
    and message, with paths under the root written relative to it."""
    try:
        return ('ok', _rel(fn(*args, **kwargs), root))
    except Exception as e:  # the outcome under comparison
        return (type(e).__name__, _rel(str(e), root))


def _both(tmp_path, scenario, models):
    """``scenario(p, registry, model, root)`` run on each package's registry
    (each in a root of its own) on the same weights."""
    out = {}
    for pkg, p in PKGS.items():
        root = str(tmp_path / pkg / 'reg')
        out[pkg] = scenario(p, p.registry(root), models[pkg], root)
    return out


def _delta(p, name, fn, **labels):
    before = p.metrics.snapshot().value(name, **labels)
    value = fn()
    return value, p.metrics.snapshot().value(name, **labels) - before


# -- the registry: the same operations in both packages ---------------------------------


def _lifecycle(p, reg, model, root):
    seen = [_try(root, reg.publish, 'vaep', '1', model)]
    for i in range(3):
        tag, path = reg.stage_candidate('vaep', model, tag=f'cand-{i}')
        seen.append((tag, _rel(path, root), os.path.isfile(os.path.join(path, 'meta.json'))))
        os.utime(path, (1e9 + i, 1e9 + i))  # mtime order, whatever the clock's resolution
    seen += [reg.versions('vaep'), reg.candidates('vaep'), reg.next_version('vaep')]
    seen.append(_try(root, reg.promote_candidate, 'vaep', '2', 'cand-1'))
    seen += [reg.versions('vaep'), reg.candidates('vaep'), sorted(reg.load('vaep', '2')._models)]
    removed, expired = _delta(p, 'serve/candidates_expired', lambda: reg.gc_candidates('vaep', keep=1))
    seen += [_rel(removed, root), expired, reg.candidates('vaep')]
    for call, args in (
        (reg.stage_candidate, ('vaep', model, 'cand-2')),
        (reg.stage_candidate, ('vaep', model, '.sneaky')),
        (reg.promote_candidate, ('vaep', '1', 'cand-2')),
        (reg.promote_candidate, ('vaep', '3', 'absent')),
        (reg.publish, ('vaep', '1', model)),
        (reg.load, ('vaep', '9')),
        (reg.load_manifest, ('vaep', '9')),
    ):
        if call == reg.stage_candidate:
            seen.append(_try(root, call, *args[:2], tag=args[2]))
        else:
            seen.append(_try(root, call, *args))
    seen += [_rel(reg.gc_candidates(keep=0), root), reg.candidates('vaep')]
    return seen


def test_registry_candidate_lifecycle(tmp_path, models):
    out = _both(tmp_path, _lifecycle, models)
    port = out['port']
    assert port == out['jax']
    assert port[4:7] == [['1'], ['cand-0', 'cand-1', 'cand-2'], '2']
    assert port[7] == ('ok', '<root>/vaep/2')
    assert port[8:10] == [['1', '2'], ['cand-0', 'cand-2']]
    assert port[11:14] == [['<root>/vaep/.candidates/cand-0'], 1, ['cand-2']]
    errors = port[14:21]
    assert [e[0] for e in errors[:6]] == ['ValueError', 'ValueError', 'ValueError',
                                          'FileNotFoundError', 'ValueError', 'FileNotFoundError']
    assert errors[6] == ('ok', None)  # no manifest read as absent, not an error
    assert 'already staged' in errors[0][1] and 'invalid' in errors[1][1]
    assert 'immutable' in errors[2][1] and 'immutable' in errors[4][1]
    assert port[21:] == [['<root>/vaep/.candidates/cand-2'], []]


def _rollback(p, reg, model, root):
    reg.publish('vaep', '1', model)
    reg.publish('vaep', '2', model)
    seen = [_try(root, reg.rollback), _try(root, lambda: reg.active()[:2]), reg.previous()]
    seen.append(_delta(p, 'serve/model_swaps', lambda: reg.activate('vaep', '1')))
    seen.append(reg.previous())
    seen.append(_delta(p, 'serve/model_swaps', lambda: reg.activate('vaep', '2')))
    seen += [reg.previous(), _try(root, reg.rollback, expected=('vaep', '9'))]
    seen.append(_delta(p, 'serve/model_swaps', lambda: reg.rollback(expected=('vaep', '1')),
                       reason='rollback'))
    seen += [reg.active()[:2], reg.previous(), _try(root, reg.activate, 'vaep', '7')]
    seen += [reg.active()[:2], reg.previous()]
    return seen


def test_registry_rollback(tmp_path, models):
    out = _both(tmp_path, _rollback, models)
    port = out['port']
    assert port == out['jax']
    assert port[0][0] == 'RuntimeError' and 'previous' in port[0][1]
    assert port[1][0] == 'RuntimeError' and 'no active model' in port[1][1]
    assert port[2] is None and port[3] == (('vaep', '1'), 1.0) and port[4] is None
    assert port[5:7] == [(('vaep', '2'), 1.0), ('vaep', '1')]
    assert port[7][0] == 'RuntimeError' and 'changed concurrently' in port[7][1]
    assert port[8] == (('vaep', '1'), 1.0)
    assert port[9:11] == [('vaep', '1'), ('vaep', '2')]
    assert port[11][0] == 'FileNotFoundError'
    assert port[12:] == [('vaep', '1'), ('vaep', '2')]


def _version_order(p, reg, model, root):
    for v in ('2', '10', '9', 'rc1'):
        reg.publish('vaep', v, model)
    reg.publish('xt', '1', model)
    return [reg.versions('vaep'), reg.resolve_version('vaep', None), reg.next_version('vaep'),
            reg.next_version('absent'), reg.names(), reg.versions('absent'),
            _try(root, reg.resolve_version, 'vaep', '7'), _try(root, reg.resolve_version, 'absent', None),
            _try(root, reg.publish, '../up', '1', model),
            _try(root, reg.publish, 'vaep', '../11', model)]


def test_version_order_is_numeric(tmp_path, models):
    out = _both(tmp_path, _version_order, models)
    port = out['port']
    assert port == out['jax']
    assert port[:6] == [['2', '9', '10', 'rc1'], 'rc1', '11', '1', ['vaep', 'xt'], []]
    assert port[6] == ('ok', '7')  # a pinned version is taken as given
    assert [e[0] for e in port[7:]] == ['FileNotFoundError', 'ValueError', 'ValueError']


def _load_cache(p, reg, model, root):
    for v in ('1', '2', '3'):
        reg.publish('vaep', v, model)
    reg.activate('vaep', '1')
    m = reg.load('vaep', '1')
    claim = reg._claims[('vaep', '1')]
    seen = [reg.load('vaep', '1') is m, sorted(reg._loaded), sorted(reg._claims)]
    reg.activate('vaep', '2')
    seen += [claim.released, sorted(reg._loaded), sorted(reg._claims)]
    reg.activate('vaep', '3')
    seen += [claim.released, sorted(reg._loaded), sorted(reg._claims)]
    reg.rollback()
    seen += [sorted(reg._loaded), sorted(reg._claims), reg.load('vaep', '1') is m]
    return seen


def test_load_cache_and_claims_keep_active_and_previous(tmp_path, models):
    out = _both(tmp_path, _load_cache, models)
    port = out['port']
    assert port == out['jax']
    v = [('vaep', str(i)) for i in (1, 2, 3)]
    # pruned to active + previous: version 1's claim released once 3 is active
    assert port == [True, v[:1], v[:1], False, v[:2], v[:2], True, v[1:], v[1:],
                    v[1:], v[1:], False]
    reg = _registry(tmp_path)
    reg.publish('vaep', '1', models['port'])
    reg.activate('vaep', '1')
    m = reg.load('vaep', '1')
    want = sum(p.nbytes for h in m._models.values() for p in h.module.parameters())
    want += sum(h.mean_.nbytes + h.std_.nbytes for h in m._models.values())
    want += sum(a.nbytes for a in m.serving_arrays())
    assert m.serving_arrays()  # warm built the fold
    assert reg._claims[('vaep', '1')].nbytes == want
    assert owned_bytes()['registry'] >= want


def _retries(p, reg, model, root):
    reg.publish('vaep', '1', model)
    spec = p.FaultSpec('registry.load', error=OSError, nth=1)

    def load():
        with p.FaultPlan(seed=0, specs=[spec]):
            return sorted(reg.load('vaep', '1')._models)

    return _delta(p, 'resil/retries', load, site='registry.load', outcome='recovered')


def test_registry_load_retries_injected_transient_fault(tmp_path, models):
    out = _both(tmp_path, _retries, models)
    assert out['port'] == out['jax'] == (['concedes', 'scores'], 1.0)


def _corrupt(p, reg, model, root):
    path = reg.publish('vaep', '1', model)
    artifact = os.path.join(path, 'models', 'scores.npz')
    data = bytearray(open(artifact, 'rb').read())
    data[len(data) // 2] ^= 0xFF
    with open(artifact, 'wb') as f:
        f.write(bytes(data))
    outcome, retried = _delta(p, 'resil/retries', lambda: _try(root, reg.load, 'vaep', '1'),
                              site='registry.load', outcome='recovered')
    return outcome[0], 'scores.npz' in outcome[1], retried


def test_registry_load_refuses_a_corrupt_artifact_without_retrying(tmp_path, models):
    out = _both(tmp_path, _corrupt, models)
    assert out['port'] == out['jax'] == ('ValueError', True, 0.0)


def _manifest(p, reg, model, root):
    reg.publish('vaep', '1', model)
    seen = [reg.load_manifest('vaep', '1')]
    tag, _ = reg.stage_candidate('vaep', model, tag='m', manifest={'trained_game_ids': [3, 1]})
    reg.promote_candidate('vaep', '2', tag)
    seen += [reg.load_manifest('vaep', '2'), reg.load_manifest('vaep')]
    with open(os.path.join(root, 'vaep', '2', 'manifest.json'), 'w') as f:
        f.write('{"torn')
    seen.append(_try(root, reg.load_manifest, 'vaep', '2')[0])
    return seen


def test_manifest_absent_for_bootstrap_versions(tmp_path, models):
    out = _both(tmp_path, _manifest, models)
    assert out['port'] == out['jax']
    assert out['port'] == [None] + [{'trained_game_ids': [3, 1]}] * 2 + ['JSONDecodeError']


def test_warm_refuses_a_model_on_another_device(tmp_path):
    reg = _registry(tmp_path)

    class Elsewhere:
        device = torch.device('meta')

    with pytest.raises(ValueError, match='registry on cpu'):
        reg.warm(Elsewhere())


# -- registries across the packages ------------------------------------------------------


def _ratings(model, n_games=2, n_actions=256):
    tb = synthetic_batch(n_games, n_actions, fill=0.8, seed=8, device='cpu')
    return model.rate_batch(tb).numpy()[tb.mask.numpy()]


def _jax_ratings(model, n_games=2, n_actions=256):
    jb = jax_synthetic_batch(n_games, n_actions, fill=0.8, seed=8)
    mask = synthetic_batch(n_games, n_actions, fill=0.8, seed=8, device='cpu').mask.numpy()
    return np.asarray(model.rate_batch(jb))[mask]


def test_port_registry_loads_in_the_jax_package(tmp_path, tiny_model):
    reg = _registry(tmp_path)
    reg.publish('vaep', '1', tiny_model)
    tag, _ = reg.stage_candidate('vaep', tiny_model, manifest={'trained_game_ids': [0, 1]})
    jreg = JaxRegistry(reg.root)
    assert jreg.versions('vaep') == ['1'] and jreg.candidates('vaep') == [tag]
    jreg.promote_candidate('vaep', jreg.next_version('vaep'), tag)
    assert jreg.load_manifest('vaep', '2') == {'trained_game_ids': [0, 1]}
    jreg.activate('vaep', '2')
    np.testing.assert_allclose(_jax_ratings(jreg.active()[2]), _ratings(tiny_model), rtol=0, atol=ATOL)
    # and back: the port reads the version the JAX package promoted
    assert reg.versions('vaep') == ['1', '2']
    assert np.array_equal(_ratings(reg.load('vaep', '2')), _ratings(tiny_model))


def test_jax_registry_loads_in_the_port(tmp_path, tiny_model):
    tiny_model.save_model(str(tmp_path / 'ckpt'))
    jmodel = jax_load_model(str(tmp_path / 'ckpt'))
    jreg = JaxRegistry(str(tmp_path / 'reg'))
    jreg.publish('vaep', '1', jmodel)
    jreg.stage_candidate('vaep', jmodel, tag='cand-a', manifest={'new_game_ids': [7]})
    reg = _registry(tmp_path)
    reg.activate('vaep', '1')
    assert reg.candidates('vaep') == ['cand-a']
    reg.promote_candidate('vaep', '2', 'cand-a')
    reg.activate('vaep', '2')
    assert reg.load_manifest('vaep') == {'new_game_ids': [7]}
    np.testing.assert_allclose(_ratings(reg.active()[2]), _jax_ratings(jmodel), rtol=0, atol=ATOL)
    assert reg.rollback() == ('vaep', '1')


# -- the traffic ring -------------------------------------------------------------------


def _frame(i, n=40):
    return synthetic_actions_frame(
        game_id=i, home_team_id=HOME, away_team_id=HOME + 1, seed=i, n_actions=n,
    )


def _drive_capture(cap):
    """The JAX test's schedule; returns what each step observes."""
    seen = []
    for i in range(4):
        cap.record_frame(_frame(i, n=20), HOME)
    seen.append([len(f) for f, _ in cap.frames()])
    cap.record_session('m1', _frame(10, n=12), HOME)
    cap.record_session('m1', _frame(11, n=12), HOME)
    seen.append(sorted(len(f) for f, _ in cap.frames()))
    cap.record_session('m1', _frame(12, n=20), HOME)  # 44 > 35: drop the first part
    seen.append(sorted(len(f) for f, _ in cap.frames()))
    cap.record_session('m2', _frame(13, n=50), HOME)  # one part alone keeps its newest rows
    seen.append(sorted(len(f) for f, _ in cap.frames()))
    cap.record_session('m3', _frame(14, n=5), HOME)  # evicts the least recent stream (m1)
    seen.append((len(cap), cap.total_actions))
    seen.append([(f.reset_index(drop=True).to_dict('list'), h) for f, h in cap.frames()])
    cap.clear()
    seen.append((len(cap), cap.total_actions))
    return seen


def test_capture_ring_matches_the_jax_package():
    kw = dict(max_frames=2, max_sessions=2, max_session_actions=35)
    before = _snap('serve/capture_evictions', kind='session')
    got = _drive_capture(TrafficCapture(**kw))
    assert got == _drive_capture(JaxCapture(**kw))
    assert got[0] == [20, 20] and got[2] == [20, 20, 32] and got[4] == (4, 80)
    assert _snap('serve/capture_evictions', kind='session') == before + 1


def test_capture_frames_are_copies():
    cap = TrafficCapture(max_frames=4)
    frame = _frame(1, n=10)
    cap.record_frame(frame, HOME)
    frame.loc[:, 'start_x'] = -1.0
    out, _ = cap.frames()[0]
    assert (out['start_x'] >= 0).all()
    out.loc[:, 'start_x'] = -2.0
    assert (cap.frames()[0][0]['start_x'] >= 0).all()


@pytest.mark.parametrize('kw', [{'max_frames': 0}, {'max_sessions': 0}, {'max_session_actions': 0}])
def test_capture_disabled_records_nothing(kw):
    cap, jcap = TrafficCapture(**kw), JaxCapture(**kw)
    for c in (cap, jcap):
        c.record_frame(_frame(1, n=10), HOME)
        c.record_session('m', _frame(2, n=10), HOME)
    assert (len(cap), cap.total_actions) == (len(jcap), jcap.total_actions)


# -- the iteration journal --------------------------------------------------------------

JOURNALS = {
    'port': (IterationJournal, IterationJournal),
    'jax writes, port replays': (JaxJournal, IterationJournal),
    'port writes, jax replays': (IterationJournal, JaxJournal),
}


def _state(state):
    return (state.consumed_games, state.iterations, state.pending_stage, state.open_iteration,
            state.skipped_lines)


@pytest.mark.parametrize('pair', list(JOURNALS))
def test_journal_append_is_durable_jsonl_and_replays(tmp_path, pair):
    write, read = JOURNALS[pair]
    path = str(tmp_path / 'journal.jsonl')
    j = write(path)
    j.append('consumed', games=[1, 2], tag='cand-a', model_name='vaep')
    j.append('verdict', verdict='rejected', tag='cand-a')
    j.append('consumed', games=[3], tag='cand-b', model_name='vaep')
    r = read(path)
    state = r.replay()
    assert state.consumed_games == {1, 2, 3}
    assert state.iterations == 1
    assert state.pending_stage == 'consumed'
    assert state.open_iteration['tag'] == 'cand-b'
    assert [e['stage'] for e in r.entries()] == ['consumed', 'verdict', 'consumed']
    assert r.tail(2) == r.entries()[-2:]
    assert _state(IterationJournal(path).replay()) == _state(JaxJournal(path).replay())


@pytest.mark.parametrize('pair', list(JOURNALS))
def test_journal_torn_tail_is_skipped_not_fatal(tmp_path, pair):
    write, read = JOURNALS[pair]
    path = str(tmp_path / 'journal.jsonl')
    j = write(path)
    j.append('consumed', games=[1], tag='t', model_name='vaep')
    j.append('verdict', verdict='promoted', tag='t')
    with open(path, 'a', encoding='utf-8') as f:
        f.write('{"stage": "published", "versi')  # crash mid-append
    state = read(path).replay()
    assert state.skipped_lines == 1
    assert state.pending_stage == 'verdict'
    assert state.open_iteration['verdict'] == 'promoted'
    read(path).append('published', version='2', tag='t')
    assert write(path).replay().pending_stage == 'published'
    assert _state(IterationJournal(path).replay()) == _state(JaxJournal(path).replay())


@pytest.mark.parametrize('pair', list(JOURNALS))
def test_journal_full_iteration_closes_on_activated(tmp_path, pair):
    write, read = JOURNALS[pair]
    path = str(tmp_path / 'j.jsonl')
    j = write(path)
    j.append('consumed', games=['g1'], tag='t', model_name='vaep')
    j.append('verdict', verdict='promoted', tag='t')
    j.append('intent_publish', version='2', tag='t')
    j.append('published', version='2', tag='t')
    j.append('activated', version='2', tag='t')
    state = read(path).replay()
    assert state.iterations == 1
    assert state.open_iteration is None and state.pending_stage is None
    assert state.consumed_games == {'g1'}


def test_journal_missing_file_replays_empty(tmp_path):
    state = IterationJournal(str(tmp_path / 'absent.jsonl')).replay()
    assert isinstance(state, JournalState)
    assert state.consumed_games == set()
    assert state.open_iteration is None and state.iterations == 0


def test_journal_lines_are_the_jax_packages(tmp_path, monkeypatch):
    """Same entries, same bytes: keys sorted, one line each, a stray entry
    with no open iteration ignored by both replays."""
    import time as _time

    monkeypatch.setattr(_time, 'time', lambda: 1700000000.123456)
    paths = [str(tmp_path / 'port.jsonl'), str(tmp_path / 'jax.jsonl')]
    for cls, path in zip((IterationJournal, JaxJournal), paths):
        j = cls(path)
        j.append('activated', version='0', tag='stray')
        j.append('consumed', games=[5, 'g6'], tag='t', model_name='vaep', recovered=True)
        j.append('verdict', verdict='abandoned', tag='t', recovered=True)
    port, jax_ = (open(p, 'rb').read() for p in paths)
    assert port == jax_
    assert _state(IterationJournal(paths[0]).replay()) == _state(JaxJournal(paths[1]).replay())
