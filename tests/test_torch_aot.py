"""The port's serving warm tier: shipped kernel libraries, on the CPU.

Counterparts of ``tests/test_aot.py``. The JAX package ships compiled XLA
executables; the port ships the shared libraries of its hand-written
kernels (``csrc/gather_matmul.cu``, ``csrc/segment_sum.cu``). There is no
``nvcc`` here, so each test plants loadable shared objects (extension
modules of this interpreter) where the build would have put the
libraries, and exports, checks, installs and loads those:

- the manifest's grammar (fingerprint, entries with ids, sha256 and
  bytes, ladder, ``max_actions``) is the JAX package's, plus the model's
  layout signature; ``read_manifest`` imports neither torch nor numpy;
- ``fingerprint_diff`` compares over the union of keys, as in JAX;
- a doctored fingerprint and another layout read ``stale``, a truncated
  library a named ``miss``, an absent manifest an uncounted ``miss``, and
  none of them fails a warm-up or a swap;
- ``registry.aot`` faults are retried to a ``hit`` or end in a ``miss``;
- a candidate's libraries ride the promotion's rename;
- a hit puts each library where ``load_library`` finds it, so no
  ``nvcc`` runs and ``dispatch/kernel_builds`` stays where it was.
"""

import ctypes
import hashlib
import importlib
import json
import os
import subprocess
import sys

import numpy as np
import pytest

from socceraction_tpu.serve.aot import fingerprint_diff as jax_fingerprint_diff
from socceraction_tpu.serve.aot import load_serving_aot as jax_load_serving_aot
from socceraction_tpu_torch.config import COMPILE_CACHE_ENV, compile_cache_dir
from socceraction_tpu_torch.learn.loop import LearnConfig
from socceraction_tpu_torch.obs import REGISTRY
from socceraction_tpu_torch.obs.coldstart import PHASES
from socceraction_tpu_torch.obs.recorder import RECORDER
from socceraction_tpu_torch.ops import cuda_build
from socceraction_tpu_torch.resil.faults import FaultPlan, FaultSpec
from socceraction_tpu_torch.serve import ModelRegistry, RatingService
from socceraction_tpu_torch.serve.aot import (
    AOT_DIRNAME,
    AOT_FORMAT,
    KERNELS,
    enable_compile_cache,
    env_fingerprint,
    export_serving_aot,
    fingerprint_diff,
    last_aot_load,
    load_serving_aot,
    read_manifest,
)
from tests.test_torch_serve import HOME, WAIT, _fit, _frame, _reference

LADDER = (1, 2)
MAX_ACTIONS = 256
AOT = {'ladder': LADDER, 'max_actions': MAX_ACTIONS}
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _shared_objects():
    """Two shared objects ``dlopen`` accepts: extension modules of this
    interpreter, standing in for the two kernel libraries."""
    found = []
    for name in ('_ctypes', '_json', '_struct', '_bisect', '_heapq', 'select', '_socket'):
        path = getattr(importlib.import_module(name), '__file__', None) or ''
        if path.endswith('.so'):
            found.append(path)
    assert len(found) >= 2, found
    return dict(zip(KERNELS, found))


@pytest.fixture
def cache(tmp_path, monkeypatch):
    """A compile cache in which the two libraries are already built (the
    publisher's), and a clean slate of loaded libraries."""
    path = tmp_path / 'publisher-cache'
    path.mkdir()
    monkeypatch.setenv(COMPILE_CACHE_ENV, str(path))
    monkeypatch.setattr(cuda_build, '_loaded', {})
    monkeypatch.setattr(cuda_build, '_paths', {})
    monkeypatch.setattr(cuda_build, 'build_seconds', {})
    planted = {}
    for name, so in _shared_objects().items():
        with open(so, 'rb') as f:
            blob = f.read()
        cuda_build.library_path(name).write_bytes(blob)
        planted[name] = blob
    return planted


def _no_nvcc():
    raise AssertionError('nvcc must not run')


@pytest.fixture(scope='module')
def model():
    return _fit(3, (8,))


@pytest.fixture(scope='module')
def other_model():
    """Another head width: another layout."""
    return _fit(4, (13,))


def _loads(outcome):
    return REGISTRY.snapshot().value('serve/aot_loads', outcome=outcome)


def _builds():
    return sum(REGISTRY.snapshot().value('dispatch/kernel_builds', kernel=k) for k in KERNELS)


def _publish(tmp_path, model, version='1'):
    registry = ModelRegistry(str(tmp_path / 'registry'), device='cpu')
    registry.publish('vaep', version, model, aot=AOT)
    registry.activate('vaep', version)
    return registry


# -- export -----------------------------------------------------------------------------------


def test_export_writes_manifest_fingerprint_and_checksums(tmp_path, model, cache):
    registry = _publish(tmp_path, model)
    aot_dir = registry.aot_dir('vaep', '1')
    manifest = read_manifest(aot_dir)
    assert manifest['format'] == AOT_FORMAT == 1
    assert manifest['ladder'] == list(LADDER) and manifest['max_actions'] == MAX_ACTIONS
    assert set(manifest) == {'format', 'fingerprint', 'created_unix', 'ladder', 'max_actions',
                             'signature', 'entries'}
    assert [e['id'] for e in manifest['entries']] == list(KERNELS)
    for entry in manifest['entries']:
        with open(os.path.join(aot_dir, entry['file']), 'rb') as f:
            blob = f.read()
        assert blob == cache[entry['id']]
        assert hashlib.sha256(blob).hexdigest() == entry['sha256']
        assert entry['nbytes'] == len(blob)
        assert entry['digest'] == cuda_build.library_digest(entry['id'])
        assert entry['file'] == cuda_build.library_path(entry['id']).name
    assert manifest['fingerprint'] == env_fingerprint('cpu')
    for key in ('aot_format', 'torch', 'cuda', 'device_kind', 'compute_capability',
                'platform_profile_sha256', 'rating_path', 'guards', 'checkpoint_format',
                'library_gather_matmul', 'library_segment_sum'):
        assert key in manifest['fingerprint']
    assert 'family=standard' in manifest['signature'] and 'MLPClassifier' in manifest['signature']


def test_read_manifest_imports_neither_torch_nor_numpy(tmp_path, model, cache):
    """The control plane reads a shipped fingerprint without the heavy
    stack: the serve package loads its names lazily and ``read_manifest``
    is stdlib-only."""
    aot_dir = _publish(tmp_path, model).aot_dir('vaep', '1')
    code = (
        'import sys\n'
        'from socceraction_tpu_torch.serve.aot import read_manifest\n'
        f'manifest = read_manifest({aot_dir!r})\n'
        "assert manifest['ladder'] == [1, 2]\n"
        "assert 'library_gather_matmul' in manifest['fingerprint']\n"
        "bad = [m for m in ('torch', 'numpy', 'pandas', 'jax') if m in sys.modules]\n"
        "assert not bad, f'heavy modules leaked: {bad}'\n"
    )
    proc = subprocess.run([sys.executable, '-c', code], capture_output=True, text=True, cwd=ROOT,
                          timeout=120)
    assert proc.returncode == 0, proc.stderr


def test_a_failed_export_leaves_publish_retryable(tmp_path, model, cache, monkeypatch):
    """A model off the fused path cannot ship B1: the publish fails with
    the JAX package's message and leaves no version behind, and the same
    publish succeeds once the path is fused."""
    registry = ModelRegistry(str(tmp_path / 'registry'), device='cpu')
    monkeypatch.setenv('SOCCERACTION_TPU_RATING_PATH', 'materialized')
    with pytest.raises(ValueError, match='fused serving path'):
        registry.publish('retry', '1', model, aot=AOT)
    assert registry.versions('retry') == []
    monkeypatch.delenv('SOCCERACTION_TPU_RATING_PATH')
    registry.publish('retry', '1', model, aot=AOT)
    assert registry.versions('retry') == ['1']
    assert read_manifest(registry.aot_dir('retry', '1')) is not None


def test_non_standard_models_are_refused_at_export(tmp_path):
    class _AtomicLike:
        _fused_registry = 'atomic'

    with pytest.raises(ValueError, match='standard-SPADL'):
        export_serving_aot(_AtomicLike(), str(tmp_path / AOT_DIRNAME), ladder=LADDER,
                           max_actions=MAX_ACTIONS)


def test_artifacts_are_immutable(tmp_path, model, cache):
    aot_dir = str(tmp_path / AOT_DIRNAME)
    export_serving_aot(model, aot_dir, ladder=LADDER, max_actions=MAX_ACTIONS)
    with pytest.raises(ValueError, match='immutable'):
        export_serving_aot(model, aot_dir, ladder=LADDER, max_actions=MAX_ACTIONS)


def test_export_aot_backfills_a_published_version(tmp_path, model, cache):
    registry = ModelRegistry(str(tmp_path / 'registry'), device='cpu')
    registry.publish('vaep', '1', model)
    assert read_manifest(registry.aot_dir('vaep', '1')) is None
    manifest = registry.export_aot('vaep', ladder=(1, 2, 4), max_actions=MAX_ACTIONS)
    assert read_manifest(registry.aot_dir('vaep', '1')) == manifest
    assert manifest['ladder'] == [1, 2, 4]


def test_stage_candidate_aot_rides_the_atomic_promotion(tmp_path, model, cache):
    registry = ModelRegistry(str(tmp_path / 'registry'), device='cpu')
    tag, path = registry.stage_candidate('learned', model, aot=AOT)
    assert read_manifest(os.path.join(path, AOT_DIRNAME)) is not None
    registry.promote_candidate('learned', '1', tag)
    manifest = read_manifest(registry.aot_dir('learned', '1'))
    assert manifest is not None and manifest['ladder'] == list(LADDER)


def test_learn_config_carries_aot_spec():
    cfg = LearnConfig(aot={'ladder': (1, 2), 'max_actions': 128})
    assert cfg.aot == {'ladder': (1, 2), 'max_actions': 128}
    assert LearnConfig().aot is None


# -- fingerprints ---------------------------------------------------------------------------


@pytest.mark.parametrize('stored,current', [
    ({'a': 1, 'b': 2}, {'a': 1, 'b': 2}),
    ({'a': 1, 'b': 2}, {'a': 1, 'b': 3}),
    ({'a': 1}, {'a': 1, 'guards': '1'}),
    ({'a': '1', 'x': None}, {'a': 1}),
])
def test_fingerprint_diff_over_the_union_of_keys(stored, current):
    assert fingerprint_diff(stored, current) == jax_fingerprint_diff(stored, current)


def test_fingerprint_names_each_library_by_its_digest():
    fp = env_fingerprint('cpu')
    for name in KERNELS:
        assert fp[f'library_{name}'] == cuda_build.library_digest(name)
        assert cuda_build.library_path(name).name == f'lib{name}-{fp[f"library_{name}"]}.so'
    assert (fp['device_kind'], fp['compute_capability']) == ('cpu', 'none')


# -- load outcomes --------------------------------------------------------------------------


def test_hit_installs_the_libraries_and_load_library_runs_no_nvcc(tmp_path, model, cache,
                                                                   monkeypatch):
    """A replica starting from an empty compile cache: ``load_aot`` reads
    ``hit`` with both libraries installed, counted once each; then
    ``load_library`` loads the shipped files with ``nvcc`` never called,
    and ``dispatch/kernel_builds`` does not move."""
    registry = _publish(tmp_path, model)
    replica_cache = tmp_path / 'replica-cache'
    monkeypatch.setenv(COMPILE_CACHE_ENV, str(replica_cache))
    monkeypatch.setattr(cuda_build, '_nvcc', _no_nvcc)
    hits, builds = _loads('hit'), _builds()
    with RatingService(registry=registry, max_actions=MAX_ACTIONS, max_batch_size=2,
                       max_wait_ms=1.0) as svc:
        state = svc.load_aot()
        assert svc.load_aot() is state  # once per active version
        libs = cuda_build.load_libraries(KERNELS)
        svc.warmup()
        frame = _frame(70, 120)
        served = svc.rate_sync(frame, home_team_id=HOME, timeout=WAIT).to_numpy()
        health = svc.health()
    assert state['outcome'] == 'hit' and state['entries_loaded'] == len(KERNELS)
    assert state['model'] == 'vaep/1'
    assert _loads('hit') - hits == len(KERNELS)
    assert _builds() == builds
    for name, lib in libs.items():
        assert isinstance(lib, ctypes.CDLL)
        assert lib._name == str(replica_cache / cuda_build.library_path(name).name)
        assert (replica_cache / cuda_build.library_path(name).name).read_bytes() == cache[name]
    assert health['aot']['available'] is True and health['aot']['outcome'] == 'hit'
    assert health['aot']['entries_loaded'] == 2
    assert health['aot']['compile_cache'] == {'dir': str(replica_cache)}
    assert last_aot_load()['outcome'] == 'hit'
    events = [e for e in RECORDER.events() if e.get('kind') == 'aot_load']
    assert events and events[-1]['outcome'] == 'hit' and events[-1]['model'] == 'vaep/1'
    np.testing.assert_array_equal(served, _reference('port', model, frame))


def _doctor(aot_dir, **fields):
    path = os.path.join(aot_dir, 'manifest.json')
    with open(path, encoding='utf-8') as f:
        manifest = json.load(f)
    manifest['fingerprint'].update(fields)
    with open(path, 'w', encoding='utf-8') as f:
        json.dump(manifest, f)


def test_a_doctored_fingerprint_reads_stale_and_builds(tmp_path, model, cache, monkeypatch):
    """Libraries built for another card and toolkit: ``stale``, counted
    once, the moved keys named; nothing is installed (the replica's cache
    stays empty), and warm-up and serving still work."""
    registry = _publish(tmp_path, model)
    _doctor(registry.aot_dir('vaep', '1'), device_kind='NVIDIA B200', cuda='99.9')
    replica_cache = tmp_path / 'replica-cache'
    monkeypatch.setenv(COMPILE_CACHE_ENV, str(replica_cache))
    stale = _loads('stale')
    with RatingService(registry=registry, max_actions=MAX_ACTIONS, max_batch_size=2,
                       max_wait_ms=1.0) as svc:
        svc.warmup()
        state = svc.load_aot()
        frame = _frame(71, 100)
        served = svc.rate_sync(frame, home_team_id=HOME, timeout=WAIT).to_numpy()
        health = svc.health()
    assert state['outcome'] == 'stale' and state['entries_loaded'] == 0
    assert set(state['mismatch']) == {'device_kind', 'cuda'}
    assert state['mismatch']['cuda'] == {'stored': '99.9', 'current': str(env_fingerprint('cpu')['cuda'])}
    assert _loads('stale') == stale + 1
    assert not any(p.suffix == '.so' for p in replica_cache.iterdir())
    assert health['aot']['outcome'] == 'stale'
    assert health['aot']['mismatch']['device_kind']['stored'] == 'NVIDIA B200'
    np.testing.assert_array_equal(served, _reference('port', model, frame))


def test_another_layout_reads_stale(tmp_path, model, other_model, cache):
    """Libraries exported with one layout never load for another: the
    layout signature reads ``stale``."""
    aot_dir = str(tmp_path / AOT_DIRNAME)
    export_serving_aot(model, aot_dir, ladder=LADDER, max_actions=MAX_ACTIONS)
    state = load_serving_aot(other_model, aot_dir, ladder=LADDER, max_actions=MAX_ACTIONS)
    assert state['outcome'] == 'stale' and state['entries_loaded'] == 0
    assert set(state['mismatch']) == {'signature'}
    assert state['mismatch']['signature']['stored'] != state['mismatch']['signature']['current']


def test_a_truncated_library_is_a_named_miss_that_never_fails_warmup_or_swap(
        tmp_path, model, cache):
    registry = _publish(tmp_path, model)
    aot_dir = registry.aot_dir('vaep', '1')
    victim = cuda_build.library_path('gather_matmul').name
    with open(os.path.join(aot_dir, victim), 'r+b') as f:
        f.truncate(32)
    miss = _loads('miss')
    frame = _frame(72, 110)
    with RatingService(registry=registry, max_actions=MAX_ACTIONS, max_batch_size=2,
                       max_wait_ms=1.0) as svc:
        state = svc.load_aot()
        svc.warmup()
        served = svc.rate_sync(frame, home_team_id=HOME, timeout=WAIT).to_numpy()
    assert state['outcome'] == 'miss' and state['entries_loaded'] == 0
    assert victim in state['reason'] and 'corrupt' in state['reason']
    assert _loads('miss') == miss + 1
    np.testing.assert_array_equal(served, _reference('port', model, frame))
    # the swap path shares the fallback: a v2 whose manifest is torn
    registry.publish('vaep', '2', model, aot=AOT)
    with open(os.path.join(registry.aot_dir('vaep', '2'), 'manifest.json'), 'w') as f:
        f.write('{ torn json')
    with RatingService(registry=registry, max_actions=MAX_ACTIONS, max_batch_size=2,
                       max_wait_ms=1.0) as svc:
        assert svc.swap_model('vaep', '2') == ('vaep', '2')
        health = svc.health()
        served = svc.rate_sync(frame, home_team_id=HOME, timeout=WAIT).to_numpy()
    assert health['aot']['outcome'] == 'miss' and 'failed to parse' in health['aot']['reason']
    np.testing.assert_array_equal(served, _reference('port', model, frame))


def test_registry_aot_faults_retry_to_a_hit_or_end_in_a_miss(tmp_path, model, cache):
    """``registry.aot`` sits inside the retried read: a transient fault is
    retried to a hit; a budget of faults exhausted is a miss, never an
    exception."""
    aot_dir = str(tmp_path / AOT_DIRNAME)
    export_serving_aot(model, aot_dir, ladder=LADDER, max_actions=MAX_ACTIONS)
    with FaultPlan(seed=3, specs=[FaultSpec('registry.aot', error=OSError, nth=1)]) as plan:
        state = load_serving_aot(model, aot_dir, ladder=LADDER, max_actions=MAX_ACTIONS)
    assert state['outcome'] == 'hit' and state['entries_loaded'] == len(KERNELS)
    assert [h['point'] for h in plan.history] == ['registry.aot']
    with FaultPlan(seed=4, specs=[FaultSpec('registry.aot', error=OSError, probability=1.0)]):
        state = load_serving_aot(model, aot_dir, ladder=LADDER, max_actions=MAX_ACTIONS)
    assert state['outcome'] == 'miss' and 'OSError' in state['reason']


def test_no_artifacts_and_a_torn_manifest_read_as_the_jax_package_reads_them(tmp_path, model):
    """Without a manifest both packages read an uncounted ``miss``; a torn
    manifest is a counted ``miss`` naming the parse failure."""
    empty = str(tmp_path / 'empty')
    torn = tmp_path / 'torn'
    torn.mkdir()
    (torn / 'manifest.json').write_text('{ torn')
    out = {}
    for pkg, load in (('port', load_serving_aot), ('jax', jax_load_serving_aot)):
        a = load(model if pkg == 'port' else None, empty, ladder=LADDER, max_actions=MAX_ACTIONS)
        b = load(model if pkg == 'port' else None, str(torn), ladder=LADDER,
                 max_actions=MAX_ACTIONS)
        out[pkg] = ((a['outcome'], a['entries_loaded'], a['reason']),
                    (b['outcome'], b['reason'].split(':')[0], 'failed to parse' in b['reason']))
    assert out['port'] == out['jax']
    assert out['port'] == (('miss', 0, 'no AOT artifacts shipped'), ('miss', 'ValueError', True))


def test_a_model_backed_service_reads_its_aot_dir(tmp_path, model, cache):
    aot_dir = str(tmp_path / AOT_DIRNAME)
    export_serving_aot(model, aot_dir, ladder=LADDER, max_actions=MAX_ACTIONS)
    with RatingService(model, max_actions=MAX_ACTIONS, max_batch_size=2, aot_dir=aot_dir) as svc:
        assert svc.health()['aot'] == {'available': False}
        svc.warmup()
        block = svc.health()['aot']
    assert block['outcome'] == 'hit' and block['model'] == 'default/0'
    with RatingService(model, max_actions=MAX_ACTIONS, max_batch_size=2) as svc:
        assert svc.load_aot() is None


# -- the compile cache ----------------------------------------------------------------------


def test_the_compile_cache_names_the_build_directory(tmp_path, monkeypatch):
    """Unset, libraries build into the checkout's ``build/kernels/``; set
    (by the environment or ``enable_compile_cache``), into its directory,
    read at call time."""
    monkeypatch.delenv(COMPILE_CACHE_ENV, raising=False)
    assert compile_cache_dir() is None and cuda_build.build_dir() == cuda_build.BUILD_DIR
    monkeypatch.setenv(COMPILE_CACHE_ENV, '  ')
    assert compile_cache_dir() is None
    target = str(tmp_path / 'kernels')
    assert enable_compile_cache(target) == target
    assert os.environ[COMPILE_CACHE_ENV] == target and os.path.isdir(target)
    assert cuda_build.build_dir() == tmp_path / 'kernels'
    assert cuda_build.library_path('segment_sum').parent == tmp_path / 'kernels'
    assert enable_compile_cache() == target


def test_aot_deserialize_is_a_coldstart_phase():
    assert PHASES.index('checkpoint_load') < PHASES.index('aot_deserialize') < \
        PHASES.index('kernel_build')


def test_the_learner_ships_the_libraries_with_its_candidates(tmp_path, cache):
    """``LearnConfig(aot=)``: the learner's staged candidate carries the
    libraries, and the version the gate promotes ships them."""
    from socceraction_tpu.core.synthetic import write_synthetic_season
    from socceraction_tpu_torch.learn import ContinuousLearner, GateConfig
    from socceraction_tpu_torch.pipeline.store import SeasonStore

    store_path = str(tmp_path / 'season')
    write_synthetic_season(store_path, n_games=2, n_actions=128)
    registry = ModelRegistry(str(tmp_path / 'registry'), device='cpu')
    cfg = LearnConfig(max_actions=128, games_per_batch=2, gate=GateConfig(n_boot=8),
                      train_params={'hidden': (8,), 'max_epochs': 1, 'batch_size': 256},
                      aot={'ladder': (1, 2), 'max_actions': 128})
    with SeasonStore(store_path, mode='a') as store:
        report = ContinuousLearner(store, registry, config=cfg).run_once()
    assert (report.verdict, report.candidate_version) == ('promoted', '1')
    manifest = read_manifest(registry.aot_dir(cfg.model_name, '1'))
    assert manifest['ladder'] == [1, 2] and manifest['max_actions'] == 128
    assert [e['id'] for e in manifest['entries']] == list(KERNELS)
