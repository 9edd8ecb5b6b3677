"""The PyTorch port stands alone.

- No file of ``socceraction_tpu_torch`` (nor ``chip_smoke.py``) imports
  ``jax``, ``flax``, ``optax`` or the JAX package ``socceraction_tpu``.
  The port's own name starts with ``socceraction_tpu``, so the check
  matches top-level module names exactly, never by prefix.
- Every module of the port and ``chip_smoke.py`` import with those
  packages, and ``pandas``, ``lxml``, ``sklearn``, ``pyarrow``, ``h5py``
  and ``msgpack`` (absent on the GPU machine), blocked; the smoke's xT,
  training, Atomic-VAEP, sequence-head, season feed, counterfactual,
  telemetry, rating-path, learning-loop, DataFrame-layer, quality-tier
  and providers' phases also run so, at a tiny size on the CPU, with a checkpoint published and
  loaded back through the model registry; so do its scale-out phase, its
  telemetry-plane phase and its serving phase, each in a process of its
  own; the serving phase then runs serving's outer tier (replica lanes,
  the warm tier's child processes, the frontend) in the same process; the
  seq-serving phase (seq and mixed pairs behind the service) in its own.
- Entry points run on the GPU unless asked for the CPU: with no GPU and
  no ``device='cpu'`` they raise instead of falling back.
"""

import ast
import os
import shutil
import subprocess
import sys
from pathlib import Path

import numpy as np
import pandas as pd
import pytest
import torch

from socceraction_tpu_torch import convert
from socceraction_tpu_torch.atomic.vaep.base import AtomicVAEP
from socceraction_tpu_torch.core import batch as tbatch
from socceraction_tpu_torch.core.synthetic import synthetic_batch
from socceraction_tpu_torch import xthreat
from socceraction_tpu_torch.device import resolve_device
from socceraction_tpu_torch.learn import (
    ContinuousLearner,
    calibration_summary,
    pack_replay_batch,
    reliability_curve,
)
from socceraction_tpu_torch.ml.mlp import MLPClassifier
from socceraction_tpu_torch.ops import segment
from socceraction_tpu_torch.pipeline import feed, packed
from socceraction_tpu_torch.seq.classifier import SeqClassifier
from socceraction_tpu_torch.seq.model import init_seq_params
from socceraction_tpu_torch.serve import ModelRegistry
from socceraction_tpu_torch.vaep.base import VAEP, load_model
from socceraction_tpu_torch.xg import XGModel

ROOT = Path(__file__).resolve().parent.parent
BANNED = {'jax', 'jaxlib', 'flax', 'optax', 'socceraction_tpu'}
PORT_FILES = sorted((ROOT / 'socceraction_tpu_torch').rglob('*.py')) + [ROOT / 'chip_smoke.py']


def _imported_top_levels(path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for alias in node.names:
                yield alias.name.split('.')[0]
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            yield node.module.split('.')[0]


def test_the_scan_sees_the_port():
    names = {p.relative_to(ROOT).as_posix() for p in PORT_FILES}
    assert 'socceraction_tpu_torch/vaep/base.py' in names
    assert 'chip_smoke.py' in names
    for module in (
        'atomic/spadl/config.py', 'atomic/vaep/base.py', 'ops/atomic.py', 'seq/model.py',
        'seq/classifier.py', 'obs/metrics.py', 'obs/trace.py', 'obs/residency.py',
        'resil/retry.py', 'resil/faults.py', 'pipeline/store.py', 'pipeline/packed.py',
        'pipeline/build.py', 'pipeline/feed.py', 'scenario/grid.py', 'scenario/engine.py',
        'scenario/product.py', 'scenario/xt.py', 'obs/context.py', 'obs/coldstart.py',
        'obs/dispatch.py', 'obs/export.py', 'obs/memory.py', 'obs/numerics.py', 'obs/parity.py',
        'obs/perf.py', 'obs/recorder.py', 'obs/slo.py', 'utils/profiling.py', 'ops/profile.py',
        'learn/__init__.py', 'learn/calibration.py', 'learn/drift.py', 'learn/gate.py',
        'learn/shadow.py', 'learn/ingest.py', 'learn/loop.py', 'resil/journal.py',
        'serve/__init__.py', 'serve/capture.py', 'serve/registry.py', 'convert.py',
        'parallel/__init__.py', 'parallel/collectives.py', 'parallel/mesh.py', 'parallel/xt.py',
        'parallel/vaep.py', 'parallel/sequence.py', 'parallel/serve.py', 'utils/env.py',
        'obs/wire.py', 'obs/endpoint.py', 'obs/fleet.py', 'resil/breaker.py', 'serve/batcher.py',
        'serve/session.py', 'serve/service.py', 'serve/aot.py', 'serve/frontend.py',
        'schema.py', 'spadl/schema.py', 'spadl/utils.py', 'atomic/spadl/schema.py',
        'atomic/spadl/utils.py', 'vaep/features.py', 'vaep/labels.py', 'vaep/formula.py',
        'atomic/vaep/features.py', 'atomic/vaep/labels.py', 'atomic/vaep/formula.py',
        'ml/learners.py', 'ratings.py', 'xthreat_v3.py', 'xg.py', 'spadl/base.py',
        'spadl/_deprecated.py', 'spadl/statsbomb.py', 'spadl/opta.py', 'spadl/wyscout.py',
        'spadl/wyscout_v3.py', 'atomic/spadl/base.py', 'data/__init__.py', 'data/base.py',
        'data/schema.py', 'data/statsbomb/__init__.py', 'data/statsbomb/loader.py',
        'data/statsbomb/schema.py', 'core/synthetic.py', 'data/wyscout/__init__.py',
        'data/wyscout/loader.py', 'data/wyscout/schema.py', 'data/wyscout/v3.py',
        'data/opta/__init__.py', 'data/opta/loader.py', 'data/opta/schema.py',
        'data/opta/parsers/__init__.py', 'data/opta/parsers/base.py', 'data/opta/parsers/spec.py',
        'data/opta/parsers/f24.py', 'data/opta/parsers/f24_json.py', 'data/opta/parsers/f24_xml.py',
        'data/opta/parsers/f1_json.py', 'data/opta/parsers/f7_xml.py', 'data/opta/parsers/f9_json.py',
        'data/opta/parsers/statsperform.py', 'data/opta/parsers/ma1_json.py',
        'data/opta/parsers/ma3_json.py', 'data/opta/parsers/whoscored.py',
    ):
        assert f'socceraction_tpu_torch/{module}' in names


@pytest.mark.parametrize('path', PORT_FILES, ids=lambda p: p.relative_to(ROOT).as_posix())
def test_no_jax_imports(path):
    found = set(_imported_top_levels(path)) & BANNED
    assert not found, f'{path.relative_to(ROOT)} imports {sorted(found)}'


def test_exact_match_is_not_a_prefix_match(tmp_path):
    """``socceraction_tpu_torch`` passes, ``socceraction_tpu.ops`` does not."""
    f = tmp_path / 'm.py'
    f.write_text('import socceraction_tpu_torch.ops\nfrom socceraction_tpu.ops import fused\n')
    assert set(_imported_top_levels(f)) & BANNED == {'socceraction_tpu'}


_BLOCK = '''
import importlib.abc, sys
# torch's compiler stack, which torch.profiler loads, probes optional
# packages with importlib.util.find_spec: on the card's machine they are
# absent and the probe finds nothing, here the blocker would raise from
# it. It imports none of them; load it before the blocker goes in.
import torch._dynamo
BLOCKED = {'jax', 'jaxlib', 'flax', 'optax', 'socceraction_tpu', 'pandas', 'msgpack', 'pyarrow',
           'h5py', 'sklearn', 'lxml'}
class Block(importlib.abc.MetaPathFinder):
    def find_spec(self, name, path=None, target=None):
        if name.split('.')[0] in BLOCKED:
            raise ImportError(f'{name} is blocked')
        return None
sys.meta_path.insert(0, Block())
sys.path.insert(0, sys.argv[1])
'''

_BLOCKER = _BLOCK + '''
import chip_smoke
import importlib, pkgutil
import socceraction_tpu_torch
# every module of the port, the DataFrame layer's among them
for info in pkgutil.walk_packages(socceraction_tpu_torch.__path__, 'socceraction_tpu_torch.'):
    importlib.import_module(info.name)
import socceraction_tpu_torch.vaep.base, socceraction_tpu_torch.convert
import socceraction_tpu_torch.ops.cuda_build
import socceraction_tpu_torch.xthreat, socceraction_tpu_torch.ops.xt
import socceraction_tpu_torch.ops.segment
# the smoke's xT phase, at a tiny size on the CPU
from socceraction_tpu_torch.core.synthetic import synthetic_batch
fits = chip_smoke.xt_fits(synthetic_batch(4, 128, seed=2, device='cpu'), 'cpu')
chip_smoke.compare_fits(fits, fits)
# its DataFrame-layer phase: the frame fit's remainder, the fused rating of
# the heads it trained, the card-against-CPU fit and the numpy xT oracle
import socceraction_tpu_torch.xg, socceraction_tpu_torch.xthreat_v3, socceraction_tpu_torch.ratings
small = {'hidden': (8,), 'batch_size': 256, 'max_epochs': 3}
frame = chip_smoke.frame_phase(torch.device('cpu'), fits['ExpectedThreat 16x12'], sizes=chip_smoke.FrameSizes(
    games=2, actions=256, parity_games=2, params=small,
    parity_params={**small, 'max_epochs': 2, 'learning_rate': 1e-4}))
assert frame['rate_launches'] == 0 and frame['oracle']['grid_max_abs_err'] <= 1e-5, frame
# its quality tier: the chain generator's columns packed without pandas, the
# fit, the held-out scores and the shuffled control, at a tiny size
import socceraction_tpu_torch.spadl.statsbomb, socceraction_tpu_torch.atomic.spadl.base
import socceraction_tpu_torch.data.statsbomb.loader, socceraction_tpu_torch.spadl.wyscout_v3
quality = chip_smoke.quality_phase(torch.device('cpu'), sizes=chip_smoke.QualitySizes(
    train_games=2, test_games=2, actions=200, params={'hidden': (8,), 'batch_size': 256, 'max_epochs': 3},
    digest=None, floors=False))
assert quality['launches'] == 0 and quality['fit_launches'] == {'gather_matmul': 0, 'segment_sum': 0}, quality
assert quality['b1'] is None and len(quality['digest']) == 64, quality
assert all(0 <= m['auroc'] <= 1 for part in ('metrics', 'control') for m in quality[part].values()), quality
# its providers' phase: the loaders' modules imported with neither pandas nor
# lxml, the parsers' records held to their digests, the fixture games rated
import socceraction_tpu_torch.data.wyscout.loader, socceraction_tpu_torch.data.opta.loader
providers = chip_smoke.provider_phase(torch.device('cpu'), hidden=(8,))
assert providers['launches'] == 0 and providers['segment_launches'] == 0, providers
assert providers['b1'] is None and providers['actions'] == chip_smoke.PROVIDER_ACTIONS, providers
assert sorted(providers['records']) == sorted(chip_smoke.PROVIDER_DIGESTS), providers
# and its training phase
import socceraction_tpu_torch.ml.learners
params = {'hidden': (8,), 'batch_size': 256, 'max_epochs': 2}
run = chip_smoke.fit_vaep(synthetic_batch(2, 256, seed=5, device='cpu'), params, 'cpu')
chip_smoke.check_fit(run, params)
chip_smoke.compare_training(run, run, params)
# its Atomic-VAEP phase: serving, an MLP fit and a seq fit
from socceraction_tpu_torch.atomic.vaep.base import AtomicVAEP
import socceraction_tpu_torch.ops.atomic, socceraction_tpu_torch.seq.model
model = chip_smoke.make_model('cpu', (8,), AtomicVAEP)
batch = chip_smoke.atomic_batch(2, 256, seed=0, device='cpu')
chip_smoke.check_against_reference(model, batch, model.rate_batch(batch), 'atomic')
run = chip_smoke.fit_vaep(chip_smoke.atomic_batch(2, 256, seed=5, device='cpu'), params, 'cpu',
                          model_cls=AtomicVAEP)
chip_smoke.check_fit(run, params)
chip_smoke.compare_training(run, run, params)
# and its sequence-head phase
seq = {'batch_size': 256, 'max_epochs': 2, 'embed_dim': 8, 'hidden': 16, 'readout': 16}
for fit in ({}, {'model_cls': AtomicVAEP}):
    batch = chip_smoke.make_batch(fit.get('model_cls', chip_smoke.VAEP), 2, 256, seed=5, device='cpu')
    run = chip_smoke.fit_vaep(batch, seq, 'cpu', learner='seq', **fit)
    chip_smoke.check_fit(run, seq)
    chip_smoke.compare_training(run, run, seq)
    chip_smoke.check_against_reference(run['model'], batch, run['model'].rate_batch(batch), 'seq')
# the season feed: the pipeline's entry points, a cache written from arrays,
# streamed, taken whole, fitted, and an atomic take
import torch
from socceraction_tpu_torch.pipeline import PackedSeason, SeasonStore, iter_batches
import socceraction_tpu_torch.pipeline.build, socceraction_tpu_torch.scenario.engine
cpu = torch.device('cpu')
model = chip_smoke.make_model('cpu', (8,))
draw = synthetic_batch(5, 256, seed=2, device='cpu')
xt = chip_smoke.ExpectedThreat(device='cpu').fit(draw)
chip_smoke.feed_phase(model, draw, {'grid': xt.xT, 'iterations': xt.n_iter}, cpu, games=2,
                      atomic_low=100)
# and the counterfactuals
chip_smoke.scenario_phase(model, cpu, n_games=2, n_actions=256, nx=3, ny=2, reps=1)
# and the telemetry phase
import socceraction_tpu_torch.obs, socceraction_tpu_torch.utils.profiling
chip_smoke.telemetry_phase(model, cpu, games=2, actions=256, reps=3, probes=2, pairs=2)
# and the rating dispatch with the gate's statistics
import socceraction_tpu_torch.learn, socceraction_tpu_torch.ops.profile
chip_smoke.rating_phase(cpu, games=2, actions=256, reps=1, n_boot=8)
# a checkpoint written and read back through a registry: the port's own codec
import os, tempfile
import socceraction_tpu_torch.serve, socceraction_tpu_torch.resil.journal
from socceraction_tpu_torch.serve import ModelRegistry
root = tempfile.mkdtemp(dir='.')
registry = ModelRegistry(os.path.join(root, 'registry'), device='cpu')
registry.publish('vaep', '1', model)
back = registry.load('vaep', '1')
batch = synthetic_batch(2, 256, seed=4, device='cpu')
assert torch.equal(back.rate_batch(batch), model.rate_batch(batch))
# and the learning loop's phase over its stand-in store
chip_smoke.learn_phase(cpu, games=6, new_games=2, actions=128, games_per_batch=2, replay_games=2,
                       params={'hidden': (8,), 'batch_size': 256, 'max_epochs': 3,
                               'learning_rate': 3e-4}, n_boot=8, rate_games=2)
leaked = sorted(m for m in sys.modules if m.split('.')[0] in BLOCKED)
assert not leaked, leaked
print('isolated')
'''


def test_chip_smoke_path_imports_with_blocked_packages(tmp_path):
    proc = subprocess.run(
        [sys.executable, '-c', _BLOCKER, str(ROOT)],
        capture_output=True, text=True, timeout=120, cwd=tmp_path,
    )
    assert proc.returncode == 0, proc.stderr[-2000:]
    assert 'isolated' in proc.stdout


#: The smoke's scale-out phase at a tiny size on the CPU: one gloo rank in
#: the blocked process, then two ranks it spawns (fresh interpreters).
_SCALE_BLOCKER = _BLOCK + """
import torch
import chip_smoke
import socceraction_tpu_torch.parallel, socceraction_tpu_torch.utils.env
chip_smoke.scale_phase(torch.device('cpu'), sizes=chip_smoke.ScaleSizes(
    xt_games=4, games=2, actions=256, hidden=(8, 8)), rank_timeout_s=120.0)
leaked = sorted(m for m in sys.modules if m.split('.')[0] in BLOCKED)
assert not leaked, leaked
print('isolated')
"""


def test_chip_smoke_scale_phase_runs_with_blocked_packages(tmp_path):
    # its ranks are held to 120 s; the process around them gets more
    proc = subprocess.run(
        [sys.executable, '-c', _SCALE_BLOCKER, str(ROOT)],
        capture_output=True, text=True, timeout=240, cwd=tmp_path,
    )
    assert proc.returncode == 0, proc.stderr[-2000:]
    assert 'isolated' in proc.stdout


#: The smoke's telemetry-plane phase at a tiny size on the CPU: two replica
#: processes it spawns (fresh interpreters) and the aggregator in the
#: blocked process. One thread, so that replica 0 (one thread too)
#: reproduces the values rated here bitwise.
_FLEET_BLOCKER = _BLOCK + """
import torch
torch.set_num_threads(1)
import chip_smoke
import socceraction_tpu_torch.obs.wire, socceraction_tpu_torch.obs.endpoint
import socceraction_tpu_torch.obs.fleet
sizes = chip_smoke.FleetSizes(replicas=2, games=2, actions=256, requests=2)
model = chip_smoke.make_model('cpu', (8, 8))
values = model.rate_batch(chip_smoke.synthetic_batch(2, 256, seed=0, device='cpu'))
launches = chip_smoke.fleet_phase(model, values, torch.device('cpu'), sizes=sizes, timeout_s=90.0)
assert launches == {'replica-0': 0, 'replica-1': 0}, launches
leaked = sorted(m for m in sys.modules if m.split('.')[0] in BLOCKED)
assert not leaked, leaked
print('isolated')
"""


def test_chip_smoke_fleet_phase_runs_with_blocked_packages(tmp_path):
    proc = subprocess.run(
        [sys.executable, '-c', _FLEET_BLOCKER, str(ROOT)],
        capture_output=True, text=True, timeout=120, cwd=tmp_path,
    )
    assert proc.returncode == 0, proc.stderr[-2000:]
    assert 'isolated' in proc.stdout
    assert 'stale [\'replica-1\'], status degraded' in proc.stdout
    # each replica's own service answered its requests
    assert '"serve_requests": 4.0' in proc.stdout
    # the phase cleans up after itself
    assert not (tmp_path / 'build' / 'fleet').exists()


#: The smoke's serving phase at a tiny size on the CPU: the rating service,
#: its batcher, sessions module and breaker import and run with pandas,
#: JAX and msgpack blocked (requests are built from arrays).
_SERVE_BLOCKER = _BLOCK + """
import torch
torch.set_num_threads(1)
import chip_smoke
import socceraction_tpu_torch.serve.service, socceraction_tpu_torch.serve.batcher
import socceraction_tpu_torch.serve.session, socceraction_tpu_torch.resil.breaker
import socceraction_tpu_torch.serve.aot, socceraction_tpu_torch.serve.frontend
sizes = chip_smoke.ServeSizes(max_actions=256, max_batch_size=4, clients=2, requests=3, low=100,
                              swap_clients=2, swap_requests=3, drain_requests=3, hidden=(8,),
                              grid=(3, 2), sweep_types=5, custom_p=3, probe_clients=2,
                              probe_requests=2, telemetry_requests=2)
model = chip_smoke.make_model('cpu', (8,))
launches, fold, one_lane = chip_smoke.serve_phase(model, torch.device('cpu'), sizes=sizes)
assert set(launches.values()) == {0}, launches
assert fold['bucket'] == 8 and fold['b1_at_fold_shape'] is None, fold
# and serving's outer tier: four lanes, the warm tier's two children (fresh
# interpreters), the frontend
lane_sizes = chip_smoke.LaneSizes(max_actions=256, max_batch_size=4, clients=4, requests=8,
                                  low=100, single=3, drill_requests=4, hidden=(8,))
lanes = chip_smoke.lanes_phase(model, torch.device('cpu'), sizes=lane_sizes, one_lane=one_lane)
assert set(lanes.values()) == {0}, lanes
leaked = sorted(m for m in sys.modules if m.split('.')[0] in BLOCKED)
assert not leaked, leaked
print('isolated')
"""


def test_chip_smoke_serve_phase_runs_with_blocked_packages(tmp_path):
    proc = subprocess.run(
        [sys.executable, '-c', _SERVE_BLOCKER, str(ROOT)],
        capture_output=True, text=True, timeout=120, cwd=tmp_path,
    )
    assert proc.returncode == 0, proc.stderr[-2000:]
    assert 'isolated' in proc.stdout
    for part in ('(a) warmup', '(b) traffic', '(c) hot swap and rollback', '(d) breaker drill',
                 '(e) kernel-fault drill', '(f) close(drain=True)', '(g) scenarios',
                 '(h) parity probe', '(i) SLO', '(j) scenario breaker and kernel-fault drills',
                 '(k) telemetry', '(a) construction', '(a) traffic through 4 lanes',
                 '(a) one-request flushes', '(c) frontend GET /health equals health()',
                 '(a) sick lane', '(a) kernel fault on lane 1', '(a) swap', '(b) warm tier',
                 '(b) hit child cold start', '(b) stale child cold start'):
        assert part in proc.stdout
    # the phases clean up after themselves
    assert not (tmp_path / 'build' / 'serve').exists()
    assert not (tmp_path / 'build' / 'lanes').exists()


#: The smoke's seq-serving phase at a tiny size on the CPU: a seq pair and a
#: mixed MLP/seq pair behind the rating service, the window bands, a swap
#: across families and the drill, with pandas, JAX and msgpack blocked.
_SEQ_SERVE_BLOCKER = _BLOCK + """
import torch
torch.set_num_threads(1)
import chip_smoke
sizes = chip_smoke.SeqServeSizes(max_actions=256, max_batch_size=4, clients=2, band_requests=2,
                                 mixed_requests=3, low=100, swap_clients=2, swap_requests=4,
                                 drill_requests=2)
model = chip_smoke.make_model('cpu', (8,))
out = chip_smoke.seq_serve_phase(model, torch.device('cpu'), sizes=sizes)
assert set(out['launches'].values()) == {0} and out['b1'] is None, out['launches']
assert set(out['bands']) == {'128', '256'}, sorted(out['bands'])
assert out['bands']['128']['window_slices'] == out['bands']['128']['flushes'] > 0, out['bands']
assert out['swap']['by_version']['2'] > 0 and out['swap']['compiled_shapes'] == 6, out['swap']
leaked = sorted(m for m in sys.modules if m.split('.')[0] in BLOCKED)
assert not leaked, leaked
print('isolated')
"""


def test_chip_smoke_seq_serve_phase_runs_with_blocked_packages(tmp_path):
    proc = subprocess.run(
        [sys.executable, '-c', _SEQ_SERVE_BLOCKER, str(ROOT)],
        capture_output=True, text=True, timeout=120, cwd=tmp_path,
    )
    assert proc.returncode == 0, proc.stderr[-2000:]
    assert 'isolated' in proc.stdout
    for part in ('(a) warmup', '(b) window band 128', '(b) window band 256', '(b) mixed pair traffic',
                 '(c) swap MLP v1 -> seq v2 and rollback', '(d) B1 cannot load under mixed-pair flushes'):
        assert part in proc.stdout
    # the phase cleans up after itself
    assert not (tmp_path / 'build' / 'serve_seq').exists()


def test_fleet_replica_fails_without_a_gpu(tmp_path):
    """A replica asked for the card with none present raises at the
    device, before it reads its spec or rates: it never falls back."""
    (tmp_path / 'spec.json').write_text('{}')
    env = dict(os.environ, CUDA_VISIBLE_DEVICES='')
    proc = subprocess.run(
        [sys.executable, str(ROOT / 'chip_smoke.py'), '--fleet-replica', str(tmp_path), '0', 'cuda'],
        capture_output=True, text=True, timeout=120, cwd=tmp_path, env=env,
    )
    assert proc.returncode != 0
    assert 'no CUDA device is available; pass device="cpu"' in proc.stderr
    assert 'fleet replica-0' not in proc.stdout
    assert sorted(p.name for p in tmp_path.iterdir()) == ['spec.json']


@pytest.fixture
def no_gpu(monkeypatch):
    monkeypatch.setattr(torch.cuda, 'is_available', lambda: False)


def _params():
    rng = np.random.default_rng(0)
    return {'params': {
        'Dense_0': {'kernel': rng.normal(size=(4, 2)), 'bias': np.zeros(2)},
        'Dense_1': {'kernel': rng.normal(size=(2, 1)), 'bias': np.zeros(1)},
    }}


ENTRY_POINTS = {
    'VAEP': lambda: VAEP(),
    'synthetic_batch': lambda: synthetic_batch(1, 128),
    'pack_actions': lambda: tbatch.pack_actions(
        pd.DataFrame({'game_id': [1], 'team_id': [1]}), home_team_id=1
    ),
    'load_model': lambda: load_model('no-such-checkpoint'),
    'MLPClassifier.load': lambda: MLPClassifier.load('no-such-head.npz'),
    'mlp_from_jax_params': lambda: convert.mlp_from_jax_params(_params(), np.zeros(4), np.ones(4)),
    'ActionBatch.to': lambda: synthetic_batch(1, 128, device='cpu').to('cuda'),
    'ExpectedThreat().fit': lambda: xthreat.ExpectedThreat().fit(synthetic_batch(1, 128, device='cpu')),
    'xthreat.load_model': lambda: xthreat.load_model('no-such-surface.json'),
    'segment_sum': lambda: segment.segment_sum(
        torch.ones(3, device=resolve_device(None)), torch.zeros(3, dtype=torch.int32), 2
    ),
    'MLPClassifier': lambda: MLPClassifier(hidden=(8,)),
    'AtomicVAEP': lambda: AtomicVAEP(),
    'pack_atomic_actions': lambda: tbatch.pack_atomic_actions(
        pd.DataFrame({'game_id': [1], 'team_id': [1]}), home_team_id=1
    ),
    'SeqClassifier': lambda: SeqClassifier(),
    'SeqClassifier.load': lambda: SeqClassifier.load('no-such-head.npz'),
    'init_seq_params': lambda: init_seq_params(
        0, combo_size=4, n_dense=1, embed_dim=2, hidden=2, readout=2
    ),
    'AtomicActionBatch.to': lambda: tbatch.pack_atomic_actions(
        pd.DataFrame({c: [0] for c in (
            'game_id', 'team_id', 'type_id', 'bodypart_id', 'period_id', 'time_seconds',
            'x', 'y', 'dx', 'dy',
        )}), home_team_id=0, device='cpu',
    )[0].to('cuda'),
    'VAEP(cpu).fit_packed(cuda batch)': lambda: VAEP(device='cpu').fit_packed(synthetic_batch(1, 128)),
    'load_batch': lambda: feed.load_batch(None),
    'iter_batches': lambda: next(feed.iter_batches(None, 1)),
    'ship_host_batch': lambda: packed.ship_host_batch(None),
    'copy_stream': lambda: packed.copy_stream(),
    'calibration_summary': lambda: calibration_summary(np.ones(4), np.ones(4)),
    'reliability_curve': lambda: reliability_curve(np.ones(4), np.ones(4)),
    'pack_replay_batch': lambda: pack_replay_batch(
        [(pd.DataFrame({'game_id': [1], 'team_id': [1]}), 1)], max_actions=128
    ),
    'ModelRegistry': lambda: ModelRegistry('no-such-registry'),
    'ContinuousLearner': lambda: ContinuousLearner(None, None),
    'XGModel': lambda: XGModel(),
    "VAEP(backend='pandas')": lambda: VAEP(backend='pandas'),
}


def test_default_device_is_the_current_card(monkeypatch):
    """A bare 'cuda' carries the current card's index, so models and
    batches made with the default compare equal to their tensors' device."""
    from socceraction_tpu_torch.device import resolve_device

    monkeypatch.setattr(torch.cuda, 'is_available', lambda: True)
    monkeypatch.setattr(torch.cuda, 'current_device', lambda: 0)
    assert resolve_device(None) == torch.device('cuda', 0)
    assert resolve_device('cuda') == torch.device('cuda', 0)
    assert resolve_device('cuda:1') == torch.device('cuda', 1)
    assert resolve_device('cpu') == torch.device('cpu')


@pytest.mark.parametrize('entry', list(ENTRY_POINTS))
def test_entry_points_need_a_gpu_unless_asked_for_the_cpu(no_gpu, entry):
    with pytest.raises(RuntimeError, match='device="cpu"'):
        ENTRY_POINTS[entry]()


def test_segment_sum_has_no_fallback_for_other_devices():
    """Only CPU tensors take the plain version: another device raises."""
    with pytest.raises(ValueError, match='no kernel'):
        segment.segment_sum(
            torch.ones(3, device='meta'), torch.zeros(3, dtype=torch.int32, device='meta'), 2
        )


def test_chip_smoke_fails_without_a_gpu():
    """No card here: the smoke run must exit non-zero and print no result."""
    env = dict(os.environ, CUDA_VISIBLE_DEVICES='')
    proc = subprocess.run(
        [sys.executable, str(ROOT / 'chip_smoke.py')],
        capture_output=True, text=True, timeout=120, cwd=ROOT, env=env,
    )
    assert proc.returncode != 0
    assert '"ok"' not in proc.stdout


def test_chip_smoke_alone_fails(tmp_path):
    """Without the rest of the repository the script cannot run."""
    shutil.copy(ROOT / 'chip_smoke.py', tmp_path / 'chip_smoke.py')
    env = {k: v for k, v in os.environ.items() if k != 'PYTHONPATH'}
    proc = subprocess.run(
        [sys.executable, 'chip_smoke.py'],
        capture_output=True, text=True, timeout=120, cwd=tmp_path, env=env,
    )
    assert proc.returncode != 0
    assert '"ok"' not in proc.stdout
