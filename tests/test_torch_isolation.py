"""The PyTorch port stands alone.

- No file of ``socceraction_tpu_torch`` (nor ``chip_smoke.py``) imports
  ``jax``, ``flax``, ``optax`` or the JAX package ``socceraction_tpu``.
  The port's own name starts with ``socceraction_tpu``, so the check
  matches top-level module names exactly, never by prefix.
- The modules ``chip_smoke.py`` runs import with those packages, and
  ``pandas``, ``pyarrow``, ``h5py`` and ``msgpack`` (absent on the GPU
  machine), blocked; its xT, training, Atomic-VAEP, sequence-head, season
  feed and counterfactual phases also run so, at a tiny size on the CPU.
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
from socceraction_tpu_torch.ml.mlp import MLPClassifier
from socceraction_tpu_torch.ops import segment
from socceraction_tpu_torch.pipeline import feed, packed
from socceraction_tpu_torch.seq.classifier import SeqClassifier
from socceraction_tpu_torch.seq.model import init_seq_params
from socceraction_tpu_torch.vaep.base import VAEP, load_model

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
        'scenario/product.py', 'scenario/xt.py',
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


_BLOCKER = '''
import importlib.abc, sys
BLOCKED = {'jax', 'jaxlib', 'flax', 'optax', 'socceraction_tpu', 'pandas', 'msgpack', 'pyarrow',
           'h5py'}
class Block(importlib.abc.MetaPathFinder):
    def find_spec(self, name, path=None, target=None):
        if name.split('.')[0] in BLOCKED:
            raise ImportError(f'{name} is blocked')
        return None
sys.meta_path.insert(0, Block())
sys.path.insert(0, sys.argv[1])
import chip_smoke
import socceraction_tpu_torch.vaep.base, socceraction_tpu_torch.convert
import socceraction_tpu_torch.ops.cuda_build
import socceraction_tpu_torch.xthreat, socceraction_tpu_torch.ops.xt
import socceraction_tpu_torch.ops.segment
# the smoke's xT phase, at a tiny size on the CPU
from socceraction_tpu_torch.core.synthetic import synthetic_batch
fits = chip_smoke.xt_fits(synthetic_batch(4, 128, seed=2, device='cpu'), 'cpu')
chip_smoke.compare_fits(fits, fits)
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
