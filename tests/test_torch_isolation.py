"""The PyTorch port stands alone.

- No file of ``socceraction_tpu_torch`` (nor ``chip_smoke.py``) imports
  ``jax``, ``flax``, ``optax`` or the JAX package ``socceraction_tpu``.
  The port's own name starts with ``socceraction_tpu``, so the check
  matches top-level module names exactly, never by prefix.
- The modules ``chip_smoke.py`` runs import with those packages, and
  ``pandas`` and ``msgpack`` (absent on the GPU machine), blocked; its xT
  and training phases also run so, at a tiny size on the CPU.
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
from socceraction_tpu_torch.core import batch as tbatch
from socceraction_tpu_torch.core.synthetic import synthetic_batch
from socceraction_tpu_torch import xthreat
from socceraction_tpu_torch.device import resolve_device
from socceraction_tpu_torch.ml.mlp import MLPClassifier
from socceraction_tpu_torch.ops import segment
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
BLOCKED = {'jax', 'jaxlib', 'flax', 'optax', 'socceraction_tpu', 'pandas', 'msgpack'}
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
leaked = sorted(m for m in sys.modules if m.split('.')[0] in BLOCKED)
assert not leaked, leaked
print('isolated')
'''


def test_chip_smoke_path_imports_with_blocked_packages():
    proc = subprocess.run(
        [sys.executable, '-c', _BLOCKER, str(ROOT)],
        capture_output=True, text=True, timeout=120,
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
    'VAEP(cpu).fit_packed(cuda batch)': lambda: VAEP(device='cpu').fit_packed(synthetic_batch(1, 128)),
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
