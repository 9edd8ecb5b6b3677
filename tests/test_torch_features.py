"""The PyTorch port's VAEP feature kernels against the JAX package's.

Every kernel runs on the same batch in both packages, at k in {1, 3}, on
the golden game and on a synthetic batch whose games end in padding
(``fill < 1``). Ids, one-hots and counts must be exact; float features
agree to 1e-5 relative (sqrt and arctan may round apart by an ulp).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from socceraction_tpu.core import batch as jbatch
from socceraction_tpu.core.synthetic import synthetic_batch as jax_synthetic_batch
from socceraction_tpu.ops import features as jfeat
from socceraction_tpu.ops import fused as jfused
from socceraction_tpu_torch.core import batch as tbatch
from socceraction_tpu_torch.core.synthetic import synthetic_batch
from socceraction_tpu_torch.ops import features as tfeat
from socceraction_tpu_torch.ops import fused as tfused

NAMES = list(tfeat.KERNELS)

#: Kernels whose columns are ids, 0/1 indicators or integer counts.
EXACT = {
    'actiontype', 'actiontype_onehot', 'result', 'result_onehot',
    'actiontype_result_onehot', 'bodypart', 'bodypart_onehot', 'team',
    'goalscore', 'time',
}


@pytest.fixture(scope='module')
def batches(spadl_actions):
    jg, _ = jbatch.pack_actions(spadl_actions, home_team_id=782)
    tg, _ = tbatch.pack_actions(spadl_actions, home_team_id=782, device='cpu')
    js = jax_synthetic_batch(4, 256, fill=0.7, seed=11)
    ts = synthetic_batch(4, 256, fill=0.7, seed=11, device='cpu')
    return {'golden': (jg, tg), 'synthetic': (js, ts)}


def test_kernel_registry_matches():
    assert set(NAMES) == set(jfeat.KERNELS)


@pytest.mark.parametrize('source', ['golden', 'synthetic'])
@pytest.mark.parametrize('k', [1, 3])
@pytest.mark.parametrize('name', NAMES)
def test_kernel_matches_jax(batches, source, k, name):
    jb, tb = batches[source]
    want = np.asarray(jfeat.KERNELS[name](jfeat._States(jb, k)))
    got = tfeat.KERNELS[name](tfeat._States(tb, k)).numpy()
    assert got.shape == want.shape
    assert got.dtype == want.dtype
    assert got.shape[-1] == tfeat.kernel_width(name, k)
    if name in EXACT:
        np.testing.assert_array_equal(got, want)
    else:
        np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize('source', ['golden', 'synthetic'])
@pytest.mark.parametrize('k', [1, 3])
def test_compute_features_matches_jax(batches, source, k):
    jb, tb = batches[source]
    names = tuple(NAMES)
    want = np.asarray(jfeat.compute_features(jb, names=names, k=k))
    got = tfeat.compute_features(tb, names=names, k=k).numpy()
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize('k', [1, 2, 3, 5])
def test_static_layout_matches_jax_eval_shape(k):
    """The port's static widths equal what the JAX package reads off its
    kernels with ``eval_shape``."""
    names = tuple(NAMES)
    want = jfused.train_layout(
        jax_synthetic_batch(1, 128, seed=0), names=names, k=k
    )
    got = tfused.train_layout(names, k)
    assert got.spans == want.spans
    assert got.n_features == want.n_features


def test_mirror_and_shift_on_golden_game(batches):
    """State 1 of row j is row j-1 (row 0 backfills itself), seen from the
    current action's team."""
    _, tb = batches['golden']
    s = tfeat._States(tb, 2)
    home = tb.is_home[0]
    x = tb.start_x[0]
    prev = x[:-1]
    expected = np.where(home[1:].numpy(), prev.numpy(), 105.0 - prev.numpy())
    np.testing.assert_array_equal(s.start_x[1][0, 1:].numpy(), expected)
    np.testing.assert_array_equal(
        s.type_id[1][0, 0].numpy(), tb.type_id[0, 0].numpy()
    )


def test_one_hot_ignores_out_of_range_ids():
    """``jax.nn.one_hot`` semantics: ids outside the vocabulary are all zero."""
    ids = torch.tensor([[-1, 0, 22, 23]])
    got = tfeat._one_hot(ids, 23, torch.float32).numpy()
    want = np.asarray(
        jax.nn.one_hot(jnp.asarray(ids.numpy()), 23, dtype=jnp.float32)
    )
    np.testing.assert_array_equal(got, want)
