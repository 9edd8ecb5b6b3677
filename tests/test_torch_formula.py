"""The PyTorch port's VAEP formula against the JAX package's.

Identical probabilities go into both; the values must agree within 1e-6
(the same f32 subtractions and selects).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from socceraction_tpu.core import batch as jbatch
from socceraction_tpu.core.synthetic import synthetic_batch as jax_synthetic_batch
from socceraction_tpu.ops import formula as jformula
from socceraction_tpu_torch.core import batch as tbatch
from socceraction_tpu_torch.core.synthetic import synthetic_batch
from socceraction_tpu_torch.ops import formula as tformula


def _batches(source, spadl_actions):
    if source == 'golden':
        jb, _ = jbatch.pack_actions(spadl_actions, home_team_id=782)
        tb, _ = tbatch.pack_actions(spadl_actions, home_team_id=782, device='cpu')
        return jb, tb
    return (
        jax_synthetic_batch(3, 256, fill=0.8, seed=5),
        synthetic_batch(3, 256, fill=0.8, seed=5, device='cpu'),
    )


@pytest.mark.parametrize('seed', [0, 1])
@pytest.mark.parametrize('source', ['golden', 'synthetic'])
def test_vaep_values_matches_jax(spadl_actions, source, seed):
    jb, tb = _batches(source, spadl_actions)
    rng = np.random.default_rng(seed)
    ps, pc = rng.uniform(0, 0.3, size=(2, *tb.type_id.shape)).astype(np.float32)
    want = np.asarray(jformula.vaep_values(jb, jnp.asarray(ps), jnp.asarray(pc)))
    got = tformula.vaep_values(tb, torch.from_numpy(ps), torch.from_numpy(pc)).numpy()
    assert got.shape == want.shape == (*tb.type_id.shape, 3)
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-6)


def test_vaep_core_priors_and_resets():
    """Penalty and corner priors, the same-phase cutoff and the goal reset,
    on hand-made lag views."""
    from socceraction_tpu_torch.spadl import config as sc

    type_id = np.array([sc.SHOT_PENALTY, sc.CORNER_CROSSED, sc.PASS, sc.PASS, sc.PASS], np.int32)
    type_prev = np.array([sc.PASS, sc.PASS, sc.SHOT, sc.PASS, sc.PASS], np.int32)
    result_prev = np.array([1, 1, sc.SUCCESS, 1, 0], np.int32)
    sameteam = np.array([True, False, True, False, True])
    t = np.array([10.0, 20.0, 30.0, 40.0, 60.0], np.float32)
    t_prev = np.array([5.0, 15.0, 25.0, 35.0, 45.0], np.float32)
    ps, pc, ps_prev, pc_prev = np.random.default_rng(2).uniform(
        0, 0.2, size=(4, 5)
    ).astype(np.float32)
    args = dict(
        type_prev=type_prev, result_prev=result_prev, sameteam=sameteam,
        time_prev=t_prev, p_scores_prev=ps_prev, p_concedes_prev=pc_prev,
    )
    want = np.asarray(jformula.vaep_core(
        jnp.asarray(type_id), jnp.asarray(t), jnp.asarray(ps), jnp.asarray(pc),
        **{n: jnp.asarray(v) for n, v in args.items()},
    ))
    got = tformula.vaep_core(
        torch.from_numpy(type_id), torch.from_numpy(t),
        torch.from_numpy(ps), torch.from_numpy(pc),
        **{n: torch.from_numpy(v) for n, v in args.items()},
    ).numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-6)
    # the penalty prior replaces the previous action's scoring estimate
    assert got[0, 0] == pytest.approx(ps[0] - 0.792453, abs=1e-6)
