"""The port's Atomic-VAEP DataFrame layer against the JAX package's.

The same Atomic-SPADL frames go through both packages on the CPU: the
golden ``tests/datasets/spadl/atomic_spadl.json`` game and a synthetic
game (the JAX package's ``synthetic_actions_frame`` through its
``convert_to_atomic``, used here only to make inputs). Transformers, game
states, labels, formula and utilities equal JAX's exactly;
``compute_features`` on the device within rtol 1e-5 / atol 1e-6;
sklearn heads fitted on one feature frame rate as JAX's given the same
features, and their checkpoints move both ways.
"""

import json

import numpy as np
import pandas as pd
import pytest
from threadpoolctl import threadpool_limits

from socceraction_tpu.atomic.spadl import convert_to_atomic
from socceraction_tpu.atomic.spadl import utils as jutils
from socceraction_tpu.atomic.vaep import features as jfs
from socceraction_tpu.atomic.vaep import formula as jformula
from socceraction_tpu.atomic.vaep import labels as jlabels
from socceraction_tpu.atomic.vaep.base import AtomicVAEP as JaxAtomicVAEP
from socceraction_tpu.atomic.vaep.base import xfns_default as jax_xfns_default
from socceraction_tpu.core.synthetic import synthetic_actions_frame
from socceraction_tpu.vaep.base import load_model as jax_load_model
from socceraction_tpu_torch.atomic.spadl import utils as tutils
from socceraction_tpu_torch.atomic.vaep import features as tfs
from socceraction_tpu_torch.atomic.vaep import formula as tformula
from socceraction_tpu_torch.atomic.vaep import labels as tlabels
from socceraction_tpu_torch.atomic.vaep.base import XFNS_DEFAULT, AtomicVAEP, xfns_default
from socceraction_tpu_torch.vaep.base import load_model

TRANSFORMERS = [n for n in jfs.__all__ if n not in ('feature_column_names', 'play_left_to_right', 'gamestates')]


@pytest.fixture(scope='module', autouse=True)
def _one_openmp_thread():
    """One OpenMP thread for scikit-learn's fits (as in
    ``tests/test_torch_vaep_frames.py``)."""
    with threadpool_limits(1, user_api='openmp'):
        yield


@pytest.fixture(scope='module')
def synthetic_game():
    frame = convert_to_atomic(synthetic_actions_frame(7, n_actions=600, seed=3))
    return pd.Series({'game_id': 7, 'home_team_id': 100}), frame


@pytest.fixture(scope='module', params=['golden', 'synthetic'])
def game(request, atomic_spadl_actions, synthetic_game):
    if request.param == 'golden':
        return pd.Series({'game_id': 8657, 'home_team_id': 782}), atomic_spadl_actions
    return synthetic_game


@pytest.fixture(scope='module')
def states(game):
    g, actions = game
    jstates = jfs.play_left_to_right(jfs.gamestates(jutils.add_names(actions), 3), g.home_team_id)
    tstates = tfs.play_left_to_right(tfs.gamestates(tutils.add_names(actions), 3), g.home_team_id)
    return jstates, tstates


def test_default_transformers_are_the_jax_packages():
    assert [fn.__name__ for fn in xfns_default] == [fn.__name__ for fn in jax_xfns_default]
    assert XFNS_DEFAULT == tuple(fn.__name__ for fn in jax_xfns_default)
    assert AtomicVAEP(device='cpu').xfns == XFNS_DEFAULT


@pytest.mark.parametrize('name', TRANSFORMERS)
def test_transformer_frames_equal_jax(states, name):
    jstates, tstates = states
    assert getattr(tfs, name).__name__ == name
    pd.testing.assert_frame_equal(getattr(tfs, name)(tstates), getattr(jfs, name)(jstates))


def test_gamestates_and_utilities_equal_jax(game, states):
    g, actions = game
    for t, j in zip(*reversed(states)):
        pd.testing.assert_frame_equal(t, j)
    pd.testing.assert_frame_equal(tutils.add_names(actions), jutils.add_names(actions))
    pd.testing.assert_frame_equal(
        tutils.play_left_to_right(actions, g.home_team_id),
        jutils.play_left_to_right(actions, g.home_team_id),
    )


@pytest.mark.parametrize('fn', ['scores', 'concedes', 'goal_from_shot'])
def test_labels_equal_jax(game, fn):
    named = jutils.add_names(game[1])
    pd.testing.assert_frame_equal(getattr(tlabels, fn)(named), getattr(jlabels, fn)(named))


@pytest.mark.parametrize('fn', ['offensive_value', 'defensive_value', 'value'])
def test_formula_equal_jax(game, fn):
    named = jutils.add_names(game[1])
    rng = np.random.default_rng(1)
    p_scores = pd.Series(rng.uniform(0, 0.2, len(named)), index=named.index)
    p_concedes = pd.Series(rng.uniform(0, 0.2, len(named)), index=named.index)
    got = getattr(tformula, fn)(named, p_scores, p_concedes)
    want = getattr(jformula, fn)(named, p_scores, p_concedes)
    if isinstance(want, pd.DataFrame):
        pd.testing.assert_frame_equal(got, want)
    else:
        pd.testing.assert_series_equal(got, want)


@pytest.mark.parametrize('k', [1, 3])
def test_feature_names_equal_jax(k):
    assert AtomicVAEP(nb_prev_actions=k, device='cpu').feature_names == JaxAtomicVAEP(
        nb_prev_actions=k
    ).feature_names


def test_compute_features_and_labels_equal_jax(game):
    g, actions = game
    port, jmodel = AtomicVAEP(backend='pandas', device='cpu'), JaxAtomicVAEP(backend='pandas')
    pd.testing.assert_frame_equal(port.compute_features(g, actions), jmodel.compute_features(g, actions))
    pd.testing.assert_frame_equal(port.compute_labels(g, actions), jmodel.compute_labels(g, actions))
    got = AtomicVAEP(device='cpu').compute_features(g, actions)
    want = JaxAtomicVAEP(backend='jax').compute_features(g, actions)
    assert list(got.columns) == list(want.columns)
    np.testing.assert_allclose(got.to_numpy(np.float64), want.to_numpy(np.float64), rtol=1e-5, atol=1e-6)
    pd.testing.assert_frame_equal(
        AtomicVAEP(device='cpu').compute_labels(g, actions),
        JaxAtomicVAEP(backend='jax').compute_labels(g, actions),
    )


@pytest.fixture(scope='module')
def fitted(synthetic_game):
    """(JAX model, port model) fitted with the sklearn learner on JAX's
    pandas-backend features of the synthetic game."""
    g, actions = synthetic_game
    jmodel = JaxAtomicVAEP(backend='pandas')
    X, y = jmodel.compute_features(g, actions), jmodel.compute_labels(g, actions)
    jmodel.fit(X, y, learner='sklearn', random_state=0)
    port = AtomicVAEP(backend='pandas', device='cpu').fit(X, y, learner='sklearn', random_state=0)
    return jmodel, port


def test_sklearn_heads_rate_as_jax(synthetic_game, fitted):
    g, actions = synthetic_game
    jmodel, port = fitted
    pd.testing.assert_frame_equal(port.rate(g, actions), jmodel.rate(g, actions))
    device = AtomicVAEP(models=port._models, device='cpu')
    np.testing.assert_allclose(
        device.rate(g, actions).to_numpy(),
        jmodel.rate(g, actions, game_states=device.compute_features(g, actions)).to_numpy(),
        rtol=0, atol=1e-5,
    )


def test_tree_checkpoints_move_both_ways(tmp_path, synthetic_game, fitted):
    g, actions = synthetic_game
    jmodel, port = fitted
    jmodel.save_model(str(tmp_path / 'jax'))
    back = load_model(str(tmp_path / 'jax'), device='cpu')
    assert type(back) is AtomicVAEP and back.backend == 'pandas'
    pd.testing.assert_frame_equal(back.rate(g, actions), jmodel.rate(g, actions))
    port.save_model(str(tmp_path / 'port'))
    with open(tmp_path / 'port' / 'meta.json') as f:
        meta = json.load(f)
    assert meta['class'] == 'AtomicVAEP' and set(meta['heads'].values()) == {'pickle'}
    there = jax_load_model(str(tmp_path / 'port'))
    assert type(there) is JaxAtomicVAEP
    pd.testing.assert_frame_equal(there.rate(g, actions), port.rate(g, actions))
