"""The port's xG model (``xg.XGModel``) against the JAX package's.

Synthetic SPADL games (the JAX package's ``synthetic_actions_frame``,
used only to make inputs) go through both packages on the CPU: the shot
features, the leak filter and the labels equal JAX's exactly; the
logistic and scikit-learn learners fit the same models (estimates equal,
``score`` within 1e-6); the MLP learner, started from the JAX package's
initial weights and permutations, estimates within 1e-5 and trains on the
model's device.
"""

import jax
import numpy as np
import pandas as pd
import pytest
import torch
from threadpoolctl import threadpool_limits

from socceraction_tpu import xg as jxg
from socceraction_tpu.core.synthetic import synthetic_actions_frame
from socceraction_tpu.ml import mlp as jmlp
from socceraction_tpu_torch import convert
from socceraction_tpu_torch import xg as txg
from socceraction_tpu_torch.ml import mlp as tmlp


@pytest.fixture(scope='module', autouse=True)
def _one_openmp_thread():
    """One OpenMP thread for scikit-learn's fits (as in
    ``tests/test_torch_vaep_frames.py``)."""
    with threadpool_limits(1, user_api='openmp'):
        yield


@pytest.fixture(scope='module')
def season():
    games = []
    for i in range(4):
        gid, home, away = 100 + i, 200 + 2 * i, 201 + 2 * i
        frame = synthetic_actions_frame(gid, home_team_id=home, away_team_id=away, seed=i, n_actions=1200)
        games.append((pd.Series({'game_id': gid, 'home_team_id': home}), frame))
    return games


@pytest.fixture(scope='module')
def data(season):
    model = jxg.XGModel()
    X = pd.concat([model.compute_features(g, a) for g, a in season], ignore_index=True)
    y = pd.concat([model.compute_labels(g, a) for g, a in season], ignore_index=True)
    return X, y


def test_defaults_and_names_equal_jax():
    assert txg.__all__ == jxg.__all__
    assert [fn.__name__ for fn in txg.xfns_default] == [fn.__name__ for fn in jxg.xfns_default]
    for drop in (True, False):
        assert txg.XGModel(drop_leaky=drop, device='cpu').feature_column_names() == jxg.XGModel(
            drop_leaky=drop
        ).feature_column_names()


@pytest.mark.parametrize('drop_leaky', [True, False])
def test_features_and_labels_equal_jax(season, drop_leaky):
    port, jmodel = txg.XGModel(drop_leaky=drop_leaky, device='cpu'), jxg.XGModel(drop_leaky=drop_leaky)
    for g, actions in season[:2]:
        pd.testing.assert_frame_equal(port.compute_features(g, actions), jmodel.compute_features(g, actions))
        pd.testing.assert_frame_equal(port.compute_labels(g, actions), jmodel.compute_labels(g, actions))
    # a sliced frame (no RangeIndex) estimates in its own index
    g, actions = season[0]
    sliced = actions.iloc[100:700]
    pd.testing.assert_frame_equal(port.compute_features(g, sliced), jmodel.compute_features(g, sliced))


@pytest.mark.parametrize('learner', ['logistic', 'sklearn'])
def test_host_learners_fit_as_jax(season, data, learner):
    X, y = data
    port = txg.XGModel(device='cpu').fit(X, y, learner=learner)
    jmodel = jxg.XGModel().fit(X, y, learner=learner)
    for g, actions in season:
        pd.testing.assert_frame_equal(port.estimate(g, actions), jmodel.estimate(g, actions))
    got, want = port.score(X, y), jmodel.score(X, y)
    assert set(got) == set(want) == {'brier', 'auroc', 'log_loss'}
    for k in want:
        assert abs(got[k] - want[k]) <= 1e-6, k


def test_mlp_learner_estimates_as_jax_on_the_models_device(season, data, monkeypatch):
    def init_params(self, n_features):
        jclf = jmlp.MLPClassifier(hidden=self.hidden, seed=self.seed)
        return convert.module_from_jax_params(
            jax.tree.map(np.asarray, jclf._init_params(n_features))
        ).to(self.device)

    def permutation(self, epoch):
        key = jax.random.fold_in(jax.random.PRNGKey(self.seed), epoch)
        return torch.from_numpy(np.asarray(jax.random.permutation(key, self.n)).astype(np.int64))

    monkeypatch.setattr(tmlp.MLPClassifier, 'init_params', init_params)
    monkeypatch.setattr(tmlp._EpochTrainer, '_permutation', permutation)
    X, y = data
    params = {'hidden': (16,), 'max_epochs': 3, 'batch_size': 64}
    port = txg.XGModel(device='cpu').fit(X, y, learner='mlp', tree_params=params)
    jmodel = jxg.XGModel().fit(X, y, learner='mlp', tree_params=params)
    assert port.clf.mean_.device == torch.device('cpu')
    for g, actions in season:
        got, want = port.estimate(g, actions), jmodel.estimate(g, actions)
        np.testing.assert_array_equal(got['xg'].isna(), want['xg'].isna())
        np.testing.assert_allclose(got['xg'].dropna(), want['xg'].dropna(), rtol=0, atol=1e-5)


def test_unknown_learner_and_unfitted_model_raise(season, data):
    g, actions = season[0]
    model = txg.XGModel(device='cpu')
    with pytest.raises(ValueError, match='unknown learner'):
        model.fit(*data, learner='no_such_learner')
    with pytest.raises(ValueError, match='fit the model'):
        model.estimate(g, actions)
    with pytest.raises(ValueError, match='fit the model'):
        model.score(*data)
