"""The port's VAEP DataFrame layer against the JAX package's.

The same SPADL frames go through both packages on the CPU: the golden
``tests/datasets/spadl/spadl.json`` game and a game drawn by the JAX
package's ``synthetic_actions_frame`` (used here only to make inputs).

- Every transformer, ``gamestates``, ``play_left_to_right``, the labels,
  the formula and the SPADL utilities: the port's frames equal JAX's
  exactly (``assert_frame_equal``).
- ``compute_features``/``compute_labels``: the pandas backend exactly,
  the device backend within rtol 1e-5 / atol 1e-6 (the bound of
  ``tests/test_torch_features.py``), labels equal; ``feature_names``
  equal.
- ``fit``: the split is the JAX package's draw; sklearn heads rate as
  JAX's given the same features (tree heads are step functions, so the
  comparison feeds both the same features, as JAX's own
  ``tests/vaep/test_vaep_model.py:81-97`` does); MLP heads, trained from
  JAX's initial weights and permutations, within 1e-5; ``score`` within
  1e-6; checkpoints with tree heads move both ways.
"""

import json

import jax
import numpy as np
import pandas as pd
import pytest
import torch
from threadpoolctl import threadpool_limits

from socceraction_tpu.core.synthetic import synthetic_actions_frame
from socceraction_tpu.ml import mlp as jmlp
from socceraction_tpu.spadl import utils as jutils
from socceraction_tpu.vaep import features as jfs
from socceraction_tpu.vaep import formula as jformula
from socceraction_tpu.vaep import labels as jlabels
from socceraction_tpu.vaep.base import VAEP as JaxVAEP
from socceraction_tpu.vaep.base import load_model as jax_load_model
from socceraction_tpu_torch import convert
from socceraction_tpu_torch.ml import mlp as tmlp
from socceraction_tpu_torch.spadl import utils as tutils
from socceraction_tpu_torch.vaep import features as tfs
from socceraction_tpu_torch.vaep import formula as tformula
from socceraction_tpu_torch.vaep import labels as tlabels
from socceraction_tpu_torch.vaep.base import VAEP, NotFittedError, load_model, split_rows

TRANSFORMERS = [fn.__name__ for fn in jfs.all_features]


@pytest.fixture(scope='module', autouse=True)
def _one_openmp_thread():
    """One OpenMP thread: scikit-learn's histogram boosting spins in its
    parallel regions, and beside other test processes a fit that takes
    seconds alone took minutes."""
    with threadpool_limits(1, user_api='openmp'):
        yield


@pytest.fixture(scope='module', params=['golden', 'synthetic'])
def game(request, spadl_actions):
    """``(game, actions)``: the golden game, or a 600-action synthetic one."""
    if request.param == 'golden':
        return pd.Series({'game_id': 8657, 'home_team_id': 782}), spadl_actions
    frame = synthetic_actions_frame(7, n_actions=600, seed=3)
    return pd.Series({'game_id': 7, 'home_team_id': 100}), frame


@pytest.fixture(scope='module')
def states(game):
    """Both packages' left-to-right game states of the game (k = 3)."""
    g, actions = game
    jstates = jfs.play_left_to_right(jfs.gamestates(jutils.add_names(actions), 3), g.home_team_id)
    tstates = tfs.play_left_to_right(tfs.gamestates(tutils.add_names(actions), 3), g.home_team_id)
    return jstates, tstates


@pytest.fixture(scope='module')
def synthetic_game():
    return pd.Series({'game_id': 7, 'home_team_id': 100}), synthetic_actions_frame(
        7, n_actions=600, seed=3
    )


@pytest.fixture(scope='module')
def frames(synthetic_game):
    """The synthetic game's pandas-backend features and labels (JAX's)."""
    g, actions = synthetic_game
    jmodel = JaxVAEP(backend='pandas')
    return jmodel.compute_features(g, actions), jmodel.compute_labels(g, actions)


# -- the oracle's transformers --------------------------------------------------------------


@pytest.mark.parametrize('name', TRANSFORMERS)
def test_transformer_frames_equal_jax(states, name):
    jstates, tstates = states
    assert getattr(tfs, name).__name__ == name
    pd.testing.assert_frame_equal(getattr(tfs, name)(tstates), getattr(jfs, name)(jstates))


def test_gamestates_and_play_left_to_right_equal_jax(states):
    jstates, tstates = states
    assert len(tstates) == len(jstates) == 3
    for t, j in zip(tstates, jstates):
        pd.testing.assert_frame_equal(t, j)


def test_spadl_utils_equal_jax(game):
    g, actions = game
    pd.testing.assert_frame_equal(tutils.add_names(actions), jutils.add_names(actions))
    for fn in ('play_left_to_right', 'play_left_to_right_sa'):
        pd.testing.assert_frame_equal(
            getattr(tutils, fn)(actions, g.home_team_id), getattr(jutils, fn)(actions, g.home_team_id)
        )


@pytest.mark.parametrize('fn', ['scores', 'concedes', 'goal_from_shot'])
def test_labels_equal_jax(game, fn):
    _, actions = game
    named = jutils.add_names(actions)
    pd.testing.assert_frame_equal(getattr(tlabels, fn)(named), getattr(jlabels, fn)(named))


@pytest.mark.parametrize('fn', ['offensive_value', 'defensive_value', 'value'])
def test_formula_equal_jax(game, fn):
    _, actions = game
    named = jutils.add_names(actions)
    rng = np.random.default_rng(0)
    p_scores = pd.Series(rng.uniform(0, 0.2, len(named)), index=named.index)
    p_concedes = pd.Series(rng.uniform(0, 0.2, len(named)), index=named.index)
    got = getattr(tformula, fn)(named, p_scores, p_concedes)
    want = getattr(jformula, fn)(named, p_scores, p_concedes)
    if isinstance(want, pd.DataFrame):
        pd.testing.assert_frame_equal(got, want)
    else:
        pd.testing.assert_series_equal(got, want)


@pytest.mark.parametrize('k', [1, 2, 3])
def test_feature_column_names_equal_jax(k):
    port = [getattr(tfs, fn.__name__) for fn in jfs.all_features]
    assert tfs.feature_column_names(port, k) == jfs.feature_column_names(jfs.all_features, k)
    assert VAEP(nb_prev_actions=k, device='cpu').feature_names == JaxVAEP(nb_prev_actions=k).feature_names


# -- compute_features / compute_labels ------------------------------------------------------


def test_compute_features_pandas_backend_equals_jax(game):
    g, actions = game
    port = VAEP(backend='pandas', device='cpu')
    jmodel = JaxVAEP(backend='pandas')
    pd.testing.assert_frame_equal(port.compute_features(g, actions), jmodel.compute_features(g, actions))
    pd.testing.assert_frame_equal(port.compute_labels(g, actions), jmodel.compute_labels(g, actions))


def test_compute_features_device_backend_matches_jax(game):
    g, actions = game
    got = VAEP(device='cpu').compute_features(g, actions)
    want = JaxVAEP(backend='jax').compute_features(g, actions)
    assert list(got.columns) == list(want.columns)
    assert got.index.equals(want.index) and (got.dtypes == np.float32).all()
    np.testing.assert_allclose(
        got.to_numpy(np.float64), want.to_numpy(np.float64), rtol=1e-5, atol=1e-6
    )
    pd.testing.assert_frame_equal(
        VAEP(device='cpu').compute_labels(g, actions), JaxVAEP(backend='jax').compute_labels(g, actions)
    )


def test_transformers_by_name_or_callable(game):
    """Kernel names and the transformer callables build the same model."""
    g, actions = game
    by_name = VAEP(xfns=['startlocation', 'team', 'goalscore'], device='cpu')
    by_fn = VAEP(xfns=[tfs.startlocation, tfs.team, tfs.goalscore], device='cpu')
    assert by_name.xfns == by_fn.xfns == ('startlocation', 'team', 'goalscore')
    pd.testing.assert_frame_equal(by_name.compute_features(g, actions), by_fn.compute_features(g, actions))
    want = JaxVAEP(xfns=[jfs.startlocation, jfs.team, jfs.goalscore], backend='pandas')
    pd.testing.assert_frame_equal(
        VAEP(xfns=['startlocation', 'team', 'goalscore'], backend='pandas', device='cpu')
        .compute_features(g, actions),
        want.compute_features(g, actions),
    )


def test_custom_transformer_serves_the_pandas_backend_only(game):
    g, actions = game

    def my_feature(gamestates):
        return pd.DataFrame({'x': gamestates[0]['start_x']})

    frame = VAEP(xfns=[my_feature], backend='pandas', device='cpu').compute_features(g, actions)
    assert list(frame.columns) == ['x']
    with pytest.raises(ValueError, match='has no kernel'):
        VAEP(xfns=[my_feature], device='cpu').compute_features(g, actions)
    with pytest.raises(ValueError, match='has no kernel'):
        VAEP(xfns=['no_such_transformer'], device='cpu')
    with pytest.raises(ValueError, match='unknown backend'):
        VAEP(backend='jax', device='cpu')


# -- fit, rate, score ------------------------------------------------------------------------


@pytest.fixture(scope='module')
def sklearn_fits(frames):
    """(JAX model, port model, port split) fitted with the sklearn learner
    on the same feature frame, split seed 0."""
    X, y = frames
    jmodel = JaxVAEP(backend='pandas').fit(X, y, learner='sklearn', random_state=0)
    port = VAEP(backend='pandas', device='cpu')
    cols = port.feature_names
    split = port.fit_rows(X[cols], {c: y[c] for c in y.columns}, 'sklearn', random_state=0)
    return jmodel, port, split


def test_fit_split_is_the_jax_packages_draw(frames, sklearn_fits):
    X, _ = frames
    _, _, (train_rows, val_rows) = sklearn_fits
    n = len(X)
    idx = np.random.default_rng(0).permutation(n)  # the JAX package's fit
    cut = int(np.floor(n * 0.75))
    np.testing.assert_array_equal(train_rows, idx[:cut])
    np.testing.assert_array_equal(val_rows, idx[cut + 1 :])  # the row at the cut is in neither
    assert (train_rows, val_rows)[0].tolist() == split_rows(n, 0.25, 0)[0].tolist()


def test_sklearn_heads_rate_as_jax(synthetic_game, frames, sklearn_fits):
    g, actions = synthetic_game
    X, _ = frames
    jmodel, port, _ = sklearn_fits
    assert set(port._models) == {'scores', 'concedes'}
    pd.testing.assert_frame_equal(port.rate(g, actions), jmodel.rate(g, actions))
    # fit() on the frame is fit_rows on its columns: the same trees
    again = VAEP(backend='pandas', device='cpu').fit(*frames, learner='sklearn', random_state=0)
    for col in port._models:
        np.testing.assert_array_equal(
            again._models[col].predict_proba(X[port.feature_names]),
            port._models[col].predict_proba(X[port.feature_names]),
        )


def test_tree_heads_on_the_device_path_rate_as_jax_given_the_same_features(synthetic_game, sklearn_fits):
    """Tree heads rate through ``rate_batch``'s materialized path (a host
    frame of the feature tensor); JAX's pandas path given the port's
    device features agrees within 1e-5."""
    g, actions = synthetic_game
    jmodel, port, _ = sklearn_fits
    device = VAEP(models=port._models, device='cpu')
    assert device._rating_path() == 'materialized'
    got = device.rate(g, actions)
    want = jmodel.rate(g, actions, game_states=device.compute_features(g, actions))
    np.testing.assert_allclose(got.to_numpy(), want.to_numpy(), rtol=0, atol=1e-5)


def test_score_matches_jax(frames, sklearn_fits):
    X, y = frames
    jmodel, port, _ = sklearn_fits
    assert (y.nunique() == 2).all()
    got, want = port.score(X, y), jmodel.score(X, y)
    for col in want:
        for metric in ('brier', 'auroc'):
            assert abs(got[col][metric] - want[col][metric]) <= 1e-6, (col, metric)


def _jax_init(monkeypatch):
    """The port's MLP heads start from the JAX package's initial weights
    and draw its permutations."""

    def init_params(self, n_features):
        jclf = jmlp.MLPClassifier(hidden=self.hidden, seed=self.seed)
        params = jax.tree.map(np.asarray, jclf._init_params(n_features))
        return convert.module_from_jax_params(params).to(self.device)

    def permutation(self, epoch):
        key = jax.random.fold_in(jax.random.PRNGKey(self.seed), epoch)
        return torch.from_numpy(np.asarray(jax.random.permutation(key, self.n)).astype(np.int64))

    monkeypatch.setattr(tmlp.MLPClassifier, 'init_params', init_params)
    monkeypatch.setattr(tmlp._EpochTrainer, '_permutation', permutation)


def test_mlp_heads_fit_and_rate_as_jax(synthetic_game, frames, monkeypatch):
    """``fit(learner='mlp')`` on the same frame from JAX's initial weights:
    statistics within 1e-6, parameters within 1e-4, values within 1e-5;
    the heads live on the model's device."""
    _jax_init(monkeypatch)
    g, actions = synthetic_game
    X, y = frames
    params = {'hidden': (16,), 'batch_size': 128, 'max_epochs': 3, 'learning_rate': 1e-3}
    jmodel = JaxVAEP(backend='pandas').fit(X, y, learner='mlp', tree_params=params, random_state=0)
    port = VAEP(backend='pandas', device='cpu').fit(X, y, learner='mlp', tree_params=params, random_state=0)
    for col in ('scores', 'concedes'):
        jclf, clf = jmodel._models[col], port._models[col]
        assert clf.mean_.device == torch.device('cpu') and clf.train_health_['epochs'] == 3
        np.testing.assert_allclose(clf.mean_.numpy(), jclf.mean_, rtol=1e-6, atol=1e-6)
        np.testing.assert_allclose(clf.std_.numpy(), jclf.std_, rtol=1e-6, atol=0)
        tree = convert.jax_params_from_mlp(clf.module)['params']
        gap = max(
            float(np.abs(tree[layer][leaf] - np.asarray(jclf.params['params'][layer][leaf])).max())
            for layer in tree for leaf in ('kernel', 'bias')
        )
        assert gap <= 1e-4, (col, gap)
    np.testing.assert_allclose(
        port.rate(g, actions).to_numpy(), jmodel.rate(g, actions).to_numpy(), rtol=0, atol=1e-5
    )


def test_mlp_fit_serves_the_fused_path(synthetic_game, frames):
    """An MLP pair fitted from frames rates on the fused path within 1e-5
    of its reference, and ``rate`` on the device backend equals
    ``rate_batch`` unpacked."""
    g, actions = synthetic_game
    X, y = frames
    model = VAEP(device='cpu').fit(
        X, y, learner='mlp', tree_params={'hidden': (16,), 'max_epochs': 2}, random_state=0
    )
    assert model._rating_path() == 'fused'
    batch, _ = model._pack(actions, home_team_id=g.home_team_id, device='cpu')
    values = model.rate_batch(batch)
    mask = batch.mask
    np.testing.assert_allclose(
        values[mask].numpy(), model.rate_batch_reference(batch)[mask].numpy(), rtol=0, atol=1e-5
    )
    np.testing.assert_array_equal(
        model.rate(g, actions).to_numpy(),
        values[mask].numpy()[np.argsort(batch.row_index[mask].numpy())],
    )


def test_fit_rejects_missing_columns_and_unknown_learners(frames):
    X, y = frames
    with pytest.raises(ValueError, match='not available'):
        VAEP(backend='pandas', device='cpu').fit(X.iloc[:, :10], y, learner='sklearn')
    with pytest.raises(ValueError, match='not supported'):
        VAEP(backend='pandas', device='cpu').fit(X, y, learner='no_such_learner')


def test_unfitted_model_raises(synthetic_game, frames):
    g, actions = synthetic_game
    X, y = frames
    for backend in ('torch', 'pandas'):
        with pytest.raises(NotFittedError):
            VAEP(backend=backend, device='cpu').rate(g, actions)
    with pytest.raises(NotFittedError):
        VAEP(device='cpu').score(X, y)


# -- checkpoints with tree heads ----------------------------------------------------------------


def test_jax_tree_checkpoint_loads_in_the_port(tmp_path, synthetic_game, sklearn_fits):
    g, actions = synthetic_game
    jmodel, _, _ = sklearn_fits
    jmodel.save_model(str(tmp_path))
    model = load_model(str(tmp_path), device='cpu')
    assert model.backend == 'pandas' and model.xfns == tuple(fn.__name__ for fn in jmodel.xfns)
    pd.testing.assert_frame_equal(model.rate(g, actions), jmodel.rate(g, actions))
    # a device-backend JAX checkpoint ('jax') loads as the port's 'torch'
    device = JaxVAEP(backend='jax')
    device._models = jmodel._models
    device.save_model(str(tmp_path / 'device'))
    back = load_model(str(tmp_path / 'device'), device='cpu')
    assert back.backend == 'torch'
    np.testing.assert_allclose(
        back.rate(g, actions).to_numpy(),
        jmodel.rate(g, actions, game_states=back.compute_features(g, actions)).to_numpy(),
        rtol=0, atol=1e-5,
    )


@pytest.mark.parametrize('backend', ['torch', 'pandas'])
def test_port_tree_checkpoint_loads_in_jax(tmp_path, synthetic_game, sklearn_fits, backend):
    g, actions = synthetic_game
    _, port, _ = sklearn_fits
    model = VAEP(backend=backend, models=port._models, device='cpu')
    model.save_model(str(tmp_path))
    with open(tmp_path / 'meta.json') as f:
        meta = json.load(f)
    assert meta['heads'] == {'scores': 'pickle', 'concedes': 'pickle'}
    assert meta['format_version'] == 1 and meta['backend'] == {'torch': 'jax'}.get(backend, backend)
    assert sorted(meta['checksums']) == ['models/concedes.pkl', 'models/scores.pkl']
    jmodel = jax_load_model(str(tmp_path))
    states = model.compute_features(g, actions)
    np.testing.assert_allclose(
        model.rate(g, actions).to_numpy(),
        jmodel.rate(g, actions, game_states=states).to_numpy(),
        rtol=0, atol=1e-5,
    )
    back = load_model(str(tmp_path), device='cpu')
    assert back.backend == backend
    pd.testing.assert_frame_equal(back.rate(g, actions), model.rate(g, actions))


def test_custom_transformer_cannot_be_saved(tmp_path, sklearn_fits):
    _, port, _ = sklearn_fits

    def my_feature(gamestates):
        return pd.DataFrame({'x': gamestates[0]['start_x']})

    model = VAEP(xfns=[my_feature], backend='pandas', models=port._models, device='cpu')
    with pytest.raises(ValueError, match='custom feature transformer'):
        model.save_model(str(tmp_path))
