"""The port's learners (``ml/learners.py``) against the JAX package's.

``LEARNERS`` has the JAX package's keys; each booster the environment
lacks raises ``ImportError`` in both packages, and one it has fits the
same model in both; scikit-learn's learner fits the same trees from the
same arrays; the MLP learner trains on the device its parameters name and
never falls back to the CPU on its own.
"""

import importlib

import numpy as np
import pytest
import torch
from threadpoolctl import threadpool_limits

from socceraction_tpu import ml as jml
from socceraction_tpu.ml import learners as jlearners
from socceraction_tpu.vaep import base as jbase
from socceraction_tpu_torch import ml as tml
from socceraction_tpu_torch.ml import learners as tlearners
from socceraction_tpu_torch.ml.mlp import MLPClassifier
from socceraction_tpu_torch.vaep import base as tbase


@pytest.fixture(scope='module', autouse=True)
def _one_openmp_thread():
    """One OpenMP thread for scikit-learn's fits (as in
    ``tests/test_torch_vaep_frames.py``)."""
    with threadpool_limits(1, user_api='openmp'):
        yield


@pytest.fixture(scope='module')
def data():
    rng = np.random.default_rng(0)
    X = rng.normal(size=(600, 12)).astype(np.float32)
    y = (X[:, 0] + 0.5 * rng.normal(size=600)) > 0.8
    return X[:450], y[:450], X[450:], y[450:]


def test_learner_keys_equal_jax():
    assert set(tlearners.LEARNERS) == set(jlearners.LEARNERS)
    assert set(tlearners.PACKED_LEARNERS) == set(jlearners.PACKED_LEARNERS)
    assert tml.LEARNERS is tlearners.LEARNERS
    assert set(jml.__all__) <= set(tml.__all__)
    assert tbase._default_learner() == jbase._default_learner()


@pytest.mark.parametrize('name', ['xgboost', 'catboost', 'lightgbm'])
def test_boosters_as_jax_given_the_installed_packages(data, name):
    X, y, Xv, yv = data
    try:
        importlib.import_module(name)
    except ImportError:
        for learners in (tlearners.LEARNERS, jlearners.LEARNERS):
            with pytest.raises(ImportError, match='not installed'):
                learners[name](X, y)
        return
    got = tlearners.LEARNERS[name](X, y, [(Xv, yv)])
    want = jlearners.LEARNERS[name](X, y, [(Xv, yv)])
    np.testing.assert_allclose(got.predict_proba(Xv), want.predict_proba(Xv), rtol=0, atol=1e-6)


@pytest.mark.parametrize('eval_set', [False, True])
@pytest.mark.parametrize('tree_params', [None, {'max_iter': 20, 'max_depth': 2}])
def test_sklearn_fits_the_jax_packages_trees(data, eval_set, tree_params):
    X, y, Xv, yv = data
    es = [(Xv, yv)] if eval_set else None
    got = tlearners.fit_sklearn(X, y, es, tree_params)
    want = jlearners.fit_sklearn(X, y, es, tree_params)
    assert got.get_params() == want.get_params()
    np.testing.assert_array_equal(got.predict_proba(Xv), want.predict_proba(Xv))


def test_mlp_learner_trains_where_its_parameters_say(data, monkeypatch):
    X, y, Xv, yv = data
    clf = tlearners.fit_mlp(X, y, [(Xv, yv)], {'hidden': (8,), 'max_epochs': 2, 'device': 'cpu'})
    assert isinstance(clf, MLPClassifier) and clf.mean_.device == torch.device('cpu')
    assert clf.train_health_['epochs'] == 2 and len(clf.train_health_['val_losses']) == 2
    p = clf.predict_proba(Xv)
    assert p.shape == (150, 2) and np.isfinite(p).all()
    monkeypatch.setattr(torch.cuda, 'is_available', lambda: False)
    with pytest.raises(RuntimeError, match='device="cpu"'):
        tlearners.fit_mlp(X, y, None, {'hidden': (8,), 'max_epochs': 1})
