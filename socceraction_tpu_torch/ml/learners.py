"""The learners of the VAEP probability heads (port of ``socceraction_tpu/ml/learners.py``).

:data:`LEARNERS` trains a head on a materialized feature matrix
(``VAEP.fit``): the reference's xgboost, catboost and lightgbm with its
defaults (reference ``socceraction/vaep/base.py:215-282``), each only
when its package imports, scikit-learn's histogram gradient boosting, and
the MLP, on the device its ``tree_params`` name. :data:`PACKED_LEARNERS`
trains from packed game states (``VAEP.fit_packed``): the MLP and the GRU
sequence head. The tree learners' packages are imported inside their
functions, so this module imports where none of them is installed.
"""

from __future__ import annotations

from typing import Any, Dict, List, Optional, Sequence, Tuple

import numpy as np

from ..device import DeviceLike
from .mlp import MLPClassifier

__all__ = [
    'LEARNERS', 'PACKED_LEARNERS', 'fit_catboost', 'fit_lightgbm', 'fit_mlp', 'fit_mlp_packed',
    'fit_seq_packed', 'fit_sklearn', 'fit_xgboost',
]

EvalSet = Optional[List[Tuple[Any, Any]]]


def _optional(name: str) -> Any:
    """The booster package ``name``; ``ImportError`` when it is not installed."""
    import importlib

    try:
        return importlib.import_module(name)
    except ImportError:
        raise ImportError(f'{name} is not installed') from None


def fit_xgboost(
    X: Any,
    y: Any,
    eval_set: EvalSet = None,
    tree_params: Optional[Dict[str, Any]] = None,
    fit_params: Optional[Dict[str, Any]] = None,
) -> Any:
    """xgboost with the reference's defaults (its ``base.py:215-235``), on
    the xgboost >= 2.0 API (``eval_metric`` and ``early_stopping_rounds``
    are constructor arguments)."""
    xgboost = _optional('xgboost')
    if tree_params is None:
        tree_params = dict(n_estimators=100, max_depth=3, eval_metric='auc')
    else:
        tree_params = dict(tree_params)
    if eval_set is not None:
        tree_params.setdefault('early_stopping_rounds', 10)
    if fit_params is None:
        fit_params = dict(verbose=False)
    if eval_set is not None:
        fit_params = {**fit_params, 'eval_set': eval_set}
    return xgboost.XGBClassifier(**tree_params).fit(X, y, **fit_params)


def fit_catboost(
    X: Any,
    y: Any,
    eval_set: EvalSet = None,
    tree_params: Optional[Dict[str, Any]] = None,
    fit_params: Optional[Dict[str, Any]] = None,
) -> Any:
    """catboost with the reference's defaults (its ``base.py:237-261``)."""
    catboost = _optional('catboost')
    if tree_params is None:
        tree_params = dict(eval_metric='BrierScore', loss_function='Logloss', iterations=100)
    if fit_params is None:
        is_cat = [str(X[c].dtype) == 'category' for c in X.columns]
        fit_params = dict(cat_features=np.nonzero(is_cat)[0].tolist(), verbose=False)
    if eval_set is not None:
        fit_params = {**fit_params, 'early_stopping_rounds': 10, 'eval_set': eval_set}
    return catboost.CatBoostClassifier(**tree_params).fit(X, y, **fit_params)


def fit_lightgbm(
    X: Any,
    y: Any,
    eval_set: EvalSet = None,
    tree_params: Optional[Dict[str, Any]] = None,
    fit_params: Optional[Dict[str, Any]] = None,
) -> Any:
    """lightgbm with the reference's defaults (its ``base.py:263-282``);
    early stopping on the eval set through the callback lightgbm >= 4
    takes."""
    lightgbm = _optional('lightgbm')
    if tree_params is None:
        tree_params = dict(n_estimators=100, max_depth=3)
    if fit_params is None:
        fit_params = dict(eval_metric='auc')
    if eval_set is not None:
        callbacks = list(fit_params.get('callbacks', []))
        callbacks.append(lightgbm.early_stopping(10, verbose=False))
        fit_params = {**fit_params, 'eval_set': eval_set, 'callbacks': callbacks}
    return lightgbm.LGBMClassifier(**tree_params).fit(X, y, **fit_params)


def fit_sklearn(
    X: Any,
    y: Any,
    eval_set: EvalSet = None,
    tree_params: Optional[Dict[str, Any]] = None,
    fit_params: Optional[Dict[str, Any]] = None,
) -> Any:
    """scikit-learn's histogram gradient boosting: 100 iterations of
    depth-3 trees, early stopping when there is a validation set, and
    ``random_state=0`` unless ``tree_params`` sets it (the JAX package's
    learner, deterministic by default)."""
    from sklearn.ensemble import HistGradientBoostingClassifier

    if tree_params is None:
        tree_params = dict(max_iter=100, max_depth=3, early_stopping=eval_set is not None)
    tree_params = {'random_state': 0, **tree_params}
    return HistGradientBoostingClassifier(**tree_params).fit(X, y, **(fit_params or {}))


def fit_mlp(
    X: Any,
    y: Any,
    eval_set: EvalSet = None,
    tree_params: Optional[Dict[str, Any]] = None,
    fit_params: Optional[Dict[str, Any]] = None,
) -> MLPClassifier:
    """The MLP on a materialized feature matrix; ``tree_params`` are the
    :class:`~.mlp.MLPClassifier` arguments (``device`` among them)."""
    model = MLPClassifier(**(tree_params or {}))
    es = eval_set[0] if eval_set else None
    return model.fit(np.asarray(X), np.asarray(y), eval_set=es)


def fit_mlp_packed(
    batch: Any,
    y: Any,
    eval_set: EvalSet = None,
    tree_params: Optional[Dict[str, Any]] = None,
    fit_params: Optional[Dict[str, Any]] = None,
    *,
    names: Sequence[str],
    k: int,
    registry: str = 'standard',
    mean: Any = None,
    std: Any = None,
    device: DeviceLike = None,
) -> MLPClassifier:
    """The MLP trained on packed game states, on ``device``.

    ``batch`` is a packed batch or a ``(TrainStates, TrainLayout)`` pair,
    ``y`` the labels (:meth:`~.mlp.MLPClassifier.fit_packed`);
    ``fit_params`` go to ``fit_packed`` (warm starts).
    """
    model = MLPClassifier(**(tree_params or {}), device=device)
    es = eval_set[0] if eval_set else None
    return model.fit_packed(
        batch, y, names=tuple(names), k=k, registry=registry, eval_set=es, mean=mean,
        std=std, **(fit_params or {}),
    )


def fit_seq_packed(
    batch: Any,
    y: Any,
    eval_set: EvalSet = None,
    tree_params: Optional[Dict[str, Any]] = None,
    fit_params: Optional[Dict[str, Any]] = None,
    *,
    names: Sequence[str],
    k: int,
    registry: str = 'standard',
    mean: Any = None,
    std: Any = None,
    device: DeviceLike = None,
) -> Any:
    """The GRU sequence head trained on packed game states, on ``device``:
    :func:`fit_mlp_packed`'s calling convention, with
    :class:`~socceraction_tpu_torch.seq.classifier.SeqClassifier`
    arguments in ``tree_params``."""
    from ..seq.classifier import SeqClassifier

    model = SeqClassifier(**(tree_params or {}), device=device)
    es = eval_set[0] if eval_set else None
    return model.fit_packed(
        batch, y, names=tuple(names), k=k, registry=registry, eval_set=es, mean=mean,
        std=std, **(fit_params or {}),
    )


LEARNERS: Dict[str, Any] = {
    'xgboost': fit_xgboost,
    'catboost': fit_catboost,
    'lightgbm': fit_lightgbm,
    'sklearn': fit_sklearn,
    'mlp': fit_mlp,
}

#: Learners that train from the packed game-state representation
#: (``VAEP.fit_packed``).
PACKED_LEARNERS: Dict[str, Any] = {'mlp': fit_mlp_packed, 'seq': fit_seq_packed}
