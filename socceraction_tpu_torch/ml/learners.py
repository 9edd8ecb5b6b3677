"""The learners of the VAEP probability heads (port of ``socceraction_tpu/ml/learners.py``).

Only the MLP is ported. The gradient-boosted-tree learners need the
materialized feature matrix on the host and have no packed path, and the
sequence head is not ported yet: both raise where ``VAEP.fit_packed``
resolves its learner.
"""

from __future__ import annotations

from typing import Any, Dict, List, Optional, Sequence, Tuple

import numpy as np

from ..device import DeviceLike
from .mlp import MLPClassifier

__all__ = ['LEARNERS', 'PACKED_LEARNERS', 'fit_mlp', 'fit_mlp_packed']

EvalSet = Optional[List[Tuple[Any, Any]]]


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
    mean: Any = None,
    std: Any = None,
    device: DeviceLike = None,
) -> MLPClassifier:
    """The MLP trained on packed game states, on ``device``.

    ``batch`` is an ``ActionBatch`` or a ``(TrainStates, TrainLayout)``
    pair, ``y`` the labels (:meth:`~.mlp.MLPClassifier.fit_packed`);
    ``fit_params`` go to ``fit_packed`` (warm starts).
    """
    model = MLPClassifier(**(tree_params or {}), device=device)
    es = eval_set[0] if eval_set else None
    return model.fit_packed(
        batch, y, names=tuple(names), k=k, eval_set=es, mean=mean, std=std,
        **(fit_params or {}),
    )


LEARNERS: Dict[str, Any] = {'mlp': fit_mlp}

#: Learners that train from the packed game-state representation
#: (``VAEP.fit_packed``).
PACKED_LEARNERS: Dict[str, Any] = {'mlp': fit_mlp_packed}
