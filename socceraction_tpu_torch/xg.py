"""Expected goals (xG): P(goal) models over SPADL shots.

Port of ``socceraction_tpu/xg.py``, the library form of the reference's
xG recipe (``public-notebooks/EXTRA-build-expected-goals-model.ipynb``,
notebook-only upstream): game-state features of shot actions, shot-success
labels, one binary classifier, and the notebook's Brier/AUC/log-loss
report. The notebook's feature recipe is kept: its ``xfns`` at
``nb_prev_actions=2``, less the columns that leak the shot's own identity
or outcome (the ``type_*_a0`` one-hots, since every row is a shot, and
``dx_a0``/``dy_a0``/``movement_a0``, since the shot's end point encodes
where the ball went).

Features come from the pandas transformers of
:mod:`socceraction_tpu_torch.vaep.features`, learners from
:data:`~socceraction_tpu_torch.ml.learners.LEARNERS` plus the notebook's
logistic regression; the ``'mlp'`` learner trains on the model's
``device``. pandas and scikit-learn are imported inside the methods.
"""

from __future__ import annotations

import re
from typing import TYPE_CHECKING, Any, Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np

from .device import DeviceLike, resolve_device
from .spadl import config as spadlconfig
from .spadl import utils as spadlutils
from .vaep import features as fs
from .vaep.labels import goal_from_shot

if TYPE_CHECKING:
    import pandas as pd

__all__ = ['XGModel', 'xfns_default']

#: The reference notebook's transformer set (EXTRA notebook, cell 6).
xfns_default: List[fs.FeatureTransfomer] = [
    fs.actiontype_onehot,
    fs.bodypart_onehot,
    fs.startlocation,
    fs.movement,
    fs.space_delta,
    fs.startpolar,
    fs.team,
]

#: Feature columns removed from the matrix (EXTRA notebook, cell 6): the
#: shot's own action-type one-hot block and its movement columns.
_LEAKY = re.compile(r'^type_[a-z_]+_a0$')
_LEAKY_EXACT = frozenset({'dx_a0', 'dy_a0', 'movement_a0'})


def _fit_logistic(
    X: Any,
    y: Any,
    eval_set: Any = None,
    tree_params: Optional[Dict[str, Any]] = None,
    fit_params: Optional[Dict[str, Any]] = None,
) -> Any:
    """The notebook's first model: logistic regression, behind a
    standardization that only conditions the solver (the notebook fits
    raw columns and rides out the convergence warning)."""
    from sklearn.linear_model import LogisticRegression
    from sklearn.pipeline import make_pipeline
    from sklearn.preprocessing import StandardScaler

    clf = make_pipeline(StandardScaler(), LogisticRegression(max_iter=1000, **(tree_params or {})))
    return clf.fit(X, y, **(fit_params or {}))


class XGModel:
    """An xG estimator over SPADL shots.

    Parameters
    ----------
    xfns : list of feature transformers, optional
        Defaults to the reference notebook's set (:data:`xfns_default`).
    nb_prev_actions : int
        Game-state depth; the notebook uses 2.
    drop_leaky : bool
        Remove the shot's own type one-hots and movement columns, as the
        notebook does. Disable to keep the full feature matrix.
    device
        Where the ``'mlp'`` learner trains and predicts: ``cuda``
        (default) or ``'cpu'``.
    """

    def __init__(
        self,
        xfns: Optional[Sequence[fs.FeatureTransfomer]] = None,
        nb_prev_actions: int = 2,
        drop_leaky: bool = True,
        *,
        device: DeviceLike = None,
    ) -> None:
        self.device = resolve_device(device)
        self.xfns = list(xfns) if xfns is not None else list(xfns_default)
        self.nb_prev_actions = nb_prev_actions
        self.drop_leaky = drop_leaky
        self.clf: Any = None
        # fixed for given (xfns, k, drop_leaky), and deriving the names runs
        # every transformer on a dummy frame: do it once
        names = fs.feature_column_names(self.xfns, self.nb_prev_actions)
        if self.drop_leaky:
            names = [n for n in names if not _LEAKY.match(n) and n not in _LEAKY_EXACT]
        self._feature_names = names

    # -- features and labels ------------------------------------------------------

    def _shot_states(
        self, game: Any, game_actions: 'pd.DataFrame'
    ) -> Tuple['pd.DataFrame', Any, np.ndarray]:
        # the game states' shifted views assume a RangeIndex: normalize, so
        # that a filtered or sliced frame does not misalign the concat
        actions = spadlutils.add_names(game_actions.reset_index(drop=True))
        states = fs.play_left_to_right(
            fs.gamestates(actions, self.nb_prev_actions), game.home_team_id
        )
        shots = actions['type_id'].isin(spadlconfig.SHOT_LIKE).to_numpy()
        return actions, states, shots

    def _shot_features(self, states: Any, shots: np.ndarray) -> 'pd.DataFrame':
        import pandas as pd

        feats = pd.concat([fn(states) for fn in self.xfns], axis=1)
        return feats.loc[shots, self._feature_names]

    def feature_column_names(self) -> List[str]:
        """Feature columns after the notebook's leak filter."""
        return list(self._feature_names)

    def compute_features(self, game: Any, game_actions: 'pd.DataFrame') -> 'pd.DataFrame':
        """Game-state features of the game's shots (one row per shot)."""
        _, states, shots = self._shot_states(game, game_actions)
        return self._shot_features(states, shots)

    def compute_labels(self, game: Any, game_actions: 'pd.DataFrame') -> 'pd.DataFrame':
        """``goal`` label per shot: the shot scored (the VAEP labels' goal
        definition, :func:`~socceraction_tpu_torch.vaep.labels.goal_from_shot`)."""
        import pandas as pd

        actions = spadlutils.add_names(game_actions.reset_index(drop=True))
        shots = actions['type_id'].isin(spadlconfig.SHOT_LIKE).to_numpy()
        goal = goal_from_shot(actions)['goal_from_shot'].to_numpy()
        return pd.DataFrame({'goal': goal[shots]})

    # -- fit, estimate, score -------------------------------------------------------

    def fit(self, X: 'pd.DataFrame', y: Any, learner: str = 'logistic', **kwargs: Any) -> 'XGModel':
        """Fit P(goal | shot features).

        ``learner`` is ``'logistic'`` or ``'xgboost'`` (the notebook's two
        models) or any other key of
        :data:`~socceraction_tpu_torch.ml.learners.LEARNERS`; ``kwargs``
        go to the learner (``tree_params``, ``fit_params``, ``eval_set``).
        ``'mlp'`` trains on the model's device unless ``tree_params``
        names another.
        """
        import pandas as pd

        from .ml.learners import LEARNERS

        learners: Dict[str, Callable[..., Any]] = {'logistic': _fit_logistic, **LEARNERS}
        if learner not in learners:
            raise ValueError(f'unknown learner {learner!r}; choose from {sorted(learners)}')
        yv = (y['goal'] if isinstance(y, pd.DataFrame) else y).astype(int)
        kwargs.setdefault('eval_set', None)  # a caller's eval_set wins
        if learner == 'mlp':
            kwargs['tree_params'] = {'device': self.device, **(kwargs.get('tree_params') or {})}
        self.clf = learners[learner](X, yv, **kwargs)
        return self

    def estimate(self, game: Any, game_actions: 'pd.DataFrame') -> 'pd.DataFrame':
        """xG of every action: P(goal) for shots, NaN elsewhere, in a frame
        indexed like ``game_actions``."""
        import pandas as pd

        if self.clf is None:
            raise ValueError('fit the model before calling estimate')
        _, states, shots = self._shot_states(game, game_actions)
        xg = np.full(len(shots), np.nan)
        if shots.any():
            xg[shots] = self.clf.predict_proba(self._shot_features(states, shots))[:, 1]
        return pd.DataFrame({'xg': xg}, index=game_actions.index)

    def score(self, X: 'pd.DataFrame', y: Any) -> Dict[str, float]:
        """Brier, ROC-AUC and log loss (the notebook's report)."""
        import pandas as pd
        from sklearn.metrics import brier_score_loss, log_loss, roc_auc_score

        if self.clf is None:
            raise ValueError('fit the model before calling score')
        yv = (y['goal'] if isinstance(y, pd.DataFrame) else y).astype(int)
        p = self.clf.predict_proba(X)[:, 1]
        out = {'brier': float(brier_score_loss(yv, p))}
        if yv.nunique() > 1:
            out['auroc'] = float(roc_auc_score(yv, p))
            out['log_loss'] = float(log_loss(yv, p))
        return out
