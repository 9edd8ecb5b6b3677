"""Label transformers of the VAEP framework (the pandas oracle).

Port of ``socceraction_tpu/vaep/labels.py`` (reference
``socceraction/vaep/labels.py``: ``scores:9``, ``concedes:53``,
``goal_from_shot:96``), the pandas twin of
:func:`socceraction_tpu_torch.ops.labels.scores_concedes`. The lookahead
clamps at the game's last row (edge rows see the final action repeated),
as the reference's ``shift(-i)`` with its tail backfill does.
"""

from __future__ import annotations

from typing import TYPE_CHECKING, Tuple

import numpy as np

from ..config import LABEL_LOOKAHEAD
from ..spadl import config as spadlconfig

if TYPE_CHECKING:
    import pandas as pd


def _goal_masks(actions: 'pd.DataFrame') -> Tuple[np.ndarray, np.ndarray]:
    shot_like = actions['type_name'].str.contains('shot').to_numpy()
    goal = shot_like & (actions['result_id'] == spadlconfig.SUCCESS).to_numpy()
    owngoal = shot_like & (actions['result_id'] == spadlconfig.OWNGOAL).to_numpy()
    return goal, owngoal


def _lookahead(
    goal: np.ndarray, owngoal: np.ndarray, team: np.ndarray, nr_actions: int, concede: bool
) -> np.ndarray:
    n = len(goal)
    res = owngoal.copy() if concede else goal.copy()
    for i in range(1, nr_actions):
        idx = np.minimum(np.arange(n) + i, n - 1)
        same = team[idx] == team
        if concede:
            res |= (goal[idx] & ~same) | (owngoal[idx] & same)
        else:
            res |= (goal[idx] & same) | (owngoal[idx] & ~same)
    return res


def scores(actions: 'pd.DataFrame', nr_actions: int = LABEL_LOOKAHEAD) -> 'pd.DataFrame':
    """True when the acting team scores within the next ``nr_actions``."""
    import pandas as pd

    goal, owngoal = _goal_masks(actions)
    team = actions['team_id'].to_numpy()
    res = _lookahead(goal, owngoal, team, nr_actions, concede=False)
    return pd.DataFrame({'scores': res}, index=actions.index)


def concedes(actions: 'pd.DataFrame', nr_actions: int = LABEL_LOOKAHEAD) -> 'pd.DataFrame':
    """True when the acting team concedes within the next ``nr_actions``."""
    import pandas as pd

    goal, owngoal = _goal_masks(actions)
    team = actions['team_id'].to_numpy()
    res = _lookahead(goal, owngoal, team, nr_actions, concede=True)
    return pd.DataFrame({'concedes': res}, index=actions.index)


def goal_from_shot(actions: 'pd.DataFrame') -> 'pd.DataFrame':
    """True when a goal was scored from the current action (xG label)."""
    import pandas as pd

    goal, _ = _goal_masks(actions)
    return pd.DataFrame({'goal_from_shot': goal}, index=actions.index)
