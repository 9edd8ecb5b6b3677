"""Label transformers of the Atomic-VAEP framework (the pandas oracle).

Port of ``socceraction_tpu/atomic/vaep/labels.py`` (reference
``socceraction/atomic/vaep/labels.py``). Goals and own goals are atomic
action *types*, not shot results; the lookahead clamps at the last row
like the SPADL labels.
"""

from __future__ import annotations

from typing import TYPE_CHECKING, Tuple

import numpy as np

from ...config import LABEL_LOOKAHEAD
from ...vaep.labels import _lookahead
from ..spadl import config as atomicspadl

if TYPE_CHECKING:
    import pandas as pd


def _goal_masks(actions: 'pd.DataFrame') -> Tuple[np.ndarray, np.ndarray]:
    goal = (actions['type_id'] == atomicspadl.GOAL).to_numpy()
    owngoal = (actions['type_id'] == atomicspadl.OWNGOAL).to_numpy()
    return goal, owngoal


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
    """True when a goal directly followed a shot (xG label)."""
    import pandas as pd

    shot = (actions['type_id'] == atomicspadl.actiontypes.index('shot')).to_numpy()
    next_goal = np.append((actions['type_id'].to_numpy()[1:] == atomicspadl.GOAL), False)
    return pd.DataFrame({'goal': shot & next_goal}, index=actions.index)
