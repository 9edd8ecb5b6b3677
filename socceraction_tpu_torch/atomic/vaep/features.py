"""Feature transformers of the Atomic-VAEP framework (the pandas oracle).

Port of ``socceraction_tpu/atomic/vaep/features.py``. It shares the
game-state machinery and the per-action transformers that do not touch
locations or results with the VAEP features (reference
``socceraction/atomic/vaep/features.py:11-20`` imports them the same way)
and adds the atomic location and direction transformers and the
type-based goalscore. The device twins are the kernels of
:mod:`socceraction_tpu_torch.ops.atomic`, keyed by ``__name__``; pandas
is imported inside the functions.

Column-name quirk kept: the atomic vocabulary lists ``'interception'``
twice (SPADL id 10, atomic id 24), so ``actiontype_onehot`` emits ONE
``type_interception`` column (32 columns per state, not 33) that is true
for both ids.
"""

from __future__ import annotations

from typing import List

import numpy as np

from ...vaep.features import (  # noqa: F401  (re-exported, reference parity)
    Actions,
    FeatureTransfomer,
    Features,
    GameStates,
    actiontype,
    bodypart,
    bodypart_onehot,
    gamestates,
    simple,
    team,
    time,
    time_delta,
)
from ..spadl import config as atomicspadl

__all__ = [
    'feature_column_names',
    'play_left_to_right',
    'gamestates',
    'actiontype',
    'actiontype_onehot',
    'bodypart',
    'bodypart_onehot',
    'team',
    'time',
    'time_delta',
    'location',
    'polar',
    'movement_polar',
    'direction',
    'goalscore',
]

_goal_x: float = atomicspadl.field_length
_goal_y: float = atomicspadl.field_width / 2


def feature_column_names(fs: List[FeatureTransfomer], nb_prev_actions: int = 3) -> List[str]:
    """Return the names of the features generated by a list of transformers.

    Executes the transformers on a 10-row dummy atomic frame (reference
    ``atomic/vaep/features.py:46-82``).
    """
    import pandas as pd

    cols = [
        'game_id',
        'original_event_id',
        'action_id',
        'period_id',
        'time_seconds',
        'team_id',
        'player_id',
        'x',
        'y',
        'dx',
        'dy',
        'bodypart_id',
        'bodypart_name',
        'type_id',
        'type_name',
    ]
    dummy = pd.DataFrame(np.zeros((10, len(cols))), columns=cols)
    for c in cols:
        if 'name' in c:
            dummy[c] = dummy[c].astype(str)
    gs = gamestates(dummy, nb_prev_actions)
    return list(pd.concat([f(gs) for f in fs], axis=1).columns.values)


def play_left_to_right(gamestates: GameStates, home_team_id: int) -> GameStates:
    """Mirror every state of away-possession rows so play runs left-to-right.

    Flip decided by the current action's team; applied to ``x``/``y``
    (mirrored) and ``dx``/``dy`` (negated).
    """
    a0 = gamestates[0]
    away = (a0['team_id'] != home_team_id).to_numpy()
    out = []
    for actions in gamestates:
        flipped = actions.copy()
        flipped.loc[away, 'x'] = atomicspadl.field_length - actions.loc[away, 'x'].to_numpy()
        flipped.loc[away, 'y'] = atomicspadl.field_width - actions.loc[away, 'y'].to_numpy()
        flipped.loc[away, 'dx'] = -actions.loc[away, 'dx'].to_numpy()
        flipped.loc[away, 'dy'] = -actions.loc[away, 'dy'].to_numpy()
        out.append(flipped)
    return out


@simple
def actiontype_onehot(actions: Actions) -> Features:
    """One-hot encoding of each atomic action's type (32 unique names)."""
    import pandas as pd

    X = pd.DataFrame()
    for type_name in atomicspadl.actiontypes:
        X['type_' + type_name] = actions['type_name'] == type_name
    return X


@simple
def location(actions: Actions) -> Features:
    """The 'x' and 'y' location of each action."""
    return actions[['x', 'y']]


@simple
def polar(actions: Actions) -> Features:
    """Distance and angle to the opponent goal from the action location."""
    import pandas as pd

    out = pd.DataFrame()
    dx = np.abs(_goal_x - actions['x'].to_numpy(dtype=float))
    dy = np.abs(_goal_y - actions['y'].to_numpy(dtype=float))
    out['dist_to_goal'] = np.sqrt(dx**2 + dy**2)
    with np.errstate(divide='ignore', invalid='ignore'):
        out['angle_to_goal'] = np.nan_to_num(np.arctan(dy / dx))
    return out


@simple
def movement_polar(actions: Actions) -> Features:
    """Distance covered and direction of each action.

    Reference quirk kept: rows with ``dy == 0`` get angle 0 even when
    moving backwards (``atomic/vaep/features.py:195``).
    """
    import pandas as pd

    mov = pd.DataFrame()
    mov['mov_d'] = np.sqrt(actions['dx'] ** 2 + actions['dy'] ** 2)
    with np.errstate(divide='ignore', invalid='ignore'):
        mov['mov_angle'] = np.arctan2(actions['dy'], actions['dx'])
        mov.loc[actions['dy'] == 0, 'mov_angle'] = 0
    return mov


@simple
def direction(actions: Actions) -> Features:
    """Unit-vector direction of each action (zero rows stay zero)."""
    import pandas as pd

    mov = pd.DataFrame()
    totald = np.sqrt(actions['dx'] ** 2 + actions['dy'] ** 2)
    for d in ['dx', 'dy']:
        mov[d] = actions[d].mask(totald > 0, actions[d] / totald)
    return mov


def goalscore(gamestates: GameStates) -> Features:
    """Scoreline before each action; goals/owngoals are action *types* here."""
    import pandas as pd

    actions = gamestates[0]
    teamA = actions['team_id'].values[0]
    goals = actions['type_name'] == 'goal'
    owngoals = actions['type_name'].str.contains('owngoal')
    teamisA = actions['team_id'] == teamA
    teamisB = ~teamisA
    goalsteamA = (goals & teamisA) | (owngoals & teamisB)
    goalsteamB = (goals & teamisB) | (owngoals & teamisA)
    goalscoreteamA = goalsteamA.cumsum() - goalsteamA
    goalscoreteamB = goalsteamB.cumsum() - goalsteamB

    scoredf = pd.DataFrame()
    scoredf['goalscore_team'] = (goalscoreteamA * teamisA) + (goalscoreteamB * teamisB)
    scoredf['goalscore_opponent'] = (goalscoreteamB * teamisA) + (goalscoreteamA * teamisB)
    scoredf['goalscore_diff'] = scoredf['goalscore_team'] - scoredf['goalscore_opponent']
    return scoredf
