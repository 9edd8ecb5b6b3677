"""Feature transformers of the VAEP framework (the pandas oracle).

Port of ``socceraction_tpu/vaep/features.py``. Each transformer maps a
list of game states (the action plus its ``nb_prev_actions - 1``
predecessors) to a block of feature columns, with the reference's names
(``socceraction/vaep/features.py``: ``gamestates:62``,
``play_left_to_right:91``, the ``@simple`` decorator ``:119-145``, the
per-action and state features ``:148-539``).

These pandas transformers define the oracle's semantics. The device path
computes the same features over a packed
:class:`~socceraction_tpu_torch.core.batch.ActionBatch` with the kernels
of :mod:`socceraction_tpu_torch.ops.features`, keyed by the ``__name__``
of the transformers below. pandas is imported inside the functions, so
this module imports where pandas is absent.
"""

from __future__ import annotations

from functools import wraps
from typing import TYPE_CHECKING, Any, Callable, List

import numpy as np

from ..spadl import config as spadlconfig

if TYPE_CHECKING:
    import pandas as pd

Actions = 'pd.DataFrame'
GameStates = List[Any]  # a list of frames, one per state
Features = 'pd.DataFrame'
FeatureTransfomer = Callable[[GameStates], Any]  # reference typo kept for parity

_goal_x: float = spadlconfig.field_length
_goal_y: float = spadlconfig.field_width / 2


def feature_column_names(fs: List[FeatureTransfomer], nb_prev_actions: int = 3) -> List[str]:
    """Return the names of the features generated by a list of transformers.

    Derived exactly like the reference (``features.py:20-59``): by executing
    the transformers on a 10-row dummy frame, so names and order always
    agree with what the transformers actually emit.
    """
    import pandas as pd

    spadlcolumns = [
        'game_id',
        'original_event_id',
        'action_id',
        'period_id',
        'time_seconds',
        'team_id',
        'player_id',
        'start_x',
        'start_y',
        'end_x',
        'end_y',
        'result_id',
        'result_name',
        'bodypart_id',
        'bodypart_name',
        'type_id',
        'type_name',
    ]
    dummy = pd.DataFrame(np.zeros((10, len(spadlcolumns))), columns=spadlcolumns)
    for c in spadlcolumns:
        if 'name' in c:
            dummy[c] = dummy[c].astype(str)
    gs = gamestates(dummy, nb_prev_actions)
    return list(pd.concat([f(gs) for f in fs], axis=1).columns.values)


def gamestates(actions: Actions, nb_prev_actions: int = 3) -> GameStates:
    """Convert a game's actions to game states.

    State ``i`` holds, for every action row ``j``, the action at position
    ``max(j - i, 0)`` -- i.e. the i-th previous action, with the game's
    first action backfilling the edge (reference ``features.py:83-88``).
    """
    states = [actions]
    n = len(actions)
    for i in range(1, nb_prev_actions):
        idx = np.maximum(np.arange(n) - i, 0)
        states.append(actions.iloc[idx].reset_index(drop=True))
    return states


def play_left_to_right(gamestates: GameStates, home_team_id: int) -> GameStates:
    """Mirror every state of away-possession rows so play runs left-to-right.

    The flip is decided by the *current* action's team (state ``a0``), and
    applied to all states of that row (reference ``features.py:109-116``).
    """
    a0 = gamestates[0]
    away = (a0['team_id'] != home_team_id).to_numpy()
    out = []
    for actions in gamestates:
        flipped = actions.copy()
        for col, extent in (
            ('start_x', spadlconfig.field_length),
            ('end_x', spadlconfig.field_length),
            ('start_y', spadlconfig.field_width),
            ('end_y', spadlconfig.field_width),
        ):
            flipped.loc[away, col] = extent - actions.loc[away, col].to_numpy()
        out.append(flipped)
    return out


def simple(actionfn: Callable) -> FeatureTransfomer:
    """Lift a per-action feature function to game states.

    The lifted transformer applies ``actionfn`` to every state and suffixes
    its columns with ``_a0``, ``_a1``, ... (reference ``features.py:119-145``).
    """

    @wraps(actionfn)
    def _wrapper(gamestates) -> pd.DataFrame:
        import pandas as pd

        if not isinstance(gamestates, (list,)):
            gamestates = [gamestates]
        X = []
        for i, a in enumerate(gamestates):
            Xi = actionfn(a)
            Xi.columns = [c + '_a' + str(i) for c in Xi.columns]
            X.append(Xi)
        return pd.concat(X, axis=1)

    _wrapper.__wrapped__ = actionfn
    return _wrapper


# ---------------------------------------------------------------------------
# simple (per-action) features
# ---------------------------------------------------------------------------


@simple
def actiontype(actions: Actions) -> Features:
    """The 'type_id' of each action."""
    return actions[['type_id']]


@simple
def actiontype_onehot(actions: Actions) -> Features:
    """One-hot encoding of each action's type."""
    import pandas as pd

    return pd.DataFrame(
        {'type_' + t: actions['type_name'] == t for t in spadlconfig.actiontypes}
    )


@simple
def result(actions: Actions) -> Features:
    """The 'result_id' of each action."""
    return actions[['result_id']]


@simple
def result_onehot(actions: Actions) -> Features:
    """One-hot encoding of each action's result."""
    import pandas as pd

    return pd.DataFrame(
        {'result_' + r: actions['result_name'] == r for r in spadlconfig.results}
    )


@simple
def actiontype_result_onehot(actions: Actions) -> Features:
    """One-hot encoding of the (type, result) combination (type-major)."""
    import pandas as pd

    res = result_onehot.__wrapped__(actions)
    tys = actiontype_onehot.__wrapped__(actions)
    return pd.DataFrame(
        {
            f'{tyscol}_{rescol}': tys[tyscol] & res[rescol]
            for tyscol in tys.columns
            for rescol in res.columns
        }
    )


@simple
def bodypart(actions: Actions) -> Features:
    """The 'bodypart_id' of each action."""
    return actions[['bodypart_id']]


@simple
def bodypart_onehot(actions: Actions) -> Features:
    """One-hot encoding of each action's bodypart."""
    import pandas as pd

    return pd.DataFrame(
        {'bodypart_' + b: actions['bodypart_name'] == b for b in spadlconfig.bodyparts}
    )


@simple
def time(actions: Actions) -> Features:
    """Period, seconds since period start, and seconds since game start.

    'time_seconds_overall' assumes 45-minute periods and ignores stoppage
    time, like the reference (``features.py:313``).
    """
    timedf = actions[['period_id', 'time_seconds']].copy()
    timedf['time_seconds_overall'] = ((timedf['period_id'] - 1) * 45 * 60) + timedf[
        'time_seconds'
    ]
    return timedf


@simple
def startlocation(actions: Actions) -> Features:
    """The 'start_x' and 'start_y' location of each action."""
    return actions[['start_x', 'start_y']]


@simple
def endlocation(actions: Actions) -> Features:
    """The 'end_x' and 'end_y' location of each action."""
    return actions[['end_x', 'end_y']]


def _polar(x: np.ndarray, y: np.ndarray, prefix: str, dist: str, angle: str) -> Features:
    import pandas as pd

    dx = np.abs(_goal_x - x)
    dy = np.abs(_goal_y - y)
    out = pd.DataFrame()
    out[dist] = np.sqrt(dx**2 + dy**2)
    with np.errstate(divide='ignore', invalid='ignore'):
        out[angle] = np.nan_to_num(np.arctan(dy / dx))
    return out


@simple
def startpolar(actions: Actions) -> Features:
    """Distance and angle to the opponent goal from the start location.

    ``angle = nan_to_num(arctan(dy / dx))``: on the goal line (dx == 0) the
    angle saturates to pi/2 for dy > 0 and is zeroed at the goal center,
    IEEE semantics shared by both backends (reference ``features.py:375-376``).
    """
    return _polar(
        actions['start_x'].to_numpy(dtype=float),
        actions['start_y'].to_numpy(dtype=float),
        'start',
        'start_dist_to_goal',
        'start_angle_to_goal',
    )


@simple
def endpolar(actions: Actions) -> Features:
    """Distance and angle to the opponent goal from the end location."""
    return _polar(
        actions['end_x'].to_numpy(dtype=float),
        actions['end_y'].to_numpy(dtype=float),
        'end',
        'end_dist_to_goal',
        'end_angle_to_goal',
    )


@simple
def movement(actions: Actions) -> Features:
    """Horizontal, vertical and total distance covered by each action."""
    import pandas as pd

    mov = pd.DataFrame()
    mov['dx'] = actions['end_x'] - actions['start_x']
    mov['dy'] = actions['end_y'] - actions['start_y']
    mov['movement'] = np.sqrt(mov['dx'] ** 2 + mov['dy'] ** 2)
    return mov


# ---------------------------------------------------------------------------
# state features
# ---------------------------------------------------------------------------


def team(gamestates: GameStates) -> Features:
    """Whether each previous action was by the current action's team."""
    import pandas as pd

    a0 = gamestates[0]
    teamdf = pd.DataFrame()
    for i, a in enumerate(gamestates[1:]):
        teamdf['team_' + str(i + 1)] = a['team_id'] == a0['team_id']
    return teamdf


def time_delta(gamestates: GameStates) -> Features:
    """Seconds elapsed between each previous action and the current one."""
    import pandas as pd

    a0 = gamestates[0]
    dt = pd.DataFrame()
    for i, a in enumerate(gamestates[1:]):
        dt['time_delta_' + str(i + 1)] = a0['time_seconds'] - a['time_seconds']
    return dt


def space_delta(gamestates: GameStates) -> Features:
    """Distance from each previous action's end to the current action's start."""
    import pandas as pd

    a0 = gamestates[0]
    spaced = pd.DataFrame()
    for i, a in enumerate(gamestates[1:]):
        dx = a['end_x'] - a0['start_x']
        spaced['dx_a0' + str(i + 1)] = dx
        dy = a['end_y'] - a0['start_y']
        spaced['dy_a0' + str(i + 1)] = dy
        spaced['mov_a0' + str(i + 1)] = np.sqrt(dx**2 + dy**2)
    return spaced


# ---------------------------------------------------------------------------
# context features
# ---------------------------------------------------------------------------


def goalscore(gamestates: GameStates) -> Features:
    """Scoreline before each action: own goals, opponent goals, difference.

    Goals are shot-like actions (type name contains 'shot') with a success
    result; own goals are shot-like with an owngoal result. The running
    score *excludes* the current action (cumsum minus self, reference
    ``features.py:532-533``).
    """
    import pandas as pd

    actions = gamestates[0]
    teamA = actions['team_id'].values[0]
    shot_like = actions['type_name'].str.contains('shot')
    goals = shot_like & (actions['result_id'] == spadlconfig.SUCCESS)
    owngoals = shot_like & (actions['result_id'] == spadlconfig.OWNGOAL)
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


all_features: List[FeatureTransfomer] = [
    actiontype,
    actiontype_onehot,
    result,
    result_onehot,
    actiontype_result_onehot,
    bodypart,
    bodypart_onehot,
    time,
    startlocation,
    endlocation,
    startpolar,
    endpolar,
    movement,
    team,
    time_delta,
    space_delta,
    goalscore,
]
