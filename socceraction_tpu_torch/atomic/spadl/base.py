"""SPADL → Atomic-SPADL converter.

Splits composite actions into atomic events by inserting outcome rows
after passes (receival / interception / out / offside), shots (goal /
owngoal / out) and carded fouls (yellow_card / red_card), then re-runs
dribble synthesis and converts start/end pairs to ``(x, y, dx, dy)``.

Parity: reference ``socceraction/atomic/spadl/base.py:15-235``, including
its quirks: the post-insert ``_add_dribbles`` re-run adds extra dribbles
(the reference comments "for some reason this adds more dribbles" — the
inserted events change the consecutive-action pairs); inserted
interceptions resolve to the SPADL interception id (see
:mod:`.config`); own goals and cards trigger on *result* regardless of
action type. This pass is host-side frame surgery (row counts grow ~2x)
and sits above the packed-tensor boundary.

Port of ``socceraction_tpu/atomic/spadl/base.py``: the same code, with pandas imported inside the functions
that take or build frames, so the module imports where pandas is absent.
"""

from __future__ import annotations

from typing import TYPE_CHECKING

import numpy as np

from ...spadl import config as _spadl
from ...spadl.base import _add_dribbles
from . import config as _atomic
from .schema import AtomicSPADLSchema

if TYPE_CHECKING:  # pandas is imported inside the functions that take or build frames
    import pandas as pd

__all__ = ['convert_to_atomic']

_PASSLIKE_IDS = tuple(
    _spadl.actiontypes.index(t)
    for t in (
        'pass',
        'cross',
        'throw_in',
        'freekick_short',
        'freekick_crossed',
        'corner_crossed',
        'corner_short',
        'clearance',
        'goalkick',
    )
)
_INTERCEPTIONLIKE_IDS = tuple(
    _spadl.actiontypes.index(t)
    for t in (
        'interception',
        'tackle',
        'keeper_punch',
        'keeper_save',
        'keeper_claim',
        'keeper_pick_up',
    )
)
_SHOT_IDS = (_spadl.SHOT, _spadl.SHOT_FREEKICK, _spadl.SHOT_PENALTY)
_GOALKICK = _spadl.actiontypes.index('goalkick')
_THROW_IN = _spadl.actiontypes.index('throw_in')
_CORNER_IDS = (
    _spadl.actiontypes.index('corner_crossed'),
    _spadl.actiontypes.index('corner_short'),
)
_FREEKICK_IDS = (
    _spadl.actiontypes.index('freekick_crossed'),
    _spadl.actiontypes.index('freekick_short'),
    _spadl.SHOT_FREEKICK,
)


def convert_to_atomic(actions: pd.DataFrame) -> pd.DataFrame:
    """Convert a SPADL action frame to Atomic-SPADL.

    Parameters
    ----------
    actions : pd.DataFrame
        A SPADL dataframe (one or more games, ordered within each game).

    Returns
    -------
    pd.DataFrame
        The Atomic-SPADL dataframe.
    """
    atomic = actions.copy()
    atomic = _extra_from_passes(atomic)
    atomic = _add_dribbles(atomic)  # reference re-runs this; adds more dribbles
    atomic = _extra_from_shots(atomic)
    atomic = _extra_from_fouls(atomic)
    atomic = _convert_columns(atomic)
    atomic = _simplify(atomic)
    return AtomicSPADLSchema.validate(atomic)


def _next(actions: pd.DataFrame) -> pd.DataFrame:
    """The successor row for each action (last row: all-NaN phantom)."""
    return actions.shift(-1)


def _merge_and_renumber(actions: pd.DataFrame, extra: pd.DataFrame) -> pd.DataFrame:
    import pandas as pd

    out = pd.concat([actions, extra], ignore_index=True, sort=False)
    out = out.sort_values(['game_id', 'period_id', 'action_id']).reset_index(drop=True)
    out['action_id'] = range(len(out))
    return out


def _extra_template(prev: pd.DataFrame) -> pd.DataFrame:
    """Common fields of an inserted outcome row: at the parent's end point."""
    import pandas as pd

    extra = pd.DataFrame(index=prev.index)
    extra['game_id'] = prev['game_id']
    if 'original_event_id' in prev.columns:
        extra['original_event_id'] = prev['original_event_id']
    extra['period_id'] = prev['period_id']
    extra['action_id'] = prev['action_id'] + 0.1
    extra['time_seconds'] = prev['time_seconds']
    extra['start_x'] = prev['end_x']
    extra['start_y'] = prev['end_y']
    extra['end_x'] = prev['end_x']
    extra['end_y'] = prev['end_y']
    extra['bodypart_id'] = prev['bodypart_id']
    extra['result_id'] = -1
    extra['team_id'] = prev['team_id']
    extra['player_id'] = prev['player_id']
    return extra


def _extra_from_passes(actions: pd.DataFrame) -> pd.DataFrame:
    nex = _next(actions)
    same_team = (actions['team_id'] == nex['team_id']).to_numpy()
    samegame = (actions['game_id'] == nex['game_id']).to_numpy()
    sameperiod = (actions['period_id'] == nex['period_id']).to_numpy()

    extra_idx = (
        actions['type_id'].isin(_PASSLIKE_IDS).to_numpy()
        & samegame
        & sameperiod
        & ~nex['type_id'].isin(_INTERCEPTIONLIKE_IDS).to_numpy()
    )
    prev = actions[extra_idx]
    nex = nex[extra_idx]
    sel_same_team = same_team[extra_idx]

    extra = _extra_template(prev)
    # passes' outcome events happen mid-flight and are foot events
    extra['time_seconds'] = (prev['time_seconds'] + nex['time_seconds']) / 2
    extra['bodypart_id'] = _spadl.FOOT

    offside = (prev['result_id'] == _spadl.OFFSIDE).to_numpy()
    out = (
        (nex['type_id'] == _GOALKICK).to_numpy() & ~sel_same_team
    ) | (nex['type_id'] == _THROW_IN).to_numpy()

    type_id = np.where(sel_same_team, _atomic.RECEIVAL, _atomic.INTERCEPTION)
    type_id = np.where(out, _atomic.OUT, type_id)
    type_id = np.where(offside, _atomic.OFFSIDE, type_id)
    extra['type_id'] = type_id

    is_interception = type_id == _atomic.INTERCEPTION
    extra['team_id'] = prev['team_id'].mask(is_interception, nex['team_id'])
    extra['player_id'] = (
        nex['player_id'].mask(out | offside, prev['player_id'])
        .astype(prev['player_id'].dtype)
    )
    return _merge_and_renumber(actions, extra)


def _extra_from_shots(actions: pd.DataFrame) -> pd.DataFrame:
    nex = _next(actions)
    samegame = (actions['game_id'] == nex['game_id']).to_numpy()
    sameperiod = (actions['period_id'] == nex['period_id']).to_numpy()

    shot = actions['type_id'].isin(_SHOT_IDS).to_numpy()
    goal = shot & (actions['result_id'] == _spadl.SUCCESS).to_numpy()
    owngoal = (actions['result_id'] == _spadl.OWNGOAL).to_numpy()
    next_restart = nex['type_id'].isin(_CORNER_IDS + (_GOALKICK,)).to_numpy()
    out = shot & next_restart & samegame & sameperiod

    extra_idx = goal | owngoal | out
    prev = actions[extra_idx]

    extra = _extra_template(prev)
    type_id = np.full(len(prev), -1)
    type_id = np.where(out[extra_idx], _atomic.OUT, type_id)
    type_id = np.where(goal[extra_idx], _atomic.GOAL, type_id)
    type_id = np.where(owngoal[extra_idx], _atomic.OWNGOAL, type_id)
    extra['type_id'] = type_id
    return _merge_and_renumber(actions, extra)


def _extra_from_fouls(actions: pd.DataFrame) -> pd.DataFrame:
    yellow = (actions['result_id'] == _spadl.YELLOW_CARD).to_numpy()
    red = (actions['result_id'] == _spadl.RED_CARD).to_numpy()

    extra_idx = yellow | red
    prev = actions[extra_idx]

    extra = _extra_template(prev)
    extra['type_id'] = np.where(
        red[extra_idx], _atomic.RED_CARD, _atomic.YELLOW_CARD
    )
    return _merge_and_renumber(actions, extra)


def _convert_columns(actions: pd.DataFrame) -> pd.DataFrame:
    actions['x'] = actions['start_x']
    actions['y'] = actions['start_y']
    actions['dx'] = actions['end_x'] - actions['start_x']
    actions['dy'] = actions['end_y'] - actions['start_y']
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
        'type_id',
        'bodypart_id',
    ]
    if 'original_event_id' not in actions.columns:
        cols.remove('original_event_id')
    return actions[cols]


def _simplify(actions: pd.DataFrame) -> pd.DataFrame:
    type_id = actions['type_id']
    type_id = type_id.mask(type_id.isin(_CORNER_IDS), _atomic.CORNER)
    type_id = type_id.mask(type_id.isin(_FREEKICK_IDS), _atomic.FREEKICK)
    actions['type_id'] = type_id
    return actions
