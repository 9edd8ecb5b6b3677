"""Opta event stream → SPADL converter.

Parity: reference ``socceraction/spadl/opta.py:12-170``. Same observable
semantics, vectorized: the reference maps row-wise if/elif chains with
``DataFrame.apply``; here type/result/bodypart are ``np.select`` over
columnar masks (first-match-wins reproduces the precedence), with the
qualifier-set membership tests precomputed once as boolean arrays.

Port of ``socceraction_tpu/spadl/opta.py``: the same code, with pandas imported inside the functions
that take or build frames, so the module imports where pandas is absent.
"""

from __future__ import annotations

from typing import TYPE_CHECKING, Dict, List

import numpy as np

from . import config as spadlconfig
from .base import _add_dribbles, _fix_clearances, _fix_direction_of_play
from .schema import SPADLSchema

if TYPE_CHECKING:  # pandas is imported inside the functions that take or build frames
    import pandas as pd

__all__ = ['convert_to_actions']


def convert_to_actions(events: pd.DataFrame, home_team_id: int) -> pd.DataFrame:
    """Convert Opta events of one game to SPADL actions.

    Parameters
    ----------
    events : pd.DataFrame
        Opta events of a single game (see
        :meth:`~socceraction_tpu_torch.data.opta.OptaLoader.events`).
    home_team_id : int
        ID of the game's home team.

    Returns
    -------
    pd.DataFrame
        The game's actions in SPADL format.
    """
    import pandas as pd

    actions = pd.DataFrame(
        {
            'game_id': events['game_id'],
            'original_event_id': events['event_id'].astype(object),
            'period_id': events['period_id'],
            'time_seconds': (
                60 * events['minute']
                + events['second']
                - ((events['period_id'] > 1) * 45 * 60)
                - ((events['period_id'] > 2) * 45 * 60)
                - ((events['period_id'] > 3) * 15 * 60)
                - ((events['period_id'] > 4) * 15 * 60)
            ),
            'team_id': events['team_id'],
            'player_id': events['player_id'],
        }
    )
    for col in ('start_x', 'end_x'):
        actions[col] = events[col].clip(0, 100) / 100 * spadlconfig.field_length
    for col in ('start_y', 'end_y'):
        actions[col] = events[col].clip(0, 100) / 100 * spadlconfig.field_width

    type_name = events['type_name']
    n = len(events)
    # `outcome` is nullable: the reference distinguishes `outcome is False`
    # (type mapping) from plain truthiness (result mapping); None matches
    # neither a strict False nor a truthy success.
    outcome_false = np.fromiter(
        (v is False for v in events['outcome']), dtype=bool, count=n
    )
    outcome_truthy = np.fromiter(
        (bool(v) for v in events['outcome']), dtype=bool, count=n
    )
    has_q = _qualifier_masks(
        events['qualifiers'], [2, 5, 6, 9, 15, 21, 26, 28, 107, 124]
    )

    actions['type_id'] = _determine_type(type_name, outcome_false, has_q)
    actions['result_id'] = _determine_result(type_name, outcome_truthy, has_q)
    actions['bodypart_id'] = np.select(
        [has_q[15], has_q[21]],
        [spadlconfig.HEAD, spadlconfig.OTHER],
        default=spadlconfig.FOOT,
    )

    actions = (
        actions[actions['type_id'] != spadlconfig.NON_ACTION]
        .sort_values(['game_id', 'period_id', 'time_seconds'])
        .reset_index(drop=True)
    )
    actions = _fix_owngoals(actions)
    actions = _fix_direction_of_play(actions, home_team_id)
    actions = _fix_clearances(actions)
    actions['action_id'] = range(len(actions))
    actions = _add_dribbles(actions)
    return SPADLSchema.validate(actions)


def _qualifier_masks(
    qualifiers: pd.Series, ids: List[int]
) -> Dict[int, np.ndarray]:
    """Precompute ``id in qualifiers`` membership per event for each id."""
    sets = [set(q) if isinstance(q, dict) else set() for q in qualifiers]
    return {
        qid: np.fromiter((qid in s for s in sets), dtype=bool, count=len(sets))
        for qid in ids
    }


def _determine_type(
    type_name: pd.Series, outcome_false: np.ndarray, q: Dict[int, np.ndarray]
) -> np.ndarray:
    """Columnar equivalent of the reference's per-event type mapping.

    Qualifiers: 2 cross, 5 freekick, 6 corner, 9 penalty, 26 freekick
    shot, 107 throw-in, 124 goalkick (reference ``spadl/opta.py:103-156``).
    """
    at = spadlconfig.actiontypes.index
    is_pass = type_name.isin(['pass', 'offside pass']).to_numpy()
    is_shot = type_name.isin(['miss', 'post', 'attempt saved', 'goal']).to_numpy()
    conditions = [
        is_pass & q[107],
        is_pass & q[5] & q[2],
        is_pass & q[5],
        is_pass & q[6] & q[2],
        is_pass & q[6],
        is_pass & q[2],
        is_pass & q[124],
        is_pass,
        (type_name == 'take on').to_numpy(),
        (type_name == 'foul').to_numpy() & outcome_false,
        (type_name == 'tackle').to_numpy(),
        type_name.isin(['interception', 'blocked pass']).to_numpy(),
        is_shot & q[9],
        is_shot & q[26],
        is_shot,
        (type_name == 'save').to_numpy(),
        (type_name == 'claim').to_numpy(),
        (type_name == 'punch').to_numpy(),
        (type_name == 'keeper pick-up').to_numpy(),
        (type_name == 'clearance').to_numpy(),
        (type_name == 'ball touch').to_numpy() & outcome_false,
    ]
    choices = [
        at('throw_in'),
        at('freekick_crossed'),
        at('freekick_short'),
        at('corner_crossed'),
        at('corner_short'),
        at('cross'),
        at('goalkick'),
        at('pass'),
        at('take_on'),
        at('foul'),
        at('tackle'),
        at('interception'),
        at('shot_penalty'),
        at('shot_freekick'),
        at('shot'),
        at('keeper_save'),
        at('keeper_claim'),
        at('keeper_punch'),
        at('keeper_pick_up'),
        at('clearance'),
        at('bad_touch'),
    ]
    return np.select(conditions, choices, default=spadlconfig.NON_ACTION)


def _determine_result(
    type_name: pd.Series, outcome_truthy: np.ndarray, q: Dict[int, np.ndarray]
) -> np.ndarray:
    """Columnar equivalent of the reference's per-event result mapping.

    Qualifier 28 marks an own goal (reference ``spadl/opta.py:81-100``).
    """
    conditions = [
        (type_name == 'offside pass').to_numpy(),
        (type_name == 'foul').to_numpy(),
        type_name.isin(['attempt saved', 'miss', 'post']).to_numpy(),
        ((type_name == 'goal') & q[28]).to_numpy(),
        (type_name == 'goal').to_numpy(),
        (type_name == 'ball touch').to_numpy(),
        outcome_truthy,
    ]
    choices = [
        spadlconfig.OFFSIDE,
        spadlconfig.FAIL,
        spadlconfig.FAIL,
        spadlconfig.OWNGOAL,
        spadlconfig.SUCCESS,
        spadlconfig.FAIL,
        spadlconfig.SUCCESS,
    ]
    return np.select(conditions, choices, default=spadlconfig.FAIL)


def _fix_owngoals(actions: pd.DataFrame) -> pd.DataFrame:
    """Mirror own-goal end coordinates and retype them as bad touches."""
    owngoal = (actions['result_id'] == spadlconfig.OWNGOAL) & (
        actions['type_id'] == spadlconfig.SHOT
    )
    actions.loc[owngoal, 'end_x'] = (
        spadlconfig.field_length - actions.loc[owngoal, 'end_x']
    )
    actions.loc[owngoal, 'end_y'] = (
        spadlconfig.field_width - actions.loc[owngoal, 'end_y']
    )
    actions.loc[owngoal, 'type_id'] = spadlconfig.actiontypes.index('bad_touch')
    return actions


# Deprecated pre-1.2 re-exports (reference ``spadl/opta.py:166-248``): the
# loader and raw-data schemas moved to :mod:`socceraction_tpu_torch.data.opta`
# but remain importable here with a DeprecationWarning.
from ._deprecated import deprecated_reexports as _deprecated_reexports

__getattr__ = _deprecated_reexports(
    __name__,
    'socceraction_tpu_torch.data.opta',
    (
        'OptaLoader',
        'OptaCompetitionSchema',
        'OptaGameSchema',
        'OptaPlayerSchema',
        'OptaTeamSchema',
        'OptaEventSchema',
    ),
)
