"""StatsBomb event stream → SPADL converter (columnar).

Parity: reference ``socceraction/spadl/statsbomb.py:12-322`` with the
upstream (``_sa``) post-processing semantics (see :mod:`.base`). Same
observable semantics, different engineering: the reference parses each
event's ragged ``extra`` JSON row-by-row through one Python parser function
per event type; here the scalar leaves the decisions depend on are dug out
of the dicts once (``_extract_scalars``) and every type/result/bodypart
decision is an ``np.select`` over columnar masks, first-match-wins
reproducing the reference's if/elif precedence — the same design as the
Wyscout converter (:mod:`.wyscout`).

Stages:

1. pull the decision-relevant scalar leaves out of ``extra`` (one host-side
   pass over the ragged dicts — the only non-columnar step)
2. period-relative clock + 120×80 yard-cell → 105×68 m rescale with y-flip
3. columnar type/result/bodypart decision tables
4. drop non-actions, sort, shared post-processing (direction of play,
   clearances, dribbles)

Port of ``socceraction_tpu/spadl/statsbomb.py``: the same code, with pandas imported inside the functions
that take or build frames, so the module imports where pandas is absent.
"""

from __future__ import annotations

from typing import TYPE_CHECKING, Any, Dict, Tuple

import numpy as np

from . import config as spadlconfig
from .base import _add_dribbles, _fix_clearances, _fix_direction_of_play
from .schema import SPADLSchema

if TYPE_CHECKING:  # pandas is imported inside the functions that take or build frames
    import pandas as pd

__all__ = ['convert_to_actions']

#: flat column name → path of keys into the ``extra`` dict
_EXTRA_SCALARS: Dict[str, Tuple[str, ...]] = {
    'pass_type': ('pass', 'type', 'name'),
    'pass_height': ('pass', 'height', 'name'),
    'pass_cross': ('pass', 'cross'),
    'pass_outcome': ('pass', 'outcome', 'name'),
    'pass_bodypart': ('pass', 'body_part', 'name'),
    'dribble_outcome': ('dribble', 'outcome', 'name'),
    'foul_card': ('foul_committed', 'card', 'name'),
    'duel_type': ('duel', 'type', 'name'),
    'duel_outcome': ('duel', 'outcome', 'name'),
    'interception_outcome': ('interception', 'outcome', 'name'),
    'shot_type': ('shot', 'type', 'name'),
    'shot_outcome': ('shot', 'outcome', 'name'),
    'shot_bodypart': ('shot', 'body_part', 'name'),
    'keeper_type': ('goalkeeper', 'type', 'name'),
    'keeper_outcome': ('goalkeeper', 'outcome', 'name'),
    'keeper_bodypart': ('goalkeeper', 'body_part', 'name'),
}

#: a duel/interception with one of these outcomes went to the opponent
_LOST = ('Lost In Play', 'Lost Out')


def _dig(d: Any, path: Tuple[str, ...]) -> Any:
    for key in path:
        if not isinstance(d, dict):
            return None
        d = d.get(key)
    return d


def _extract_scalars(extra: pd.Series) -> pd.DataFrame:
    """Flatten the ragged ``extra`` dicts into scalar decision columns."""
    import pandas as pd

    return pd.DataFrame(
        {
            name: [_dig(d, path) for d in extra]
            for name, path in _EXTRA_SCALARS.items()
        },
        index=extra.index,
        dtype=object,
    )


def _period_clock(events: pd.DataFrame) -> pd.Series:
    """Clock relative to the period start (regular period lengths assumed)."""
    offsets = np.select(
        [events['period_id'] == p for p in (2, 3, 4, 5)],
        [45 * 60, 90 * 60, 105 * 60, 120 * 60],
        default=0,
    )
    return 60 * events['minute'] + events['second'] - offsets


def _to_meters(coords: pd.Series) -> Tuple[pd.Series, pd.Series]:
    """(x, y) yard-cell pairs → meters on the 105×68 pitch, y flipped.

    StatsBomb's pitch is a 120×80 grid of 1-yard cells indexed from (1, 1);
    cell centers are rescaled onto the metric pitch.
    """
    import pandas as pd

    x = pd.Series([c[0] if c else 1 for c in coords], index=coords.index)
    y = pd.Series([c[1] if c else 1 for c in coords], index=coords.index)
    x_m = (x.clip(1, 120) - 1) / 119 * spadlconfig.field_length
    y_m = spadlconfig.field_width - (y.clip(1, 80) - 1) / 79 * spadlconfig.field_width
    return x_m, y_m


def _end_coordinates(events: pd.DataFrame) -> pd.Series:
    """End location: pass/shot/carry target if present, else the start."""
    import pandas as pd


    def end_of(start: Any, extra: Dict[str, Any]) -> Any:
        for family in ('pass', 'shot', 'carry'):
            leaf = extra.get(family)
            if isinstance(leaf, dict) and 'end_location' in leaf:
                return leaf['end_location']
        return start

    return pd.Series(
        [end_of(loc, x) for loc, x in zip(events['location'], events['extra'])],
        index=events.index,
        dtype=object,
    )


def _bodypart_ids(relevant: pd.Series) -> np.ndarray:
    """Map raw StatsBomb body-part names onto the 4-entry SPADL vocabulary."""
    import pandas as pd

    names = np.select(
        [
            relevant.isna(),
            relevant.str.contains('Head', na=False),
            relevant.str.contains('Foot', na=False) | (relevant == 'Drop Kick'),
        ],
        ['foot', 'head', 'foot'],
        default='other',
    )
    lookup = {name: i for i, name in enumerate(spadlconfig.bodyparts)}
    return pd.Series(names, index=relevant.index).map(lookup).to_numpy()


def _classify(
    events: pd.DataFrame,
) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Columnar (type_id, result_id, bodypart_id) decision tables."""
    import pandas as pd

    tn = events['type_name']
    x = _extract_scalars(events['extra'])

    is_pass = tn == 'Pass'
    is_shot = tn == 'Shot'
    is_keeper = tn == 'Goal Keeper'
    is_tackle = (tn == 'Duel') & (x['duel_type'] == 'Tackle')
    is_cross = np.array([bool(v) for v in x['pass_cross']])
    high_or_cross = (x['pass_height'] == 'High Pass') | is_cross
    card = x['foul_card'].fillna('').astype(str)

    type_names = np.select(
        [
            is_pass & (x['pass_type'] == 'Free Kick') & high_or_cross,
            is_pass & (x['pass_type'] == 'Free Kick'),
            is_pass & (x['pass_type'] == 'Corner') & high_or_cross,
            is_pass & (x['pass_type'] == 'Corner'),
            is_pass & (x['pass_type'] == 'Goal Kick'),
            is_pass & (x['pass_type'] == 'Throw-in'),
            is_pass & is_cross,
            is_pass,
            tn == 'Dribble',
            tn == 'Carry',
            tn == 'Foul Committed',
            is_tackle,
            tn == 'Interception',
            is_shot & (x['shot_type'] == 'Free Kick'),
            is_shot & (x['shot_type'] == 'Penalty'),
            is_shot,
            tn == 'Own Goal Against',
            is_keeper & (x['keeper_type'] == 'Shot Saved'),
            is_keeper & x['keeper_type'].isin(('Collected', 'Keeper Sweeper')),
            is_keeper & (x['keeper_type'] == 'Punch'),
            tn == 'Clearance',
            tn == 'Miscontrol',
        ],
        [
            'freekick_crossed',
            'freekick_short',
            'corner_crossed',
            'corner_short',
            'goalkick',
            'throw_in',
            'cross',
            'pass',
            'take_on',
            'dribble',
            'foul',
            'tackle',
            'interception',
            'shot_freekick',
            'shot_penalty',
            'shot',
            'bad_touch',
            'keeper_save',
            'keeper_claim',
            'keeper_punch',
            'clearance',
            'bad_touch',
        ],
        default='non_action',
    )

    result_names = np.select(
        [
            is_pass & x['pass_outcome'].isin(('Incomplete', 'Out')),
            is_pass & (x['pass_outcome'] == 'Pass Offside'),
            (tn == 'Dribble') & (x['dribble_outcome'] == 'Incomplete'),
            (tn == 'Foul Committed') & card.str.contains('Yellow'),
            (tn == 'Foul Committed') & card.str.contains('Red'),
            is_tackle & x['duel_outcome'].isin(_LOST),
            (tn == 'Interception') & x['interception_outcome'].isin(_LOST),
            is_shot & (x['shot_outcome'] != 'Goal'),
            tn == 'Own Goal Against',
            is_keeper & x['keeper_outcome'].isin(('In Play Danger', 'No Touch')),
            tn == 'Miscontrol',
        ],
        [
            'fail',
            'offside',
            'fail',
            'yellow_card',
            'red_card',
            'fail',
            'fail',
            'fail',
            'owngoal',
            'fail',
            'fail',
        ],
        default='success',
    )

    relevant_bodypart = pd.Series(
        np.select(
            [is_pass, is_shot, is_keeper],
            [x['pass_bodypart'], x['shot_bodypart'], x['keeper_bodypart']],
            default=None,
        ),
        index=events.index,
        dtype=object,
    )

    type_lookup = {name: i for i, name in enumerate(spadlconfig.actiontypes)}
    result_lookup = {name: i for i, name in enumerate(spadlconfig.results)}
    return (
        pd.Series(type_names, index=events.index).map(type_lookup).to_numpy(),
        pd.Series(result_names, index=events.index).map(result_lookup).to_numpy(),
        _bodypart_ids(relevant_bodypart),
    )


def convert_to_actions(events: pd.DataFrame, home_team_id: int) -> pd.DataFrame:
    """Convert StatsBomb events of one game to SPADL actions.

    Parameters
    ----------
    events : pd.DataFrame
        StatsBomb events of a single game (see
        :meth:`~socceraction_tpu_torch.data.statsbomb.StatsBombLoader.events`).
    home_team_id : int
        ID of the game's home team.

    Returns
    -------
    pd.DataFrame
        The game's actions in SPADL format.
    """
    import pandas as pd

    events = events.copy()
    events['extra'] = events['extra'].apply(lambda d: d if isinstance(d, dict) else {})
    events = events.fillna(0)

    start_x, start_y = _to_meters(events['location'])
    end_x, end_y = _to_meters(_end_coordinates(events))
    type_ids, result_ids, bodypart_ids = _classify(events)

    actions = pd.DataFrame(
        {
            'game_id': events['game_id'],
            'original_event_id': events['event_id'],
            'period_id': events['period_id'],
            'time_seconds': _period_clock(events),
            'team_id': events['team_id'],
            'player_id': events['player_id'],
            'start_x': start_x,
            'start_y': start_y,
            'end_x': end_x,
            'end_y': end_y,
            'type_id': type_ids,
            'result_id': result_ids,
            'bodypart_id': bodypart_ids,
        }
    )

    actions = (
        actions[actions['type_id'] != spadlconfig.NON_ACTION]
        .sort_values(['game_id', 'period_id', 'time_seconds'])
        .reset_index(drop=True)
    )
    actions = _fix_direction_of_play(actions, home_team_id)
    actions = _fix_clearances(actions)

    actions['action_id'] = range(len(actions))
    actions = _add_dribbles(actions)

    return SPADLSchema.validate(actions)


# Deprecated pre-1.2 re-exports (reference ``spadl/statsbomb.py:325-413``):
# the loader, ``extract_player_games`` and the raw-data schemas moved to
# :mod:`socceraction_tpu_torch.data.statsbomb` but remain importable here with a
# DeprecationWarning.
from ._deprecated import deprecated_reexports as _deprecated_reexports

__getattr__ = _deprecated_reexports(
    __name__,
    'socceraction_tpu_torch.data.statsbomb',
    (
        'StatsBombLoader',
        'extract_player_games',
        'StatsBombCompetitionSchema',
        'StatsBombGameSchema',
        'StatsBombPlayerSchema',
        'StatsBombTeamSchema',
        'StatsBombEventSchema',
    ),
)
