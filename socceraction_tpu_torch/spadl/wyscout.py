"""Wyscout (API v2) event stream → SPADL converter.

Parity: reference ``socceraction/spadl/wyscout.py:24-898`` (the infamous
"HERE BE DRAGONS" converter). Same observable semantics, different
engineering: the reference determines type/result/bodypart with row-wise
``DataFrame.apply`` over an if/elif chain; here every per-event decision is
an ``np.select`` over columnar masks (first-match-wins reproduces the
if/elif precedence exactly), so the whole conversion is vectorized
host-side before the frame crosses into the packed tensor pipeline.

Pipeline stages:

1. tag list → boolean tag columns (``get_tagsdf``)
2. positions list → raw start/end coordinates (``make_new_positions``)
3. event surgery on the raw (0-100)² Wyscout pitch: shot end-coordinate
   estimation from goal-zone tags, duel rewriting, interception-pass
   splitting, offside attachment, touch & simulation rewriting
4. columnar type/result/bodypart determination, non-action removal
5. coordinate rescale to 105×68 m (y flipped) + goalkick/foul/keeper-save
   repairs
6. shared post-processing (direction of play, clearances, dribbles)

Every stage is exported under the reference's public name (``get_tagsdf``,
``fix_wyscout_events``, ``create_df_actions``, ``fix_actions``, …,
reference ``spadl/wyscout.py:58-898``) so pipelines written against the
reference keep working; the per-row ``determine_*`` functions are thin
wrappers over the columnar decision tables. The deprecated loader/schema
re-exports (reference ``spadl/wyscout.py:901-991``) are served lazily via
module ``__getattr__`` with the same :class:`DeprecationWarning`.

Port of ``socceraction_tpu/spadl/wyscout.py``: the same code, with pandas imported inside the functions
that take or build frames, so the module imports where pandas is absent.
"""

from __future__ import annotations

from typing import TYPE_CHECKING, Any, Dict, List, Set, Tuple

import numpy as np

from . import config as spadlconfig
from .base import (
    _add_dribbles,
    _fix_clearances,
    _fix_direction_of_play,
    _single_event,
    min_dribble_length,
)
from .schema import SPADLSchema

if TYPE_CHECKING:  # pandas is imported inside the functions that take or build frames
    import pandas as pd

__all__ = [
    'convert_to_actions',
    'get_tagsdf',
    'make_new_positions',
    'fix_wyscout_events',
    'create_shot_coordinates',
    'convert_duels',
    'insert_interception_passes',
    'add_offside_variable',
    'convert_touches',
    'convert_simulations',
    'create_df_actions',
    'determine_bodypart_id',
    'determine_type_id',
    'determine_result_id',
    'remove_non_actions',
    'fix_actions',
    'fix_goalkick_coordinates',
    'adjust_goalkick_result',
    'fix_foul_coordinates',
    'fix_keeper_save_coordinates',
    'remove_keeper_goal_actions',
]

# Deprecated pre-1.2 re-exports (reference ``spadl/wyscout.py:901-991``):
# the loaders and raw-data schemas moved to
# :mod:`socceraction_tpu_torch.data.wyscout` but remain importable here with a
# DeprecationWarning.
from ._deprecated import deprecated_reexports as _deprecated_reexports

__getattr__ = _deprecated_reexports(
    __name__,
    'socceraction_tpu_torch.data.wyscout',
    (
        'WyscoutLoader',
        'PublicWyscoutLoader',
        'WyscoutCompetitionSchema',
        'WyscoutGameSchema',
        'WyscoutPlayerSchema',
        'WyscoutTeamSchema',
        'WyscoutEventSchema',
    ),
)

#: Wyscout tag id → boolean column name (reference ``spadl/wyscout.py:78-138``).
WYSCOUT_TAGS: Dict[int, str] = {
    101: 'goal',
    102: 'own_goal',
    301: 'assist',
    302: 'key_pass',
    1901: 'counter_attack',
    401: 'left_foot',
    402: 'right_foot',
    403: 'head/body',
    1101: 'direct',
    1102: 'indirect',
    2001: 'dangerous_ball_lost',
    2101: 'blocked',
    801: 'high',
    802: 'low',
    1401: 'interception',
    1501: 'clearance',
    201: 'opportunity',
    1301: 'feint',
    1302: 'missed_ball',
    501: 'free_space_right',
    502: 'free_space_left',
    503: 'take_on_left',
    504: 'take_on_right',
    1601: 'sliding_tackle',
    601: 'anticipated',
    602: 'anticipation',
    1701: 'red_card',
    1702: 'yellow_card',
    1703: 'second_yellow_card',
    1201: 'position_goal_low_center',
    1202: 'position_goal_low_right',
    1203: 'position_goal_mid_center',
    1204: 'position_goal_mid_left',
    1205: 'position_goal_low_left',
    1206: 'position_goal_mid_right',
    1207: 'position_goal_high_center',
    1208: 'position_goal_high_left',
    1209: 'position_goal_high_right',
    1210: 'position_out_low_right',
    1211: 'position_out_mid_left',
    1212: 'position_out_low_left',
    1213: 'position_out_mid_right',
    1214: 'position_out_high_center',
    1215: 'position_out_high_left',
    1216: 'position_out_high_right',
    1217: 'position_post_low_right',
    1218: 'position_post_mid_left',
    1219: 'position_post_low_left',
    1220: 'position_post_mid_right',
    1221: 'position_post_high_center',
    1222: 'position_post_high_left',
    1223: 'position_post_high_right',
    901: 'through',
    1001: 'fairplay',
    701: 'lost',
    702: 'neutral',
    703: 'won',
    1801: 'accurate',
    1802: 'not_accurate',
}

_TAG_COLUMNS = list(WYSCOUT_TAGS.values())


def convert_to_actions(events: pd.DataFrame, home_team_id: int) -> pd.DataFrame:
    """Convert Wyscout events of one game to SPADL actions.

    Parameters
    ----------
    events : pd.DataFrame
        Wyscout events of a single game (see
        :meth:`~socceraction_tpu_torch.data.wyscout.PublicWyscoutLoader.events`).
    home_team_id : int
        ID of the game's home team.

    Returns
    -------
    pd.DataFrame
        The game's actions in SPADL format.
    """
    import pandas as pd

    events = pd.concat([events.reset_index(drop=True), get_tagsdf(events)], axis=1)
    events = make_new_positions(events)
    events = fix_wyscout_events(events)
    actions = create_df_actions(events)
    actions = fix_actions(actions)
    actions = _fix_direction_of_play(actions, home_team_id)
    actions = _fix_clearances(actions)
    actions['action_id'] = range(len(actions))
    actions = _add_dribbles(actions)
    return SPADLSchema.validate(actions)


def get_tagsdf(events: pd.DataFrame) -> pd.DataFrame:
    """Expand each event's tag list into one boolean column per known tag."""
    import pandas as pd

    tag_sets: List[Set[int]] = [
        {t['id'] for t in tags} for tags in events['tags']
    ]
    data = {
        column: np.fromiter(
            (tag_id in s for s in tag_sets), dtype=bool, count=len(tag_sets)
        )
        for tag_id, column in WYSCOUT_TAGS.items()
    }
    return pd.DataFrame(data, index=range(len(tag_sets)))


def make_new_positions(events: pd.DataFrame) -> pd.DataFrame:
    """Extract start/end coordinates from each event's ``positions`` list.

    Two entries give start and end; a single entry is both; an empty list
    yields missing coordinates (the event is dropped later).
    """
    n = len(events)
    coords = np.full((n, 4), np.nan)
    for i, positions in enumerate(events['positions']):
        if len(positions) >= 2:
            coords[i] = (
                positions[0]['x'],
                positions[0]['y'],
                positions[1]['x'],
                positions[1]['y'],
            )
        elif len(positions) == 1:
            x, y = positions[0]['x'], positions[0]['y']
            coords[i] = (x, y, x, y)
    events = events.drop(columns=['positions'])
    events[['start_x', 'start_y', 'end_x', 'end_y']] = coords
    return events


# Goal-zone tag groups → estimated shot end coordinates on the raw
# (0-100)² Wyscout pitch (reference ``spadl/wyscout.py:206-283``); the goal
# mouth is at x=100, y≈45-55 from the shooter's perspective.
_SHOT_END_ESTIMATES: List[Tuple[List[str], float, float]] = [
    (['position_goal_low_center', 'position_goal_mid_center', 'position_goal_high_center'], 100.0, 50.0),
    (['position_goal_low_right', 'position_goal_mid_right', 'position_goal_high_right'], 100.0, 55.0),
    (['position_goal_mid_left', 'position_goal_low_left', 'position_goal_high_left'], 100.0, 45.0),
    (['position_out_high_center', 'position_post_high_center'], 100.0, 50.0),
    (['position_out_low_right', 'position_out_mid_right', 'position_out_high_right'], 100.0, 60.0),
    (['position_out_mid_left', 'position_out_low_left', 'position_out_high_left'], 100.0, 40.0),
    (['position_post_mid_left', 'position_post_low_left', 'position_post_high_left'], 100.0, 55.38),
    (['position_post_low_right', 'position_post_mid_right', 'position_post_high_right'], 100.0, 44.62),
]


def fix_wyscout_events(df_events: pd.DataFrame) -> pd.DataFrame:
    """Event surgery on the raw (0-100)² Wyscout pitch.

    Chains the six rewriting stages in the reference's order
    (``spadl/wyscout.py:184-206``): shot end-coordinate estimation, duel
    rewriting, interception-pass splitting, offside attachment, touch and
    simulation rewriting.
    """
    df_events = create_shot_coordinates(df_events)
    df_events = convert_duels(df_events)
    df_events = insert_interception_passes(df_events)
    df_events = add_offside_variable(df_events)
    df_events = convert_touches(df_events)
    df_events = convert_simulations(df_events)
    return df_events


def create_shot_coordinates(events: pd.DataFrame) -> pd.DataFrame:
    """Estimate shot end coordinates from the goal-zone tags."""
    for columns, end_x, end_y in _SHOT_END_ESTIMATES:
        mask = np.logical_or.reduce([events[c].to_numpy() for c in columns])
        events.loc[mask, 'end_x'] = end_x
        events.loc[mask, 'end_y'] = end_y
    blocked = events['blocked'].to_numpy()
    events.loc[blocked, 'end_x'] = events.loc[blocked, 'start_x']
    events.loc[blocked, 'end_y'] = events.loc[blocked, 'start_y']
    return events


def convert_duels(events: pd.DataFrame) -> pd.DataFrame:
    """Rewrite duel events (type 1).

    A pair of duel rows followed by a ball-out-of-field row (subtype 50) in
    the same period becomes a pass by the duel winner to the (mirrored)
    out-of-field location. Attacking-duel take-ons and sliding tackles are
    kept (retyped on their tags later); all other duels are dropped.
    """
    nxt = events.shift(-1)
    nxt2 = events.shift(-2)

    out_after_duels = (
        (events['type_id'] == 1)
        & (nxt['type_id'] == 1)
        & (nxt2['subtype_id'] == 50)
        & (events['period_id'] == nxt2['period_id'])
    )
    # The winner is whichever of the two duelists is NOT the team that
    # conceded the throw-in/goal-kick (i.e. differs from the out event row).
    won_here = out_after_duels & (events['team_id'] != nxt2['team_id'])
    won_next = out_after_duels & (nxt['team_id'] != nxt2['team_id'])
    won = won_here | won_next
    won_air = (won_here & (events['subtype_id'] == 10)) | (
        won_next & (nxt['subtype_id'] == 10)
    )

    events.loc[won, 'type_id'] = 8
    events.loc[won_air, 'subtype_id'] = 82
    events.loc[won & ~won_air, 'subtype_id'] = 85
    events.loc[won, 'accurate'] = False
    events.loc[won, 'not_accurate'] = True
    events.loc[won, 'end_x'] = 100 - nxt2.loc[won, 'start_x']
    events.loc[won, 'end_y'] = 100 - nxt2.loc[won, 'start_y']

    take_on = (events['subtype_id'] == 11) & (
        events['take_on_left'] | events['take_on_right']
    )
    events.loc[take_on, 'type_id'] = 0
    events.loc[events['sliding_tackle'], 'type_id'] = 0

    return events[events['type_id'] != 1].reset_index(drop=True)


def insert_interception_passes(events: pd.DataFrame) -> pd.DataFrame:
    """Split a pass that is also tagged as an interception into two events.

    The interception copy keeps only the interception tag, gets type 0 /
    subtype 0 and a zero-length trajectory, and sorts in front of the pass.
    """
    import pandas as pd

    is_both = events['interception'] & (events['type_id'] == 8)
    if not is_both.any():
        return events
    intercepts = events[is_both].copy()
    intercepts[_TAG_COLUMNS] = False
    intercepts['interception'] = True
    intercepts['type_id'] = 0
    intercepts['subtype_id'] = 0
    intercepts[['end_x', 'end_y']] = intercepts[['start_x', 'start_y']].to_numpy()
    merged = pd.concat([intercepts, events], ignore_index=True)
    return merged.sort_values(
        ['period_id', 'milliseconds'], kind='stable'
    ).reset_index(drop=True)


def add_offside_variable(events: pd.DataFrame) -> pd.DataFrame:
    """Fold offside events (type 6) into the preceding pass as a flag."""
    events['offside'] = 0
    nxt = events.shift(-1)
    pass_before_offside = (nxt['type_id'] == 6) & (events['type_id'] == 8)
    events.loc[pass_before_offside, 'offside'] = 1
    return events[events['type_id'] != 6].reset_index(drop=True)


def convert_touches(events: pd.DataFrame) -> pd.DataFrame:
    """Turn touches that directly reach another player into passes.

    A touch (subtype 72, not an interception) whose end location coincides
    with the next event's start location becomes a pass — accurate when the
    receiver is a teammate, inaccurate otherwise.
    """
    nxt = events.shift(-1)
    touch = (events['subtype_id'] == 72) & ~events['interception']
    other_player = events['player_id'] != nxt['player_id']
    same_team = events['team_id'] == nxt['team_id']
    near = (
        ((events['end_x'] - nxt['start_x']).abs() < min_dribble_length)
        & ((events['end_y'] - nxt['start_y']).abs() < min_dribble_length)
    )
    to_teammate = touch & other_player & same_team & near
    to_opponent = touch & other_player & ~same_team & near
    for mask, ok in ((to_teammate, True), (to_opponent, False)):
        events.loc[mask, 'type_id'] = 8
        events.loc[mask, 'subtype_id'] = 85
        events.loc[mask, 'accurate'] = ok
        events.loc[mask, 'not_accurate'] = not ok
    return events


def convert_simulations(events: pd.DataFrame) -> pd.DataFrame:
    """Rewrite simulation events (subtype 25).

    A simulation directly after a failed take-on is dropped (the take-on
    already captures the failed attempt); any other simulation becomes a
    failed take-on itself.

    .. note:: the "preceded by failed take-on" test reproduces the
       reference's operator precedence (``spadl/wyscout.py:469-471``):
       ``take_on_left | (take_on_right & not_accurate)``.
    """
    prev = events.shift(1)
    simulation = events['subtype_id'] == 25
    after_failed_take_on = prev['take_on_left'] | (
        prev['take_on_right'] & prev['not_accurate']
    )
    to_take_on = simulation & ~after_failed_take_on
    events.loc[to_take_on, 'type_id'] = 0
    events.loc[to_take_on, 'subtype_id'] = 0
    events.loc[to_take_on, 'accurate'] = False
    events.loc[to_take_on, 'not_accurate'] = True
    events.loc[to_take_on, 'take_on_left'] = True
    return events[~(simulation & after_failed_take_on)].reset_index(drop=True)


def _first_match(
    conditions: List[Any], choices: List[int], default: int
) -> np.ndarray:
    """``np.select`` with if/elif precedence (first matching row wins)."""
    return np.select([np.asarray(c, dtype=bool) for c in conditions], choices, default)


def _bodypart_ids(events: pd.DataFrame) -> np.ndarray:
    """Columnar bodypart decision table (reference ``spadl/wyscout.py:579``)."""
    bp = spadlconfig.bodyparts.index
    type_id = events['type_id']
    subtype_id = events['subtype_id']
    return _first_match(
        [
            subtype_id.isin([81, 36, 21, 90, 91]),
            subtype_id == 82,
            (type_id == 10) & events['head/body'],
        ],
        [bp('other'), bp('head'), bp('head/other')],
        default=bp('foot'),
    )


def _type_ids(events: pd.DataFrame) -> np.ndarray:
    """Columnar action-type decision table (reference ``spadl/wyscout.py:603``)."""
    at = spadlconfig.actiontypes.index
    type_id = events['type_id']
    subtype_id = events['subtype_id']
    return _first_match(
        [
            events['own_goal'],
            (type_id == 8) & (subtype_id == 80),
            type_id == 8,
            subtype_id == 36,
            (subtype_id == 30) & events['high'],
            subtype_id == 30,
            subtype_id == 32,
            subtype_id == 31,
            subtype_id == 34,
            (type_id == 2) & ~subtype_id.isin([22, 23, 24, 26]),
            type_id == 10,
            subtype_id == 35,
            subtype_id == 33,
            type_id == 9,
            subtype_id == 71,
            (subtype_id == 72) & events['not_accurate'],
            subtype_id == 70,
            events['take_on_left'] | events['take_on_right'],
            events['sliding_tackle'],
            events['interception'] & subtype_id.isin([0, 10, 11, 12, 13, 72]),
        ],
        [
            at('bad_touch'),
            at('cross'),
            at('pass'),
            at('throw_in'),
            at('corner_crossed'),
            at('corner_short'),
            at('freekick_crossed'),
            at('freekick_short'),
            at('goalkick'),
            at('foul'),
            at('shot'),
            at('shot_penalty'),
            at('shot_freekick'),
            at('keeper_save'),
            at('clearance'),
            at('bad_touch'),
            at('dribble'),
            at('take_on'),
            at('tackle'),
            at('interception'),
        ],
        default=at('non_action'),
    )


def _result_ids(events: pd.DataFrame) -> np.ndarray:
    """Columnar result decision table (reference ``spadl/wyscout.py:666``)."""
    type_id = events['type_id']
    subtype_id = events['subtype_id']
    return _first_match(
        [
            events['offside'] == 1,
            type_id == 2,
            events['goal'],
            events['own_goal'],
            subtype_id.isin([100, 33, 35]),
            events['accurate'],
            events['not_accurate'],
            events['interception'] | events['clearance'] | (subtype_id == 71),
            type_id == 9,
        ],
        [
            spadlconfig.OFFSIDE,
            spadlconfig.SUCCESS,
            spadlconfig.SUCCESS,
            spadlconfig.OWNGOAL,
            spadlconfig.FAIL,
            spadlconfig.SUCCESS,
            spadlconfig.FAIL,
            spadlconfig.SUCCESS,
            spadlconfig.SUCCESS,
        ],
        default=spadlconfig.SUCCESS,
    )


def determine_bodypart_id(event: Any) -> int:
    """Bodypart id of one Wyscout event (row-wise reference API)."""
    return int(_bodypart_ids(_single_event(event))[0])


def determine_type_id(event: Any) -> int:
    """SPADL action-type id of one Wyscout event (row-wise reference API)."""
    return int(_type_ids(_single_event(event))[0])


def determine_result_id(event: Any) -> int:
    """SPADL result id of one Wyscout event (row-wise reference API)."""
    return int(_result_ids(_single_event(event))[0])


def create_df_actions(df_events: pd.DataFrame) -> pd.DataFrame:
    """Build the raw SPADL action frame and drop non-actions.

    Type/result/bodypart come from the columnar decision tables; like the
    reference (``spadl/wyscout.py:542-576``) the remaining non-actions are
    removed before returning.
    """
    import pandas as pd

    df_actions = pd.DataFrame(
        {
            'game_id': df_events['game_id'],
            'original_event_id': df_events['event_id'].astype(object),
            'period_id': df_events['period_id'],
            'time_seconds': df_events['milliseconds'] / 1000,
            'team_id': df_events['team_id'],
            'player_id': df_events['player_id'],
            'start_x': df_events['start_x'],
            'start_y': df_events['start_y'],
            'end_x': df_events['end_x'],
            'end_y': df_events['end_y'],
            'bodypart_id': _bodypart_ids(df_events),
            'type_id': _type_ids(df_events),
            'result_id': _result_ids(df_events),
        }
    )
    return remove_non_actions(df_actions)


def remove_non_actions(df_actions: pd.DataFrame) -> pd.DataFrame:
    """Drop rows typed ``non_action``."""
    keep = df_actions['type_id'] != spadlconfig.NON_ACTION
    return df_actions[keep].reset_index(drop=True)


def fix_actions(df_actions: pd.DataFrame) -> pd.DataFrame:
    """Rescale (0-100)² coordinates to 105×68 m and repair special cases.

    Same repair chain and order as the reference
    (``spadl/wyscout.py:722-760``): goalkick coordinates, goalkick results,
    foul coordinates, keeper-save coordinates, post-goal keeper-save
    removal.
    """
    length, width = spadlconfig.field_length, spadlconfig.field_width
    for c in ('start_x', 'end_x'):
        df_actions[c] = (df_actions[c] * length / 100).clip(0, length)
    for c in ('start_y', 'end_y'):
        # Wyscout's y axis runs top-to-bottom.
        df_actions[c] = ((100 - df_actions[c]) * width / 100).clip(0, width)
    df_actions = fix_goalkick_coordinates(df_actions)
    df_actions = adjust_goalkick_result(df_actions)
    df_actions = fix_foul_coordinates(df_actions)
    df_actions = fix_keeper_save_coordinates(df_actions)
    df_actions = remove_keeper_goal_actions(df_actions)
    return df_actions.reset_index(drop=True)


def fix_goalkick_coordinates(df_actions: pd.DataFrame) -> pd.DataFrame:
    """Goalkicks start from a fixed point in front of goal."""
    goalkick = df_actions['type_id'] == spadlconfig.actiontypes.index('goalkick')
    df_actions.loc[goalkick, 'start_x'] = 5.0
    df_actions.loc[goalkick, 'start_y'] = 34.0
    return df_actions


def adjust_goalkick_result(df_actions: pd.DataFrame) -> pd.DataFrame:
    """Goalkick result: retained possession = success."""
    goalkick = df_actions['type_id'] == spadlconfig.actiontypes.index('goalkick')
    nxt = df_actions.shift(-1)
    keeps_ball = df_actions['team_id'] == nxt['team_id']
    df_actions.loc[goalkick & keeps_ball, 'result_id'] = spadlconfig.SUCCESS
    df_actions.loc[goalkick & ~keeps_ball, 'result_id'] = spadlconfig.FAIL
    return df_actions


def fix_foul_coordinates(df_actions: pd.DataFrame) -> pd.DataFrame:
    """Fouls happen in place: end coordinates equal start coordinates."""
    foul = df_actions['type_id'] == spadlconfig.actiontypes.index('foul')
    df_actions.loc[foul, 'end_x'] = df_actions.loc[foul, 'start_x']
    df_actions.loc[foul, 'end_y'] = df_actions.loc[foul, 'start_y']
    return df_actions


def fix_keeper_save_coordinates(df_actions: pd.DataFrame) -> pd.DataFrame:
    """Mirror keeper-save coordinates to the keeper's own goal.

    Coordinates are recorded from the shooter's perspective; mirror them
    and collapse the save to a point.
    """
    length, width = spadlconfig.field_length, spadlconfig.field_width
    save = df_actions['type_id'] == spadlconfig.actiontypes.index('keeper_save')
    df_actions.loc[save, 'end_x'] = length - df_actions.loc[save, 'end_x']
    df_actions.loc[save, 'end_y'] = width - df_actions.loc[save, 'end_y']
    df_actions.loc[save, 'start_x'] = df_actions.loc[save, 'end_x']
    df_actions.loc[save, 'start_y'] = df_actions.loc[save, 'end_y']
    return df_actions


def remove_keeper_goal_actions(df_actions: pd.DataFrame) -> pd.DataFrame:
    """Drop the keeper's pick-up directly after a conceded goal."""
    at = spadlconfig.actiontypes.index
    save = df_actions['type_id'] == at('keeper_save')
    prev = df_actions.shift(1)
    same_phase = prev['time_seconds'] + 10 > df_actions['time_seconds']
    prev_goal = prev['type_id'].isin(
        [at('shot'), at('shot_penalty'), at('shot_freekick')]
    ) & (prev['result_id'] == spadlconfig.SUCCESS)
    drop = same_phase & prev_goal & save
    return df_actions[~drop.fillna(False)].reset_index(drop=True)
