"""Wyscout (API v3) event stream → SPADL converter.

Parity: reference ``socceraction/spadl/wyscout_v3.py`` — a work-in-progress
fork-only converter for the flat-column Wyscout v3 feed. The reference file
is a spec sketch, not working code (its ``convert_to_actions`` returns the
*events* frame, reference ``spadl/wyscout_v3.py:54``; dribble synthesis and
schema validation are commented out, ``:52-55``; ``determine_type_id``
returns string names instead of ids, ``:832-833``). This module implements
the *intended* pipeline to completion, vectorized (``np.select`` over
columnar masks instead of row-wise ``DataFrame.apply``), producing a valid
SPADL frame like every other provider converter:

1. start/end coordinate extraction per event family
   (reference ``:76-103``), shot end-coordinate estimation from
   ``shot_goal_zone`` (``:155-203``)
2. event surgery on the raw (0-100)² Wyscout pitch: duel →
   dribble/take_on rewriting with duel-outcome flags (``:226-304``),
   interception (``:387-412``) and fairplay (``:414-447``) coordinates,
   offside attachment (``:513-544``), touch (``:590-658``) and
   acceleration (``:661-723``) success inference, end-coordinate
   backfill for remaining move actions (``:449-475``)
3. columnar type/result/bodypart determination (``:749-881``) mapped onto
   the SPADL id spaces (the WIP leaves v3 strings like ``acceleration``
   and ``goal_kick`` that are not SPADL vocabulary; here they map to
   ``dribble``/``goalkick``)
4. coordinate rescale to 105×68 m with y flip (``:901-937``),
   keeper-save inversion (``:979-1004``), foul end-coordinate repair
   (``:960-976``, defined but never wired up in the WIP — required for a
   schema-valid frame)
5. shared post-processing: direction of play, clearances, action ids,
   dribble synthesis, schema validation (upstream ``_sa`` semantics)

The xA enrichment (``:206-223``) never lands in the SPADL frame itself:
:func:`fix_wyscout_events` attaches it to the *events* when the feed
carries ``shot_xg`` (reference behavior) and skips it otherwise, and
:func:`add_expected_assists` stays callable on its own.

Port of ``socceraction_tpu/spadl/wyscout_v3.py``: the same code, with pandas imported inside the functions
that take or build frames, so the module imports where pandas is absent.
"""

from __future__ import annotations

from typing import TYPE_CHECKING, Any, Optional

import numpy as np

from . import config as spadlconfig
from .base import (
    _add_dribbles,
    _fix_clearances,
    _fix_direction_of_play,
    _single_event,
)
from .schema import SPADLSchema

# Keeper-save mirroring is identical across feed versions; the v2 module
# owns the implementation and this module re-exports it.
from .wyscout import fix_keeper_save_coordinates  # noqa: F401

if TYPE_CHECKING:  # pandas is imported inside the functions that take or build frames
    import pandas as pd

__all__ = [
    'convert_to_actions',
    'add_expected_assists',
    'make_new_positions',
    'fix_wyscout_events',
    'create_shot_coordinates',
    'convert_duels',
    'insert_interception_coordinates',
    'insert_fairplay_coordinates',
    'insert_coordinates_edge_cases',
    'add_offside_variable',
    'convert_touches',
    'convert_accelerations',
    'create_df_actions',
    'determine_bodypart_id',
    'determine_type_id',
    'determine_result_id',
    'fix_actions',
    'fix_foul_coordinates',
    'fix_keeper_save_coordinates',
]

#: matchPeriod string → SPADL period id.
_PERIODS = {'1H': 1, '2H': 2, 'E1': 3, 'E2': 4, 'P': 5}

#: shot_goal_zone → estimated (end_x, end_y) on the (0-100)² Wyscout pitch
#: (reference spadl/wyscout_v3.py:166-196).
_GOAL_ZONE_COORDS = {
    **dict.fromkeys(['gt', 'gc', 'gb'], (100.0, 50.0)),
    **dict.fromkeys(['gtr', 'gr', 'gbr'], (100.0, 55.0)),
    **dict.fromkeys(['gtl', 'gl', 'glb'], (100.0, 45.0)),
    **dict.fromkeys(['ot', 'pt'], (100.0, 50.0)),
    **dict.fromkeys(['otr', 'or', 'obr'], (100.0, 60.0)),
    **dict.fromkeys(['otl', 'ol', 'olb'], (100.0, 40.0)),
    **dict.fromkeys(['ptl', 'pl', 'plb'], (100.0, 55.38)),
    **dict.fromkeys(['ptr', 'pr', 'pbr'], (100.0, 44.62)),
}

#: v3 primaries whose pass_end_location is the action's end point
#: (reference spadl/wyscout_v3.py:80-82).
_PASS_LIKE_PRIMARIES = [
    'pass', 'clearance', 'throw_in', 'interception', 'goal_kick',
    'free_kick', 'corner', 'fairplay',
]

#: v3 primaries that may carry the ball (reference :87).
_CARRY_PRIMARIES = ['touch', 'duel', 'acceleration', 'goalkeeper_exit']

#: "possession continues" next-event primaries for touch/acceleration
#: success inference (reference :609-613).
_KEEP_PRIMARIES = [
    'pass', 'shot', 'acceleration', 'clearance', 'touch', 'interception',
]
#: "possession lost / play stops" next-event primaries (reference :614-617).
#: Note 'offside' is unreachable here — offside rows are dropped by
#: ``add_offside_variable`` before touch/acceleration inference runs, exactly
#: like the reference surgery order (``:144-146``); kept for parity.
_LOSE_PRIMARIES = ['game_interruption', 'infraction', 'offside', 'shot_against']


def _col(events: pd.DataFrame, name: str, default: Any = 0) -> pd.Series:
    """Column accessor tolerant of feeds that omit optional v3 columns."""
    import pandas as pd

    if name in events.columns:
        col = events[name]
        if default == 0 or default is False:
            return col.fillna(default).infer_objects()
        return col
    return pd.Series([default] * len(events), index=events.index)


def _str_col(events: pd.DataFrame, name: str) -> pd.Series:
    return _col(events, name, default='').astype(str).replace('nan', '')


def convert_to_actions(
    events: pd.DataFrame, home_team_id: Optional[int] = None
) -> pd.DataFrame:
    """Convert Wyscout v3 events of one game to SPADL actions.

    Parameters
    ----------
    events : pd.DataFrame
        Flat-column Wyscout v3 events of a single game (camelCase feed
        fields flattened to snake_case with ``_`` separators, e.g.
        ``pass.endLocation.x`` → ``pass_end_location_x``).
    home_team_id : int, optional
        ID of the game's home team. May be omitted when the frame carries a
        ``home_team_id`` column (the v3 feed convention).

    Returns
    -------
    pd.DataFrame
        The game's actions in SPADL format.
    """
    if home_team_id is None:
        if 'home_team_id' not in events.columns:
            raise ValueError(
                'home_team_id must be given (argument or events column)'
            )
        home_team_id = events['home_team_id'].iloc[0]
    events = events.reset_index(drop=True).copy()
    events = make_new_positions(events)
    events = fix_wyscout_events(events)
    actions = create_df_actions(events)
    actions = fix_actions(actions)
    actions = _fix_direction_of_play(actions, home_team_id)
    actions = _fix_clearances(actions)
    actions['action_id'] = range(len(actions))
    actions = _add_dribbles(actions)
    return SPADLSchema.validate(actions)


def fix_wyscout_events(df_events: pd.DataFrame) -> pd.DataFrame:
    """Event surgery on the raw (0-100)² Wyscout-v3 pitch.

    Chains the rewriting stages in the reference's order
    (``spadl/wyscout_v3.py:128-153``). :func:`add_expected_assists`
    requires a ``shot_xg`` feed column that not every v3 export carries,
    so it runs conditionally: feeds that carry the column get the
    reference behavior (the xA column on the returned events), feeds
    that don't simply skip the stage instead of erroring.
    """
    df_events = create_shot_coordinates(df_events)
    if 'shot_xg' in df_events.columns:
        df_events = add_expected_assists(df_events)
    df_events = convert_duels(df_events)
    df_events = insert_interception_coordinates(df_events)
    df_events = add_offside_variable(df_events)
    df_events = convert_touches(df_events)
    df_events = convert_accelerations(df_events)
    df_events = insert_fairplay_coordinates(df_events)
    df_events = insert_coordinates_edge_cases(df_events)
    return df_events


def add_expected_assists(events: pd.DataFrame) -> pd.DataFrame:
    """Attach xA to shot assists: the assisted shot's xG.

    Reference ``spadl/wyscout_v3.py:206-223``. Returns the events frame
    with a ``metric_xa`` column (NaN for non-assists).
    """
    events = events.copy()
    nxt = events.shift(-1)
    is_assist = _col(events, 'type_shot_assist') == 1
    events.loc[is_assist, 'metric_xa'] = nxt['shot_xg']
    return events


# ---------------------------------------------------------------------------
# coordinate extraction + event surgery (raw 0-100 pitch)
# ---------------------------------------------------------------------------


def make_new_positions(events: pd.DataFrame) -> pd.DataFrame:
    """Select start/end coordinates per event family (reference :76-103).

    Blocked passes end where they start; pass-like events end at
    ``pass_end_location``; carries end at ``carry_end_location``; everything
    else has no end point yet.
    """
    loc_x = _col(events, 'location_x', np.nan).astype(float)
    loc_y = _col(events, 'location_y', np.nan).astype(float)
    primary = _str_col(events, 'type_primary')
    blocked = _str_col(events, 'pass_height') == 'blocked'
    pass_like = primary.isin(_PASS_LIKE_PRIMARIES)
    carry = primary.isin(_CARRY_PRIMARIES) & (_col(events, 'type_carry') == 1)

    events['start_x'] = loc_x
    events['start_y'] = loc_y
    events['end_x'] = np.select(
        [blocked, pass_like, carry],
        [
            loc_x,
            _col(events, 'pass_end_location_x', np.nan).astype(float),
            _col(events, 'carry_end_location_x', np.nan).astype(float),
        ],
        default=np.nan,
    )
    events['end_y'] = np.select(
        [blocked, pass_like, carry],
        [
            loc_y,
            _col(events, 'pass_end_location_y', np.nan).astype(float),
            _col(events, 'carry_end_location_y', np.nan).astype(float),
        ],
        default=np.nan,
    )
    return events


def create_shot_coordinates(events: pd.DataFrame) -> pd.DataFrame:
    """Estimate shot end points from the goal-zone code (reference :155-203)."""
    zone = _str_col(events, 'shot_goal_zone')
    known = zone.map(lambda z: _GOAL_ZONE_COORDS.get(z))
    has = known.notna()
    events.loc[has, 'end_x'] = [c[0] for c in known[has]]
    events.loc[has, 'end_y'] = [c[1] for c in known[has]]
    blocked = zone == 'bc'
    events.loc[blocked, 'end_x'] = events.loc[blocked, 'start_x']
    events.loc[blocked, 'end_y'] = events.loc[blocked, 'start_y']
    return events


def convert_duels(events: pd.DataFrame) -> pd.DataFrame:
    """Duels → dribble/take_on with outcome flags (reference :226-304).

    A ground duel of duel-type ``dribble`` becomes a dribbling action
    (``take_on`` when the take-on flag is set). The duel outcome is won when
    any possession/progress flag is set. End coordinates come from the next
    event — or the one after it when the next event is the duel's paired
    opposite-side record — mirrored when that event belongs to the other
    team.
    """
    nxt_id = events['id'].shift(-1)
    nxt_team = events['team_id'].shift(-1)
    nxt2_team = events['team_id'].shift(-2)
    primary = _str_col(events, 'type_primary')
    is_duel = primary == 'duel'
    is_dribble = _str_col(events, 'ground_duel_duel_type') == 'dribble'
    is_take_on = (_col(events, 'ground_duel_take_on') == 1.0) & is_dribble
    related_next = (
        _col(events, 'ground_duel_related_duel_id', np.nan) == nxt_id
    ) | (_col(events, 'aerial_duel_related_duel_id', np.nan) == nxt_id)
    same_team_1 = events['team_id'] == nxt_team
    same_team_2 = events['team_id'] == nxt2_team
    is_carry = _col(events, 'type_carry') == 1

    won = (
        (_col(events, 'ground_duel_kept_possession') == 1.0)
        | (_col(events, 'ground_duel_recovered_possession') == 1.0)
        | (_col(events, 'aerial_duel_first_touch') == 1.0)
        | (_col(events, 'ground_duel_progressed_with_ball') == 1.0)
        | (_col(events, 'ground_duel_stopped_progress') == 1.0)
    )
    events['duel_success'] = np.where(is_duel, won, np.nan)
    events['duel_failure'] = np.where(is_duel, ~won, np.nan)

    events.loc[is_duel & is_dribble, 'type_primary'] = 'dribble'
    events.loc[is_duel & is_take_on, 'type_primary'] = 'take_on'

    # end point: next event's location (next2 when next is the paired duel
    # record), mirrored for the other team
    nxt_x = _col(events, 'location_x', np.nan).shift(-1)
    nxt_y = _col(events, 'location_y', np.nan).shift(-1)
    nxt2_x = _col(events, 'location_x', np.nan).shift(-2)
    nxt2_y = _col(events, 'location_y', np.nan).shift(-2)
    base = ~is_carry & is_duel
    cases_x = [
        (base & ~related_next & same_team_1, nxt_x),
        (base & ~related_next & ~same_team_1, 100 - nxt_x),
        (base & related_next & same_team_2, nxt2_x),
        (base & related_next & ~same_team_2, 100 - nxt2_x),
    ]
    cases_y = [
        (base & ~related_next & same_team_1, nxt_y),
        (base & ~related_next & ~same_team_1, 100 - nxt_y),
        (base & related_next & same_team_2, nxt2_y),
        (base & related_next & ~same_team_2, 100 - nxt2_y),
    ]
    for mask, val in cases_x:
        events.loc[mask, 'end_x'] = val[mask]
    for mask, val in cases_y:
        events.loc[mask, 'end_y'] = val[mask]
    return events.reset_index(drop=True)


def insert_interception_coordinates(events: pd.DataFrame) -> pd.DataFrame:
    """Interceptions end at the next event's start (reference :387-412)."""
    nxt_x = events['start_x'].shift(-1)
    nxt_y = events['start_y'].shift(-1)
    is_interception = _str_col(events, 'type_primary') == 'interception'
    same_team = events['team_id'] == events['team_id'].shift(-1)
    events.loc[is_interception & same_team, 'end_x'] = nxt_x
    events.loc[is_interception & same_team, 'end_y'] = nxt_y
    events.loc[is_interception & ~same_team, 'end_x'] = 100 - nxt_x
    events.loc[is_interception & ~same_team, 'end_y'] = 100 - nxt_y
    return events


def add_offside_variable(events: pd.DataFrame) -> pd.DataFrame:
    """Mark passes followed by an offside; drop offside events (reference :513-544)."""
    nxt_primary = events['type_primary'].astype(str).shift(-1)
    primary = _str_col(events, 'type_primary')
    events['offside'] = 0
    offside_pass = nxt_primary.eq('offside') & (primary == 'pass')
    events.loc[offside_pass, 'offside'] = 1
    events = events[primary != 'offside']
    return events.reset_index(drop=True)


def convert_touches(events: pd.DataFrame) -> pd.DataFrame:
    """Touch success from the next event (reference :590-658).

    A touch keeps possession when the same team acts next (or a duel
    follows); it loses possession when play stops or the other team acts.
    Non-carry touches end where the next event starts (mirrored for the
    other team).
    """
    return _infer_followup_results(events, 'touch', 'touch_success', 'touch_fail')


def convert_accelerations(events: pd.DataFrame) -> pd.DataFrame:
    """Acceleration success from the next event (reference :661-723)."""
    return _infer_followup_results(
        events, 'acceleration', 'acceleration_success', 'acceleration_fail'
    )


def _infer_followup_results(
    events: pd.DataFrame, primary_type: str, success_col: str, fail_col: str
) -> pd.DataFrame:
    import pandas as pd

    primary = _str_col(events, 'type_primary')
    nxt_primary = events['type_primary'].astype(str).shift(-1)
    is_type = primary == primary_type
    is_carry = _col(events, 'type_carry') == 1
    keeps = nxt_primary.isin(_KEEP_PRIMARIES)
    loses = nxt_primary.isin(_LOSE_PRIMARIES)
    next_duel = nxt_primary == 'duel'
    same_team = events['team_id'] == events['team_id'].shift(-1)

    events[success_col] = pd.Series(np.nan, index=events.index, dtype=object)
    events[fail_col] = pd.Series(np.nan, index=events.index, dtype=object)
    success = (is_type & next_duel) | (is_type & same_team & keeps) | (
        is_type & ~same_team & loses
    )
    fail = (is_type & same_team & loses) | (is_type & ~same_team & keeps)
    events.loc[success, success_col] = True
    events.loc[success, fail_col] = False
    events.loc[fail, success_col] = False
    events.loc[fail, fail_col] = True

    nxt_x = _col(events, 'location_x', np.nan).shift(-1)
    nxt_y = _col(events, 'location_y', np.nan).shift(-1)
    move = ~is_carry & is_type
    events.loc[move & same_team, 'end_x'] = nxt_x[move & same_team]
    events.loc[move & same_team, 'end_y'] = nxt_y[move & same_team]
    events.loc[move & ~same_team, 'end_x'] = (100 - nxt_x)[move & ~same_team]
    events.loc[move & ~same_team, 'end_y'] = (100 - nxt_y)[move & ~same_team]
    return events


def insert_fairplay_coordinates(events: pd.DataFrame) -> pd.DataFrame:
    """Give game interruptions before fairplay events coordinates (reference :414-447)."""
    primary = _str_col(events, 'type_primary')
    prv_x = events['start_x'].shift(1)
    prv_y = events['start_y'].shift(1)
    nxt_primary = events['type_primary'].astype(str).shift(-1)
    nxt2_primary = events['type_primary'].astype(str).shift(-2)
    interruption = (primary == 'game_interruption') & (nxt_primary == 'fairplay')
    same_team_prev = events['team_id'] == events['team_id'].shift(1)
    for cols, src in ((['end_x', 'start_x'], prv_x), (['end_y', 'start_y'], prv_y)):
        mask = interruption & same_team_prev
        events.loc[mask, cols] = np.stack([src[mask]] * 2, axis=1)
        mask = interruption & ~same_team_prev
        events.loc[mask, cols] = np.stack([(100 - src)[mask]] * 2, axis=1)
    # the event before such an interruption ends where it started
    before = (nxt_primary == 'game_interruption') & (nxt2_primary == 'fairplay')
    events.loc[before, 'end_x'] = events.loc[before, 'start_x']
    events.loc[before, 'end_y'] = events.loc[before, 'start_y']
    return events


def insert_coordinates_edge_cases(events: pd.DataFrame) -> pd.DataFrame:
    """Remaining move actions without an end point end in place (reference :449-475)."""
    primary = _str_col(events, 'type_primary')
    move = primary.isin(['pass', 'carry', 'cross', 'acceleration', 'dribble', 'take_on'])
    fix = move & events['end_x'].isna()
    events.loc[fix, 'end_x'] = events.loc[fix, 'start_x']
    fix = move & events['end_y'].isna()
    events.loc[fix, 'end_y'] = events.loc[fix, 'start_y']
    return events


# ---------------------------------------------------------------------------
# SPADL frame construction
# ---------------------------------------------------------------------------


def _period_ids(events: pd.DataFrame) -> pd.Series:
    if 'period_id' in events.columns:
        return events['period_id'].astype(np.int64)
    return _str_col(events, 'match_period').map(_PERIODS).astype(np.int64)


def _time_seconds(events: pd.DataFrame) -> pd.Series:
    if 'milliseconds' in events.columns:
        return events['milliseconds'] / 1000.0
    # v3 feeds carry absolute minute/second; make them period-relative
    # (periods restart at 45'/90'/105' like reference spadl/statsbomb.py:39-46)
    period = _period_ids(events)
    offset = period.map({1: 0, 2: 45, 3: 90, 4: 105, 5: 120}).fillna(0) * 60
    total = _col(events, 'minute').astype(float) * 60 + _col(events, 'second').astype(float)
    return (total - offset).clip(lower=0.0)


def create_df_actions(events: pd.DataFrame) -> pd.DataFrame:
    """Flat v3 events -> SPADL action frame (reference ``:725-745``).

    Applies the type/result/bodypart decision tables, drops non-actions
    and orders by (game, period, time); coordinates are fixed later by
    :func:`fix_actions`.
    """
    import pandas as pd

    primary = _str_col(events, 'type_primary')
    type_id = _determine_type_ids(events, primary)
    result_id = _determine_result_ids(events, primary, type_id)
    bodypart_id = _determine_bodypart_ids(events, primary)

    actions = pd.DataFrame(
        {
            'game_id': events['match_id']
            if 'match_id' in events.columns
            else _col(events, 'game_id', 0),
            'original_event_id': events['id'].astype(object),
            'period_id': _period_ids(events),
            'time_seconds': _time_seconds(events),
            'team_id': events['team_id'],
            'player_id': events['player_id'],
            'start_x': events['start_x'],
            'start_y': events['start_y'],
            'end_x': events['end_x'],
            'end_y': events['end_y'],
            'type_id': type_id,
            'result_id': result_id,
            'bodypart_id': bodypart_id,
        }
    )
    actions = actions[actions['type_id'] != spadlconfig.NON_ACTION]
    actions = actions.sort_values(
        ['game_id', 'period_id', 'time_seconds'], kind='stable'
    ).reset_index(drop=True)
    return actions


def _determine_type_ids(events: pd.DataFrame, primary: pd.Series) -> pd.Series:
    """SPADL type ids (reference :772-833 completed onto the SPADL vocab).

    First-match-wins ``np.select`` reproduces the if/elif precedence. The
    WIP's pass-through branch leaves non-SPADL names (``acceleration``,
    ``goal_kick``, ``touch``, ``carry``); they map to their SPADL
    equivalents here (hinted at by the reference's commented branches
    ``:806-807`` and ``:820-821``).
    """
    import pandas as pd

    t = spadlconfig.actiontypes.index
    infraction_type = _str_col(events, 'infraction_type')
    conditions = [
        (primary == 'pass') & (_col(events, 'type_cross') == 1),
        primary == 'pass',
        primary == 'throw_in',
        (primary == 'corner') & (_col(events, 'pass_length').astype(float) > 25),
        primary == 'corner',
        (primary == 'free_kick') & (_col(events, 'type_free_kick_cross') == 1),
        (primary == 'free_kick') & (_col(events, 'type_free_kick_shot') == 1),
        primary == 'free_kick',
        (primary == 'infraction')
        & infraction_type.isin(['hand_foul', 'regular_foul']),
        primary == 'penalty',
        _col(events, 'type_save') == 1,
        (primary == 'touch') & (_col(events, 'type_carry') == 1),
        # both duel-derived primaries (dribbling duel, flagged take-on) are a
        # SPADL take_on; the finer split only matters for the xT-v3 move set
        primary.isin(['take_on', 'dribble']),
        primary == 'interception',
        primary == 'shot',
        primary == 'clearance',
        primary == 'goal_kick',
        primary == 'acceleration',
        primary == 'touch',
    ]
    choices = [
        t('cross'),
        t('pass'),
        t('throw_in'),
        t('corner_crossed'),
        t('corner_short'),
        t('freekick_crossed'),
        t('shot_freekick'),
        t('freekick_short'),
        t('foul'),
        t('shot_penalty'),
        t('keeper_save'),
        t('dribble'),
        t('take_on'),
        t('interception'),
        t('shot'),
        t('clearance'),
        t('goalkick'),
        t('dribble'),
        t('dribble'),
    ]
    return pd.Series(
        np.select(conditions, choices, default=spadlconfig.NON_ACTION).astype(np.int64),
        index=events.index,
    )


def _determine_result_ids(
    events: pd.DataFrame, primary: pd.Series, type_id: pd.Series
) -> pd.Series:
    """SPADL result ids (reference :836-881 precedence)."""
    import pandas as pd

    pass_accurate = _col(events, 'pass_accurate', np.nan)
    shot_like = type_id.isin(
        [spadlconfig.SHOT, spadlconfig.SHOT_FREEKICK, spadlconfig.SHOT_PENALTY]
    )
    pass_like = type_id.isin(
        [
            spadlconfig.actiontypes.index(n)
            for n in (
                'pass', 'cross', 'throw_in', 'goalkick', 'freekick_short',
                'freekick_crossed', 'corner_crossed', 'corner_short',
            )
        ]
    )
    conditions = [
        _col(events, 'offside') == 1,
        type_id == spadlconfig.actiontypes.index('foul'),
        _col(events, 'shot_own_goal') == 1,
        _col(events, 'touch_success', np.nan) == True,  # noqa: E712
        _col(events, 'touch_fail', np.nan) == True,  # noqa: E712
        _col(events, 'acceleration_success', np.nan) == True,  # noqa: E712
        _col(events, 'acceleration_fail', np.nan) == True,  # noqa: E712
        _col(events, 'shot_is_goal') == 1,
        _col(events, 'duel_success', np.nan) == True,  # noqa: E712
        _col(events, 'duel_failure', np.nan) == True,  # noqa: E712
        shot_like,
        pass_like & (pass_accurate == 1),
        pass_like & (pass_accurate == 0),
    ]
    choices = [
        spadlconfig.OFFSIDE,
        spadlconfig.SUCCESS,
        spadlconfig.OWNGOAL,
        spadlconfig.SUCCESS,
        spadlconfig.FAIL,
        spadlconfig.SUCCESS,
        spadlconfig.FAIL,
        spadlconfig.SUCCESS,
        spadlconfig.SUCCESS,
        spadlconfig.FAIL,
        spadlconfig.FAIL,
        spadlconfig.SUCCESS,
        spadlconfig.FAIL,
    ]
    # clearance/interception/keeper_save and the no-information fallback are
    # all "success" (reference :876-881)
    return pd.Series(
        np.select(conditions, choices, default=spadlconfig.SUCCESS).astype(np.int64),
        index=events.index,
    )


def _determine_bodypart_ids(events: pd.DataFrame, primary: pd.Series) -> pd.Series:
    """SPADL bodypart ids (reference :749-769 precedence)."""
    import pandas as pd

    other = (
        (_col(events, 'type_save') == 1)
        | (primary == 'throw_in')
        | (_col(events, 'type_hand_pass') == 1)
        | (_str_col(events, 'infraction_type') == 'hand_foul')
    )
    head = (
        (_col(events, 'type_head_pass') == 1)
        | (_col(events, 'type_head_shot') == 1)
        | (_col(events, 'type_aerial_duel') == 1)
    )
    return pd.Series(
        np.select(
            [other, head], [spadlconfig.OTHER, spadlconfig.HEAD],
            default=spadlconfig.FOOT,
        ).astype(np.int64),
        index=events.index,
    )


def fix_actions(actions: pd.DataFrame) -> pd.DataFrame:
    """(0-100)² → 105×68 m with y flip, plus coordinate repairs.

    Reference ``:901-937`` (rescale + keeper-save inversion) and ``:960-976``
    (foul end coordinates; required for schema validity).
    """
    actions = actions.copy()
    length, width = spadlconfig.field_length, spadlconfig.field_width
    actions['start_x'] = (actions['start_x'] * length / 100).clip(0, length)
    actions['end_x'] = (actions['end_x'] * length / 100).clip(0, length)
    actions['start_y'] = ((100 - actions['start_y']) * width / 100).clip(0, width)
    actions['end_y'] = ((100 - actions['end_y']) * width / 100).clip(0, width)
    actions = fix_foul_coordinates(actions)
    actions = fix_keeper_save_coordinates(actions)
    return actions


def fix_foul_coordinates(df_actions: pd.DataFrame) -> pd.DataFrame:
    """Fouls (and any other still-endless action) end where they start."""
    no_end = df_actions['end_x'].isna() | df_actions['end_y'].isna()
    df_actions.loc[no_end, 'end_x'] = df_actions.loc[no_end, 'start_x']
    df_actions.loc[no_end, 'end_y'] = df_actions.loc[no_end, 'start_y']
    return df_actions





def determine_type_id(event: Any) -> int:
    """SPADL action-type id of one Wyscout-v3 event (row-wise reference API).

    Documented deviation: the reference's WIP ``determine_type_id`` returns
    string *names* (``spadl/wyscout_v3.py:832-833``, see SURVEY.md §0); the
    intended semantics — and this implementation — return the vocabulary id.
    """
    ev = _single_event(event)
    return int(_determine_type_ids(ev, _str_col(ev, 'type_primary')).iloc[0])


def determine_result_id(event: Any) -> int:
    """SPADL result id of one Wyscout-v3 event (row-wise reference API)."""
    ev = _single_event(event)
    primary = _str_col(ev, 'type_primary')
    type_id = _determine_type_ids(ev, primary)
    return int(_determine_result_ids(ev, primary, type_id).iloc[0])


def determine_bodypart_id(event: Any) -> int:
    """SPADL bodypart id of one Wyscout-v3 event (row-wise reference API)."""
    ev = _single_event(event)
    return int(_determine_bodypart_ids(ev, _str_col(ev, 'type_primary')).iloc[0])
