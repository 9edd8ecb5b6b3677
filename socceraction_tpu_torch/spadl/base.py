"""Shared post-processing passes used by all event-stream -> SPADL converters.

These implement the upstream (``_sa``) semantics of the reference fork -- see
reference ``socceraction/spadl/base.py:12-19`` (`_fix_clearances_sa`),
``:39-46`` (`_fix_direction_of_play_sa`) and ``:49-93`` (`_add_dribbles`).
The fork's unsuffixed variants expect raw Wyscout-v3 frames and are broken
for SPADL frames; the canonical behavior rebuilt here is the suffixed one.

All three passes are host-side, row-count-changing or in-place frame surgery
and therefore live on the pandas side of the host/device boundary: the packed
tensor pipeline (:mod:`socceraction_tpu_torch.core.batch`) consumes their output.

Port of ``socceraction_tpu/spadl/base.py``: the same code, with pandas imported inside the functions
that take or build frames, so the module imports where pandas is absent.
"""

from __future__ import annotations

from typing import TYPE_CHECKING

import numpy as np

from ..config import MAX_DRIBBLE_DURATION, MAX_DRIBBLE_LENGTH, MIN_DRIBBLE_LENGTH
from . import config as spadlconfig

if TYPE_CHECKING:  # pandas is imported inside the functions that take or build frames
    import pandas as pd

min_dribble_length: float = MIN_DRIBBLE_LENGTH
max_dribble_length: float = MAX_DRIBBLE_LENGTH
max_dribble_duration: float = MAX_DRIBBLE_DURATION


def _fix_clearances(actions: pd.DataFrame) -> pd.DataFrame:
    """Set each clearance's end location to the next action's start location.

    The last row acts as its own successor (a trailing clearance's end
    location becomes its own start location).
    """
    next_start_x = np.append(actions['start_x'].to_numpy()[1:], np.nan)
    next_start_y = np.append(actions['start_y'].to_numpy()[1:], np.nan)
    if len(actions):
        next_start_x[-1] = actions['start_x'].iloc[-1]
        next_start_y[-1] = actions['start_y'].iloc[-1]
    clearance = (actions['type_id'] == spadlconfig.CLEARANCE).to_numpy()
    actions.loc[clearance, 'end_x'] = next_start_x[clearance]
    actions.loc[clearance, 'end_y'] = next_start_y[clearance]
    return actions


def _fix_direction_of_play(actions: pd.DataFrame, home_team_id: int) -> pd.DataFrame:
    """Mirror the away team's coordinates so both teams play left-to-right."""
    away = (actions['team_id'] != home_team_id).to_numpy()
    for col, extent in (
        ('start_x', spadlconfig.field_length),
        ('end_x', spadlconfig.field_length),
        ('start_y', spadlconfig.field_width),
        ('end_y', spadlconfig.field_width),
    ):
        actions.loc[away, col] = extent - actions.loc[away, col].to_numpy()
    return actions


def _add_dribbles(actions: pd.DataFrame) -> pd.DataFrame:
    """Synthesize dribble actions between consecutive same-team actions.

    A dribble row is inserted between action i and i+1 when the same team
    performs both, the gap between i's end and (i+1)'s start is 3-60 m,
    less than 10 s elapses, and both are in the same period. The inserted
    row gets ``action_id = i + 0.1`` so the final sort slots it between the
    two, after which action ids are renumbered 0..n-1.

    Matches reference ``socceraction/spadl/base.py:54-93`` including its
    ``shift(-1, fill_value=0)`` edge semantics (the last action is compared
    against an all-zero phantom successor).
    """
    import pandas as pd

    nex = actions.shift(-1, fill_value=0)

    same_team = actions['team_id'] == nex['team_id']
    dx = actions['end_x'] - nex['start_x']
    dy = actions['end_y'] - nex['start_y']
    gap_sq = dx**2 + dy**2
    far_enough = gap_sq >= min_dribble_length**2
    not_too_far = gap_sq <= max_dribble_length**2
    same_phase = (nex['time_seconds'] - actions['time_seconds']) < max_dribble_duration
    same_period = actions['period_id'] == nex['period_id']

    dribble_idx = same_team & far_enough & not_too_far & same_phase & same_period

    prev_sel = actions[dribble_idx]
    next_sel = nex[dribble_idx]

    dribbles = pd.DataFrame(
        {
            'game_id': next_sel['game_id'],
            'period_id': next_sel['period_id'],
            'action_id': prev_sel['action_id'] + 0.1,
            'time_seconds': (prev_sel['time_seconds'] + next_sel['time_seconds']) / 2,
            'team_id': next_sel['team_id'],
            'player_id': next_sel['player_id'],
            'start_x': prev_sel['end_x'],
            'start_y': prev_sel['end_y'],
            'end_x': next_sel['start_x'],
            'end_y': next_sel['start_y'],
            'bodypart_id': spadlconfig.FOOT,
            'type_id': spadlconfig.DRIBBLE,
            'result_id': spadlconfig.SUCCESS,
        }
    )
    if 'timestamp' in actions.columns:
        dribbles['timestamp'] = next_sel['timestamp']

    actions = pd.concat([actions, dribbles], ignore_index=True, sort=False)
    actions = actions.sort_values(['game_id', 'period_id', 'action_id']).reset_index(
        drop=True
    )
    actions['action_id'] = range(len(actions))
    return actions


def _single_event(event: pd.Series | pd.DataFrame) -> pd.DataFrame:
    """Wrap a per-row ``pd.Series`` (the reference's row-wise API) as a frame.

    Shared by the Wyscout converters' row-wise ``determine_*`` wrappers.
    """
    import pandas as pd

    return pd.DataFrame([event]) if isinstance(event, pd.Series) else event
