"""Vocabulary and pitch constants of the SPADL action language.

Copied from ``socceraction_tpu/spadl/config.py`` (reference
``socceraction/spadl/config.py:21-91``). The vocabulary *order defines the
id spaces* every kernel uses (one-hot widths, combined-table ids, label
masks), so it must stay identical to the JAX package's.
"""

from __future__ import annotations

from typing import List

field_length: float = 105.0  # meters
field_width: float = 68.0  # meters

bodyparts: List[str] = ['foot', 'head', 'other', 'head/other']

results: List[str] = [
    'fail',
    'success',
    'offside',
    'owngoal',
    'yellow_card',
    'red_card',
]

actiontypes: List[str] = [
    'pass',
    'cross',
    'throw_in',
    'freekick_crossed',
    'freekick_short',
    'corner_crossed',
    'corner_short',
    'take_on',
    'foul',
    'tackle',
    'interception',
    'shot',
    'shot_penalty',
    'shot_freekick',
    'keeper_save',
    'keeper_claim',
    'keeper_punch',
    'keeper_pick_up',
    'clearance',
    'bad_touch',
    'non_action',
    'dribble',
    'goalkick',
]

PASS = actiontypes.index('pass')
CROSS = actiontypes.index('cross')
DRIBBLE = actiontypes.index('dribble')
SHOT = actiontypes.index('shot')
SHOT_PENALTY = actiontypes.index('shot_penalty')
SHOT_FREEKICK = actiontypes.index('shot_freekick')
CORNER_CROSSED = actiontypes.index('corner_crossed')
CORNER_SHORT = actiontypes.index('corner_short')

SUCCESS = results.index('success')
OWNGOAL = results.index('owngoal')
