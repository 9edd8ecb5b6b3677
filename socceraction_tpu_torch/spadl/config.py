"""Vocabulary and pitch constants of the SPADL action language.

Copied from ``socceraction_tpu/spadl/config.py`` (reference
``socceraction/spadl/config.py:21-91``). The vocabulary *order defines the
id spaces* every kernel uses (one-hot widths, combined-table ids, label
masks), so it must stay identical to the JAX package's.
"""

from __future__ import annotations

from typing import TYPE_CHECKING, List

import numpy as np

if TYPE_CHECKING:  # pandas is imported inside the *_df tables only
    import pandas as pd

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
CLEARANCE = actiontypes.index('clearance')
NON_ACTION = actiontypes.index('non_action')

FAIL = results.index('fail')
SUCCESS = results.index('success')
OFFSIDE = results.index('offside')
OWNGOAL = results.index('owngoal')
YELLOW_CARD = results.index('yellow_card')
RED_CARD = results.index('red_card')

FOOT = bodyparts.index('foot')
HEAD = bodyparts.index('head')
OTHER = bodyparts.index('other')

#: Action-type ids whose name contains 'shot': the goal predicate of the
#: VAEP labels, the goalscore feature and xG's shot filter.
SHOT_LIKE = tuple(i for i, t in enumerate(actiontypes) if 'shot' in t)

shot_like_mask: np.ndarray = np.zeros(len(actiontypes), dtype=bool)
shot_like_mask[list(SHOT_LIKE)] = True


def actiontypes_df() -> 'pd.DataFrame':
    """The ``type_id`` and ``type_name`` of each SPADL action type."""
    import pandas as pd

    return pd.DataFrame({'type_id': np.arange(len(actiontypes)), 'type_name': actiontypes})


def results_df() -> 'pd.DataFrame':
    """The ``result_id`` and ``result_name`` of each SPADL result."""
    import pandas as pd

    return pd.DataFrame({'result_id': np.arange(len(results)), 'result_name': results})


def bodyparts_df() -> 'pd.DataFrame':
    """The ``bodypart_id`` and ``bodypart_name`` of each SPADL bodypart."""
    import pandas as pd

    return pd.DataFrame({'bodypart_id': np.arange(len(bodyparts)), 'bodypart_name': bodyparts})
