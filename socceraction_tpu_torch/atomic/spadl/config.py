"""Vocabulary of the Atomic-SPADL action language.

Copied from ``socceraction_tpu/atomic/spadl/config.py`` (reference
``socceraction/atomic/spadl/config.py:25-36``). Atomic rows carry a
location and a displacement ``(x, y, dx, dy)`` instead of start and end
points, and no result: outcomes are actions themselves. The vocabulary is
the 23 SPADL types and 10 atomic ones. The reference's quirk is kept:
``'interception'`` occurs twice (ids 10 and 24) and ``.index()`` picks the
first, so the converter never produces id 24.
"""

from __future__ import annotations

from typing import TYPE_CHECKING, List

from ...spadl import config as _spadl

if TYPE_CHECKING:  # pandas is imported inside actiontypes_df only
    import pandas as pd

field_length: float = _spadl.field_length
field_width: float = _spadl.field_width

bodyparts: List[str] = _spadl.bodyparts
bodyparts_df = _spadl.bodyparts_df

actiontypes: List[str] = _spadl.actiontypes + [
    'receival',
    'interception',
    'out',
    'offside',
    'goal',
    'owngoal',
    'yellow_card',
    'red_card',
    'corner',
    'freekick',
]

# .index() picks the FIRST occurrence, like the reference
RECEIVAL = actiontypes.index('receival')  # 23
INTERCEPTION = actiontypes.index('interception')  # 10 (the SPADL id)
OUT = actiontypes.index('out')  # 25
OFFSIDE = actiontypes.index('offside')  # 26
GOAL = actiontypes.index('goal')  # 27
OWNGOAL = actiontypes.index('owngoal')  # 28
YELLOW_CARD = actiontypes.index('yellow_card')  # 29
RED_CARD = actiontypes.index('red_card')  # 30
CORNER = actiontypes.index('corner')  # 31
FREEKICK = actiontypes.index('freekick')  # 32


def actiontypes_df() -> 'pd.DataFrame':
    """The ``type_id`` and ``type_name`` of each Atomic-SPADL type."""
    import numpy as np
    import pandas as pd

    return pd.DataFrame({'type_id': np.arange(len(actiontypes)), 'type_name': actiontypes})
