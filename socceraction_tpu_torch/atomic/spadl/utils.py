"""Utility functions for Atomic-SPADL frames.

Port of ``socceraction_tpu/atomic/spadl/utils.py`` (reference
``socceraction/atomic/spadl/utils.py:8-56``). pandas is imported inside
the functions, which take and return frames.
"""

from __future__ import annotations

from typing import TYPE_CHECKING

from . import config as atomicconfig
from .schema import AtomicSPADLSchema

if TYPE_CHECKING:
    import pandas as pd

__all__ = ['add_names', 'play_left_to_right']


def add_names(actions: 'pd.DataFrame') -> 'pd.DataFrame':
    """Add 'type_name' and 'bodypart_name' columns to an atomic frame."""
    out = (
        actions.drop(columns=['type_name', 'bodypart_name'], errors='ignore')
        .merge(atomicconfig.actiontypes_df(), how='left')
        .merge(atomicconfig.bodyparts_df(), how='left')
    )
    out.index = actions.index
    return AtomicSPADLSchema.validate(out)


def play_left_to_right(actions: 'pd.DataFrame', home_team_id: int) -> 'pd.DataFrame':
    """Mirror the away team's actions so both teams play left-to-right.

    Flips locations to ``extent - v`` and negates displacements.
    """
    ltr = actions.copy()
    away = (actions['team_id'] != home_team_id).to_numpy()
    ltr.loc[away, 'x'] = atomicconfig.field_length - actions.loc[away, 'x'].to_numpy()
    ltr.loc[away, 'y'] = atomicconfig.field_width - actions.loc[away, 'y'].to_numpy()
    ltr.loc[away, 'dx'] = -actions.loc[away, 'dx'].to_numpy()
    ltr.loc[away, 'dy'] = -actions.loc[away, 'dy'].to_numpy()
    return ltr
