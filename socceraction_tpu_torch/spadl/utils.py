"""Utility functions for SPADL action tables.

Port of ``socceraction_tpu/spadl/utils.py`` (reference
``socceraction/spadl/utils.py:8-57``: ``add_names`` and the upstream
two-argument ``play_left_to_right_sa``, the canonical semantics). pandas
is imported inside the functions, which take and return frames.
"""

from __future__ import annotations

from typing import TYPE_CHECKING

from . import config as spadlconfig
from .base import _fix_direction_of_play
from .schema import SPADLSchema

if TYPE_CHECKING:
    import pandas as pd

__all__ = ['add_names', 'play_left_to_right', 'play_left_to_right_sa']


def add_names(actions: 'pd.DataFrame') -> 'pd.DataFrame':
    """Add 'type_name', 'result_name' and 'bodypart_name' columns.

    Any pre-existing name columns are replaced.
    """
    out = (
        actions.drop(columns=['type_name', 'result_name', 'bodypart_name'], errors='ignore')
        .merge(spadlconfig.actiontypes_df(), how='left')
        .merge(spadlconfig.results_df(), how='left')
        .merge(spadlconfig.bodyparts_df(), how='left')
    )
    return SPADLSchema.validate(out)


def play_left_to_right(actions: 'pd.DataFrame', home_team_id: int) -> 'pd.DataFrame':
    """A copy of one game's actions with the away team's coordinates
    mirrored in both axes, so that every team plays left to right."""
    return _fix_direction_of_play(actions.copy(), home_team_id)


#: The reference's name of the canonical two-argument function (its fork
#: repurposed the unsuffixed name); both names are the same function here.
play_left_to_right_sa = play_left_to_right
