"""SPADL: the Soccer Player Action Description Language (the port's own copy).

Vocabulary, schema and utilities of ``socceraction_tpu.spadl``; the
per-provider converters are not ported yet.
"""

from . import config  # noqa: F401
from .config import (
    actiontypes,
    actiontypes_df,
    bodyparts,
    bodyparts_df,
    field_length,
    field_width,
    results,
    results_df,
)
from .schema import SPADLSchema
from .utils import add_names, play_left_to_right, play_left_to_right_sa

__all__ = [
    'config',
    'actiontypes',
    'actiontypes_df',
    'bodyparts',
    'bodyparts_df',
    'field_length',
    'field_width',
    'results',
    'results_df',
    'SPADLSchema',
    'add_names',
    'play_left_to_right',
    'play_left_to_right_sa',
]
