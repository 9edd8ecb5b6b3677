"""SPADL: the Soccer Player Action Description Language (the port's own copy).

Vocabulary, schema, shared converter passes, utilities and the
per-provider ``convert_to_actions`` converters of ``socceraction_tpu.spadl``.
pandas is imported inside the converters, so the package imports where
pandas is absent.
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
from . import statsbomb  # noqa: F401  (provider converters)
from . import wyscout  # noqa: F401
from . import wyscout_v3  # noqa: F401
from . import opta  # noqa: F401

__all__ = [
    'config',
    'statsbomb',
    'wyscout',
    'wyscout_v3',
    'opta',
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
