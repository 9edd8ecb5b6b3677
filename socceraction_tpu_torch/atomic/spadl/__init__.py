"""Atomic-SPADL: the atomic action representation (the port's own copy).

Vocabulary, schema and utilities of ``socceraction_tpu.atomic.spadl``; the
converter ``convert_to_atomic`` is not ported yet.
"""

from . import config  # noqa: F401
from .config import (
    actiontypes,
    actiontypes_df,
    bodyparts,
    bodyparts_df,
    field_length,
    field_width,
)
from .schema import AtomicSPADLSchema
from .utils import add_names, play_left_to_right

__all__ = [
    'config',
    'actiontypes',
    'actiontypes_df',
    'bodyparts',
    'bodyparts_df',
    'field_length',
    'field_width',
    'AtomicSPADLSchema',
    'add_names',
    'play_left_to_right',
]
