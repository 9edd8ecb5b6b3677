"""Atomic-SPADL: the atomic action representation (the port's own copy).

Vocabulary, schema, utilities and the converter ``convert_to_atomic`` of
``socceraction_tpu.atomic.spadl``.
"""

from . import config  # noqa: F401
from .base import convert_to_atomic
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
    'convert_to_atomic',
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
