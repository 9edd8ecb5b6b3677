"""Schema of an Atomic-SPADL action table.

Copied from ``socceraction_tpu/atomic/spadl/schema.py`` (reference
``socceraction/atomic/spadl/schema.py:10-31``).
"""

from __future__ import annotations

from ...schema import Field, Schema
from . import config as atomicconfig

AtomicSPADLSchema = Schema(
    fields={
        'game_id': Field(),
        'original_event_id': Field(nullable=True),
        'action_id': Field(dtype='int64'),
        'period_id': Field(dtype='int64', ge=1, le=5),
        'time_seconds': Field(dtype='float64', ge=0),
        'team_id': Field(),
        'player_id': Field(),
        'x': Field(dtype='float64', ge=0, le=atomicconfig.field_length),
        'y': Field(dtype='float64', ge=0, le=atomicconfig.field_width),
        'dx': Field(
            dtype='float64', ge=-atomicconfig.field_length, le=atomicconfig.field_length
        ),
        'dy': Field(dtype='float64', ge=-atomicconfig.field_width, le=atomicconfig.field_width),
        'bodypart_id': Field(dtype='int64', isin=range(len(atomicconfig.bodyparts))),
        'bodypart_name': Field(dtype='str', isin=atomicconfig.bodyparts, required=False),
        'type_id': Field(dtype='int64', isin=range(len(atomicconfig.actiontypes))),
        'type_name': Field(dtype='str', isin=atomicconfig.actiontypes, required=False),
    },
    strict=False,
)
