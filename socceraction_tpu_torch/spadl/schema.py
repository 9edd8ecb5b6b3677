"""Schema of a SPADL action table.

Copied from ``socceraction_tpu/spadl/schema.py`` (reference
``socceraction/spadl/schema.py:10-33``, a pandera model there), on the
port's dependency-free schema core.
"""

from __future__ import annotations

from ..schema import Field, Schema
from . import config as spadlconfig

SPADLSchema = Schema(
    fields={
        'game_id': Field(),
        'original_event_id': Field(nullable=True),
        'action_id': Field(dtype='int64'),
        'period_id': Field(dtype='int64', ge=1, le=5),
        'time_seconds': Field(dtype='float64', ge=0),
        'team_id': Field(),
        'player_id': Field(),
        'start_x': Field(dtype='float64', ge=0, le=spadlconfig.field_length),
        'start_y': Field(dtype='float64', ge=0, le=spadlconfig.field_width),
        'end_x': Field(dtype='float64', ge=0, le=spadlconfig.field_length),
        'end_y': Field(dtype='float64', ge=0, le=spadlconfig.field_width),
        'bodypart_id': Field(dtype='int64', isin=range(len(spadlconfig.bodyparts))),
        'bodypart_name': Field(dtype='str', isin=spadlconfig.bodyparts, required=False),
        'type_id': Field(dtype='int64', isin=range(len(spadlconfig.actiontypes))),
        'type_name': Field(dtype='str', isin=spadlconfig.actiontypes, required=False),
        'result_id': Field(dtype='int64', isin=range(len(spadlconfig.results))),
        'result_name': Field(dtype='str', isin=spadlconfig.results, required=False),
    },
    strict=False,
)
