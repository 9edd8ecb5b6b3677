"""Wyscout event data provider.

Parity: reference ``socceraction/data/wyscout/__init__.py``.

Port of ``socceraction_tpu/data/wyscout/__init__.py``.
"""

from .loader import PublicWyscoutLoader, WyscoutLoader, wyscout_periods
from .v3 import flatten_v3_events, load_v3_events
from .schema import (
    WyscoutCompetitionSchema,
    WyscoutEventSchema,
    WyscoutGameSchema,
    WyscoutPlayerSchema,
    WyscoutTeamSchema,
)

__all__ = [
    'PublicWyscoutLoader',
    'WyscoutLoader',
    'wyscout_periods',
    'flatten_v3_events',
    'load_v3_events',
    'WyscoutCompetitionSchema',
    'WyscoutGameSchema',
    'WyscoutPlayerSchema',
    'WyscoutTeamSchema',
    'WyscoutEventSchema',
]
