"""StatsBomb data loader.

Port of ``socceraction_tpu/data/statsbomb/__init__.py``.
"""

from .loader import StatsBombLoader, extract_player_games
from .schema import (
    StatsBombCompetitionSchema,
    StatsBombEventSchema,
    StatsBombGameSchema,
    StatsBombPlayerSchema,
    StatsBombTeamSchema,
)

__all__ = [
    'StatsBombLoader',
    'extract_player_games',
    'StatsBombCompetitionSchema',
    'StatsBombGameSchema',
    'StatsBombTeamSchema',
    'StatsBombPlayerSchema',
    'StatsBombEventSchema',
]
