"""Base schemas that every provider's loader output must satisfy.

Parity: reference ``socceraction/data/schema.py:13-109`` (pandera models),
expressed with the dependency-free schema core. Provider-specific loaders
extend these with extra columns (``strict=False`` permits them).

Port of ``socceraction_tpu/data/schema.py``.
"""

from __future__ import annotations

from ..schema import Field, Schema

CompetitionSchema = Schema(
    fields={
        'season_id': Field(),
        'season_name': Field(dtype='str'),
        'competition_id': Field(),
        'competition_name': Field(dtype='str'),
    },
    strict=False,
)

GameSchema = Schema(
    fields={
        'game_id': Field(),
        'season_id': Field(),
        'competition_id': Field(),
        'game_day': Field(nullable=True),
        'game_date': Field(dtype='datetime64[ns]'),
        'home_team_id': Field(),
        'away_team_id': Field(),
    },
    strict=False,
)

TeamSchema = Schema(
    fields={
        'team_id': Field(),
        'team_name': Field(dtype='str'),
    },
    strict=False,
)

PlayerSchema = Schema(
    fields={
        'game_id': Field(),
        'team_id': Field(),
        'player_id': Field(),
        'player_name': Field(dtype='str'),
        'is_starter': Field(dtype='bool'),
        'minutes_played': Field(dtype='int64'),
        'jersey_number': Field(dtype='int64'),
    },
    strict=False,
)

EventSchema = Schema(
    fields={
        'game_id': Field(),
        'event_id': Field(),
        'period_id': Field(dtype='int64'),
        'team_id': Field(nullable=True),
        'player_id': Field(nullable=True),
        'type_id': Field(dtype='int64'),
        'type_name': Field(dtype='str'),
    },
    strict=False,
)
