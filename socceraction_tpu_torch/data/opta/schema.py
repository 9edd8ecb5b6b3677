"""Schemas for Opta loader output.

Parity: reference ``socceraction/data/opta/schema.py:17-85`` — the base
schemas extended with Opta-specific columns.

Port of ``socceraction_tpu/data/opta/schema.py``.
"""

from __future__ import annotations

from ...schema import Field, Schema

OptaCompetitionSchema = Schema(
    fields={
        'season_id': Field(),
        'season_name': Field(dtype='str'),
        'competition_id': Field(),
        'competition_name': Field(dtype='str'),
    },
    strict=False,
)

OptaGameSchema = Schema(
    fields={
        'game_id': Field(),
        'season_id': Field(),
        'competition_id': Field(),
        'game_day': Field(nullable=True, required=False),
        'game_date': Field(dtype='datetime64[ns]'),
        'home_team_id': Field(),
        'away_team_id': Field(),
        'home_score': Field(nullable=True, required=False),
        'away_score': Field(nullable=True, required=False),
        'duration': Field(nullable=True, required=False),
        'referee': Field(nullable=True, required=False),
        'venue': Field(nullable=True, required=False),
        'attendance': Field(nullable=True, required=False),
        'home_manager': Field(nullable=True, required=False),
        'away_manager': Field(nullable=True, required=False),
    },
    strict=False,
)

OptaTeamSchema = Schema(
    fields={
        'team_id': Field(),
        'team_name': Field(dtype='str'),
    },
    strict=False,
)

OptaPlayerSchema = Schema(
    fields={
        'game_id': Field(),
        'team_id': Field(),
        'player_id': Field(),
        'player_name': Field(dtype='str'),
        'is_starter': Field(dtype='bool'),
        'minutes_played': Field(dtype='int64'),
        'jersey_number': Field(dtype='int64'),
        'starting_position': Field(dtype='str', required=False),
    },
    strict=False,
)

OptaEventSchema = Schema(
    fields={
        'game_id': Field(),
        'event_id': Field(),
        'period_id': Field(dtype='int64'),
        'team_id': Field(nullable=True),
        'player_id': Field(nullable=True),
        'type_id': Field(dtype='int64'),
        'type_name': Field(dtype='str'),
        'timestamp': Field(dtype='datetime64[ns]'),
        'minute': Field(dtype='int64'),
        'second': Field(dtype='int64', ge=0, le=59),
        'outcome': Field(nullable=True),
        'start_x': Field(nullable=True),
        'start_y': Field(nullable=True),
        'end_x': Field(nullable=True),
        'end_y': Field(nullable=True),
        'qualifiers': Field(dtype='object'),
        'assist': Field(required=False),
        'keypass': Field(required=False),
        'goal': Field(required=False),
        'shot': Field(required=False),
        'touch': Field(required=False),
        'related_player_id': Field(nullable=True, required=False),
    },
    strict=False,
)
