"""Schemas for StatsBomb loader output.

Parity: reference ``socceraction/data/statsbomb/schema.py:16-99`` — the
base schemas extended with StatsBomb-specific columns.

Port of ``socceraction_tpu/data/statsbomb/schema.py``.
"""

from __future__ import annotations

from ...schema import Field, Schema

StatsBombCompetitionSchema = Schema(
    fields={
        'season_id': Field(),
        'competition_id': Field(),
        'competition_name': Field(dtype='str'),
        'country_name': Field(dtype='str'),
        'competition_gender': Field(dtype='str'),
        'season_name': Field(dtype='str'),
    },
    strict=False,
)

StatsBombGameSchema = Schema(
    fields={
        'game_id': Field(),
        'season_id': Field(),
        'competition_id': Field(),
        'competition_stage': Field(dtype='str'),
        'game_day': Field(nullable=True),
        'game_date': Field(dtype='datetime64[ns]'),
        'home_team_id': Field(),
        'away_team_id': Field(),
        'home_score': Field(dtype='int64'),
        'away_score': Field(dtype='int64'),
        'venue': Field(nullable=True),
        'referee': Field(nullable=True),
    },
    strict=False,
)

StatsBombTeamSchema = Schema(
    fields={
        'team_id': Field(),
        'team_name': Field(dtype='str'),
    },
    strict=False,
)

StatsBombPlayerSchema = Schema(
    fields={
        'game_id': Field(),
        'team_id': Field(),
        'player_id': Field(),
        'player_name': Field(dtype='str'),
        'nickname': Field(nullable=True),
        'jersey_number': Field(dtype='int64'),
        'is_starter': Field(dtype='bool'),
        'starting_position_id': Field(dtype='int64'),
        'starting_position_name': Field(dtype='str'),
        'minutes_played': Field(dtype='int64'),
    },
    strict=False,
)

StatsBombEventSchema = Schema(
    fields={
        'game_id': Field(),
        'event_id': Field(),
        'period_id': Field(dtype='int64'),
        'team_id': Field(),
        'player_id': Field(nullable=True),
        'type_id': Field(dtype='int64'),
        'type_name': Field(dtype='str'),
        'index': Field(dtype='int64'),
        'timestamp': Field(dtype='datetime64[ns]'),
        'minute': Field(dtype='int64'),
        'second': Field(dtype='int64'),
        'possession': Field(dtype='int64'),
        'possession_team_id': Field(),
        'possession_team_name': Field(dtype='str'),
        'play_pattern_id': Field(dtype='int64'),
        'play_pattern_name': Field(dtype='str'),
        'team_name': Field(dtype='str'),
        'duration': Field(dtype='float64'),
        'extra': Field(),
        'related_events': Field(),
        'player_name': Field(nullable=True),
        'position_id': Field(nullable=True),
        'position_name': Field(nullable=True),
        'location': Field(nullable=True),
        'under_pressure': Field(dtype='bool'),
        'counterpress': Field(dtype='bool'),
        'visible_area_360': Field(nullable=True, required=False),
        'freeze_frame_360': Field(nullable=True, required=False),
    },
    strict=False,
)
