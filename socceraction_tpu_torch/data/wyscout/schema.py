"""Schemas for Wyscout loader output.

Parity: reference ``socceraction/data/wyscout/schema.py:14-47`` — the base
schemas extended with Wyscout-specific columns.

Port of ``socceraction_tpu/data/wyscout/schema.py``.
"""

from __future__ import annotations

from ...schema import Field, Schema

WyscoutCompetitionSchema = Schema(
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

WyscoutGameSchema = Schema(
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

WyscoutTeamSchema = Schema(
    fields={
        'team_id': Field(),
        'team_name': Field(dtype='str'),
        'team_name_short': Field(dtype='str'),
    },
    strict=False,
)

WyscoutPlayerSchema = Schema(
    fields={
        'game_id': Field(),
        'team_id': Field(),
        'player_id': Field(),
        'player_name': Field(dtype='str'),
        'firstname': Field(dtype='str'),
        'lastname': Field(dtype='str'),
        'nickname': Field(nullable=True),
        'birth_date': Field(nullable=True),
        'is_starter': Field(dtype='bool'),
        'minutes_played': Field(dtype='int64'),
        'jersey_number': Field(dtype='int64'),
    },
    strict=False,
)

WyscoutEventSchema = Schema(
    fields={
        'game_id': Field(),
        'event_id': Field(),
        'period_id': Field(dtype='int64'),
        'team_id': Field(nullable=True),
        'player_id': Field(nullable=True),
        'type_id': Field(dtype='int64'),
        'type_name': Field(dtype='str'),
        'subtype_id': Field(dtype='int64'),
        'subtype_name': Field(dtype='str'),
        'milliseconds': Field(dtype='float64'),
        'positions': Field(dtype='object'),
        'tags': Field(dtype='object'),
    },
    strict=False,
)
