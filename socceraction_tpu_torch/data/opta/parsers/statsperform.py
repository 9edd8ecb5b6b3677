"""Shared field specs for Stats Perform (MA-series) feeds.

MA1 (fixtures/lineups) and MA3 (events) are one data model split over
two files: both carry the same ``matchInfo`` header with string ids
(reference: ``socceraction/data/opta/parsers/ma1_json.py`` and
``ma3_json.py``, which each re-extract it imperatively). The common
records — competition/season, contestant teams, the event row — are
declared once here; the parser modules keep only feed-specific logic
(roster assembly, substitution windows).

Port of ``socceraction_tpu/data/opta/parsers/statsperform.py``.
"""

from __future__ import annotations

from typing import Tuple

from .base import END_COORD_FIELDS
from .spec import Field, flag, ts

__all__ = ['COMPETITION_FIELDS', 'TEAM_FIELDS', 'EVENT_FIELDS', 'SUBSTITUTION_FIELDS']

#: Competition/season header out of a ``matchInfo`` node.
COMPETITION_FIELDS: Tuple[Field, ...] = (
    Field('season_id', ('tournamentCalendar', 'id')),
    Field('season_name', ('tournamentCalendar', 'name')),
    Field('competition_id', ('competition', 'id')),
    Field('competition_name', ('competition', 'name')),
)

#: One contestant out of ``matchInfo.contestant[]``.
TEAM_FIELDS: Tuple[Field, ...] = (
    Field('team_id', 'id'),
    Field('team_name', 'name'),
)

#: One event out of ``liveData.event[]`` (MA3). camelCase keys, string
#: team/player ids, mixed sub-second / whole-second timestamps.
EVENT_FIELDS: Tuple[Field, ...] = (
    Field('event_id', 'id', int),
    Field('period_id', 'periodId', int),
    Field('team_id', 'contestantId'),
    Field('player_id', 'playerId', default=None),
    Field('type_id', 'typeId', int),
    Field('timestamp', 'timeStamp', ts('%Y-%m-%dT%H:%M:%S.%fZ', '%Y-%m-%dT%H:%M:%SZ')),
    Field('minute', 'timeMin', int),
    Field('second', 'timeSec', int),
    Field('outcome', 'outcome', flag, default=True),
    Field('start_x', 'x', float),
    Field('start_y', 'y', float),
) + END_COORD_FIELDS + (
    Field('assist', 'assist', flag, default=False),
    Field('keypass', 'keyPass', flag, default=False),
)

#: One substitution out of ``liveData.substitute[]`` (MA1).
SUBSTITUTION_FIELDS: Tuple[Field, ...] = (
    Field('team_id', 'contestantId'),
    Field('period_id', 'periodId', int),
    Field('minute', 'timeMin', int),
    Field('player_in_id', 'playerOnId'),
    Field('player_out_id', 'playerOffId'),
)
