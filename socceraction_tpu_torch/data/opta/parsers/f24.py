"""Shared field specs for the Opta F24 (match events) feed.

F24 ships in two dialects — a JSON tree and an XML document — that
describe the *same* Game/Event model (reference:
``socceraction/data/opta/parsers/f24_json.py`` and ``f24_xml.py``,
which duplicate the walk per dialect). Here the model is declared once;
the dialect modules contribute only what differs: how records are
located, the timestamp shape, and which attributes may be absent.

Port of ``socceraction_tpu/data/opta/parsers/f24.py``.
"""

from __future__ import annotations

from typing import Any, Dict, Optional, Tuple

from .base import END_COORD_FIELDS
from .spec import Field, flag, ts

__all__ = [
    'GAME_FIELDS',
    'EVENT_FIELDS',
    'JSON_EVENT_FIELDS',
    'XML_EVENT_FIELDS',
    'event_seed',
]

#: Game header, dialect-independent part. ``game_date`` differs per
#: dialect (JSON nests it under a locale key, XML stores seconds-only).
GAME_FIELDS: Tuple[Field, ...] = (
    Field('game_id', 'id', int),
    Field('season_id', 'season_id', int),
    Field('competition_id', 'competition_id', int),
    Field('game_day', 'matchday', int),
    Field('home_team_id', 'home_team_id', int),
    Field('away_team_id', 'away_team_id', int),
)


#: Event row, dialect-independent part. The seed carries ``game_id``
#: and the prebuilt qualifier dict; end coordinates derive from
#: qualifiers 140/141 (pass end), 146/147 (blocked shot) or 102
#: (goal mouth), falling back to the start point.
EVENT_FIELDS: Tuple[Field, ...] = (
    Field('event_id', 'id', int),
    Field('period_id', 'period_id', int),
    Field('team_id', 'team_id', int),
    Field('type_id', 'type_id', int),
    Field('minute', 'min', int),
    Field('second', 'sec', int),
    Field('start_x', 'x', float),
    Field('start_y', 'y', float),
) + END_COORD_FIELDS + (
    Field('assist', 'assist', flag, default=False),
    Field('keypass', 'keypass', flag, default=False),
)

#: JSON dialect: sub-second UTC stamps under a ``locale`` key; every
#: event carries a player and ``outcome`` defaults to success.
JSON_EVENT_FIELDS: Tuple[Field, ...] = EVENT_FIELDS + (
    Field('timestamp', ('TimeStamp', 'locale'), ts('%Y-%m-%dT%H:%M:%S.%fZ')),
    Field('player_id', 'player_id', int),
    Field('outcome', 'outcome', flag, default=True),
)

#: XML dialect: naive sub-second stamps; system events may omit the
#: player and the outcome, which then stay ``None``.
XML_EVENT_FIELDS: Tuple[Field, ...] = EVENT_FIELDS + (
    Field('timestamp', 'timestamp', ts('%Y-%m-%dT%H:%M:%S.%f')),
    Field('player_id', 'player_id', int, default=None),
    Field('outcome', 'outcome', flag, default=None),
)


def event_seed(
    game_id: int, qualifiers: Dict[int, Optional[str]]
) -> Dict[str, Any]:
    """Context an event record needs beyond its own attributes."""
    return {'game_id': game_id, 'qualifiers': qualifiers}
