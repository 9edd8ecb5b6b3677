"""Parser for Opta F24 (match events) XML feeds.

Parity: reference ``socceraction/data/opta/parsers/f24_xml.py:10-105``,
re-architected onto the declarative spec engine: the record model lives
in :mod:`.f24`; this module adapts XML elements (attribute dicts,
``Q`` children) into it.

Port of ``socceraction_tpu/data/opta/parsers/f24_xml.py``.
"""

from __future__ import annotations

from typing import Any, Dict, Tuple

from .base import OptaXMLParser, assertget
from .f24 import GAME_FIELDS, XML_EVENT_FIELDS, event_seed
from .spec import Field, extract_record, ts

#: XML-dialect game header: naive seconds-resolution stamp plus the
#: final score, which only this dialect carries.
_GAME_FIELDS = GAME_FIELDS + (
    Field('game_date', 'game_date', ts('%Y-%m-%dT%H:%M:%S')),
    Field('home_score', 'home_score', int),
    Field('away_score', 'away_score', int),
)


class F24XMLParser(OptaXMLParser):
    """Extract game and event data from an Opta F24 XML feed."""

    def extract_games(self) -> Dict[int, Dict[str, Any]]:
        """Return ``{game_id: info}``."""
        game = self.root.find('Game')
        record = extract_record(dict(game.attrib), _GAME_FIELDS)
        return {record['game_id']: record}

    def extract_events(self) -> Dict[Tuple[int, int], Dict[str, Any]]:
        """Return ``{(game_id, event_id): info}``."""
        game = self.root.find('Game')
        game_id = int(assertget(game.attrib, 'id'))
        events = {}
        for element in game.iterchildren('Event'):
            qualifiers = {
                int(q.attrib['qualifier_id']): q.attrib.get('value')
                for q in element.iterchildren('Q')
            }
            record = extract_record(
                dict(element.attrib),
                XML_EVENT_FIELDS,
                seed=event_seed(game_id, qualifiers),
            )
            events[(game_id, record['event_id'])] = record
        return events
