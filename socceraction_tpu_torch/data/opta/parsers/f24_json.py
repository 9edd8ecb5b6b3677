"""Parser for Opta F24 (match events) JSON feeds.

Parity: reference ``socceraction/data/opta/parsers/f24_json.py:9-122``,
re-architected onto the declarative spec engine: the record model lives
in :mod:`.f24`, this module only locates the Game node inside the JSON
envelope and feeds its attribute dicts through the shared specs.

Port of ``socceraction_tpu/data/opta/parsers/f24_json.py``.
"""

from __future__ import annotations

from typing import Any, Dict, Tuple

from ...base import MissingDataError
from .base import OptaJSONParser, assertget
from .f24 import GAME_FIELDS, JSON_EVENT_FIELDS, event_seed
from .spec import Field, extract_record, ts

#: JSON-dialect game header: the UTC stamp nests under a locale key.
_GAME_FIELDS = GAME_FIELDS + (
    Field('game_date', ('game_date', 'locale'), ts('%Y-%m-%dT%H:%M:%S.%fZ')),
)


class F24JSONParser(OptaJSONParser):
    """Extract game and event data from an Opta F24 JSON feed."""

    def _get_game(self) -> Dict[str, Any]:
        for node in self.root:
            if 'Games' in node['data'].keys():
                data = assertget(node, 'data')
                games = assertget(data, 'Games')
                return assertget(games, 'Game')
        raise MissingDataError

    def extract_games(self) -> Dict[int, Dict[str, Any]]:
        """Return ``{game_id: info}``."""
        attr = assertget(self._get_game(), '@attributes')
        record = extract_record(attr, _GAME_FIELDS)
        return {record['game_id']: record}

    def extract_events(self) -> Dict[Tuple[int, int], Dict[str, Any]]:
        """Return ``{(game_id, event_id): info}``."""
        game = self._get_game()
        game_id = int(assertget(assertget(game, '@attributes'), 'id'))
        events = {}
        for element in assertget(game, 'Event'):
            attr = assertget(element, '@attributes')
            qualifiers = {
                int(q['@attributes']['qualifier_id']): q['@attributes']['value']
                for q in element.get('Q', [])
            }
            record = extract_record(
                attr, JSON_EVENT_FIELDS, seed=event_seed(game_id, qualifiers)
            )
            events[(game_id, record['event_id'])] = record
        return events
