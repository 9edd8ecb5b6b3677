"""Parser for Opta F1 (fixtures) JSON feeds.

Parity: reference ``socceraction/data/opta/parsers/f1_json.py:9-102``,
on the declarative spec engine: the competition header and fixture core
are spec tables; only the per-side TeamData fold stays imperative.

Port of ``socceraction_tpu/data/opta/parsers/f1_json.py``.
"""

from __future__ import annotations

from typing import Any, Dict, Tuple

from ...base import MissingDataError
from .base import OptaJSONParser, assertget
from .spec import Field, extract_record, ref_id, ts

#: Competition/season header out of the OptaDocument attributes. The
#: season's display name is just its id rendered as text.
_COMPETITION_FIELDS = (
    Field('season_id', 'season_id', int),
    Field('season_name', 'season_id', str),
    Field('competition_id', 'competition_id', int),
    Field('competition_name', 'competition_name'),
)

#: Fixture core out of a MatchData node; home/away columns are folded
#: in afterwards from the TeamData children.
_GAME_FIELDS = (
    Field('game_id', ('@attributes', 'uID'), ref_id),
    Field('game_day', ('MatchInfo', '@attributes', 'MatchDay'), int),
    Field('game_date', ('MatchInfo', 'Date'), ts('%Y-%m-%d %H:%M:%S')),
)


class F1JSONParser(OptaJSONParser):
    """Extract competition and fixture data from an Opta F1 JSON feed."""

    def _get_doc(self) -> Dict[str, Any]:
        for node in self.root:
            if 'OptaFeed' in node['data'].keys():
                data = assertget(node, 'data')
                feed = assertget(data, 'OptaFeed')
                return assertget(feed, 'OptaDocument')
        raise MissingDataError

    def extract_competitions(self) -> Dict[Tuple[int, int], Dict[str, Any]]:
        """Return ``{(competition_id, season_id): info}``."""
        attr = assertget(self._get_doc(), '@attributes')
        record = extract_record(attr, _COMPETITION_FIELDS)
        return {(record['competition_id'], record['season_id']): record}

    def extract_games(self) -> Dict[int, Dict[str, Any]]:
        """Return ``{game_id: info}`` for every fixture in the feed."""
        doc = self._get_doc()
        attr = assertget(doc, '@attributes')
        context = {
            'competition_id': int(assertget(attr, 'competition_id')),
            'season_id': int(assertget(attr, 'season_id')),
        }
        games = {}
        for match in assertget(doc, 'MatchData'):
            record = extract_record(match, _GAME_FIELDS, seed=context)
            for team in assertget(match, 'TeamData'):
                team_attr = assertget(team, '@attributes')
                prefix = 'home' if assertget(team_attr, 'Side') == 'Home' else 'away'
                record[f'{prefix}_team_id'] = ref_id(assertget(team_attr, 'TeamRef'))
                record[f'{prefix}_score'] = int(assertget(team_attr, 'Score'))
            games[record['game_id']] = record
        return games
