"""Parser for Stats Perform MA1 (fixtures / lineups) JSON feeds.

Parity: reference ``socceraction/data/opta/parsers/ma1_json.py:9-263``.
MA1 feeds use string ids and carry fixtures plus (optionally) live lineup
and card data.

Port of ``socceraction_tpu/data/opta/parsers/ma1_json.py``.
"""

from __future__ import annotations

from datetime import datetime
from typing import Any, Dict, List, Optional, Tuple

from ...base import MissingDataError
from .base import OptaJSONParser, _team_on_side, assertget
from .spec import extract_record
from .statsperform import COMPETITION_FIELDS, SUBSTITUTION_FIELDS, TEAM_FIELDS


def _person_name(obj: Dict[str, Any]) -> Optional[str]:
    if 'name' in obj:
        return assertget(obj, 'name')
    if 'firstName' in obj:
        return f"{assertget(obj, 'firstName')} {assertget(obj, 'lastName')}"
    return None


class MA1JSONParser(OptaJSONParser):
    """Extract fixture, team and player data from an MA1 JSON feed."""

    def _get_matches(self) -> List[Dict[str, Any]]:
        if 'matchInfo' in self.root:
            return [self.root]
        if 'match' in self.root:
            return self.root['match']
        raise MissingDataError

    @staticmethod
    def _match_info(match: Dict[str, Any]) -> Dict[str, Any]:
        if 'matchInfo' in match:
            return match['matchInfo']
        raise MissingDataError

    @staticmethod
    def _live_data(match: Dict[str, Any]) -> Dict[str, Any]:
        return match.get('liveData', {})

    def extract_competitions(self) -> Dict[Tuple[str, str], Dict[str, Any]]:
        """Return ``{(competition_id, season_id): info}``."""
        competitions = {}
        for match in self._get_matches():
            record = extract_record(self._match_info(match), COMPETITION_FIELDS)
            competitions[(record['competition_id'], record['season_id'])] = record
        return competitions

    def extract_games(self) -> Dict[str, Dict[str, Any]]:
        """Return ``{game_id: info}``."""
        games = {}
        for match in self._get_matches():
            info = self._match_info(match)
            game_id = assertget(info, 'id')
            venue = assertget(info, 'venue')
            contestants = assertget(info, 'contestant')
            game_datetime = f"{assertget(info, 'date')} {assertget(info, 'time')}"
            games[game_id] = dict(
                game_id=game_id,
                competition_id=assertget(assertget(info, 'competition'), 'id'),
                season_id=assertget(assertget(info, 'tournamentCalendar'), 'id'),
                game_day=int(info['week']) if 'week' in info else None,
                game_date=datetime.strptime(game_datetime, '%Y-%m-%dZ %H:%M:%SZ'),
                home_team_id=_team_on_side(contestants, 'home'),
                away_team_id=_team_on_side(contestants, 'away'),
                venue=venue.get('shortName'),
            )
            live = self._live_data(match)
            details = live.get('matchDetails')
            if details is not None:
                if 'matchLengthMin' in details:
                    games[game_id]['duration'] = details['matchLengthMin']
                if 'scores' in details:
                    totals = assertget(assertget(details, 'scores'), 'total')
                    games[game_id]['home_score'] = totals['home']
                    games[game_id]['away_score'] = totals['away']
                extra = live.get('matchDetailsExtra')
                if extra is not None:
                    if 'attendance' in extra:
                        games[game_id]['attendance'] = int(extra['attendance'])
                    for official in extra.get('matchOfficial', []):
                        if official['type'] == 'Main':
                            games[game_id]['referee'] = _person_name(official)
        return games

    def extract_teams(self) -> Dict[str, Dict[str, Any]]:
        """Return ``{team_id: info}``."""
        teams = {}
        for match in self._get_matches():
            info = self._match_info(match)
            for contestant in assertget(info, 'contestant'):
                record = extract_record(contestant, TEAM_FIELDS)
                teams[record['team_id']] = record
        return teams

    def extract_players(self) -> Dict[Tuple[str, str], Dict[str, Any]]:
        """Return ``{(game_id, player_id): info}``."""
        players: Dict[Tuple[str, str], Dict[str, Any]] = {}
        subs = self.extract_substitutions()
        for match in self._get_matches():
            info = self._match_info(match)
            game_id = assertget(info, 'id')
            live = self._live_data(match)
            if 'lineUp' not in live:
                continue
            sent_off = {
                c['playerId']: c['timeMin']
                for c in live.get('card', [])
                if c.get('type') in ('Y2C', 'RC') and 'playerId' in c
            }
            for lineup in assertget(live, 'lineUp'):
                team_id = assertget(lineup, 'contestantId')
                for individual in assertget(lineup, 'player'):
                    player_id = assertget(individual, 'playerId')
                    is_starter = assertget(individual, 'position') != 'Substitute'
                    players[(game_id, player_id)] = dict(
                        game_id=game_id,
                        team_id=team_id,
                        player_id=player_id,
                        player_name=_person_name(individual),
                        is_starter=is_starter,
                        jersey_number=assertget(individual, 'shirtNumber'),
                        starting_position=assertget(individual, 'position'),
                    )
                    if 'matchDetails' not in live or 'substitute' not in live:
                        continue
                    details = assertget(live, 'matchDetails')
                    if 'matchLengthMin' not in details:
                        continue
                    duration = assertget(details, 'matchLengthMin')
                    sub_in = [
                        s
                        for s in subs.values()
                        if s['game_id'] == game_id and s['player_in_id'] == player_id
                    ]
                    sub_out = [
                        s
                        for s in subs.values()
                        if s['game_id'] == game_id and s['player_out_id'] == player_id
                    ]
                    minute_start: Optional[int]
                    if is_starter:
                        minute_start = 0
                    elif len(sub_in) == 1:
                        minute_start = sub_in[0]['minute']
                    else:
                        minute_start = None
                    minute_end = duration
                    if len(sub_out) == 1:
                        minute_end = sub_out[0]['minute']
                    elif player_id in sent_off:
                        minute_end = sent_off[player_id]
                    if is_starter or minute_start is not None:
                        players[(game_id, player_id)]['minutes_played'] = (
                            minute_end - minute_start
                        )
                    else:
                        players[(game_id, player_id)]['minutes_played'] = 0
        return players

    def extract_substitutions(self) -> Dict[Tuple[Any, Any], Dict[str, Any]]:
        """Return ``{(game_id, player_on_id): info}`` for all substitutions."""
        subs = {}
        for match in self._get_matches():
            info = self._match_info(match)
            game_id = assertget(info, 'id')
            live = self._live_data(match)
            for e in live.get('substitute', []):
                record = extract_record(
                    e, SUBSTITUTION_FIELDS, seed={'game_id': game_id}
                )
                subs[(game_id, record['player_in_id'])] = record
        return subs
