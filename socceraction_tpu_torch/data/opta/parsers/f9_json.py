"""Parser for Opta F9 (match results / lineups) JSON feeds.

Parity: reference ``socceraction/data/opta/parsers/f9_json.py:9-301``.
The F9 feed holds one game's result, teams, lineups and player stats.

Port of ``socceraction_tpu/data/opta/parsers/f9_json.py``.
"""

from __future__ import annotations

from datetime import datetime
from typing import Any, Dict, List, Optional, Tuple

from ...base import MissingDataError
from .base import OptaJSONParser, assertget


def _stats_of(obj: Dict[str, Any]) -> Dict[str, Any]:
    """Collect an element's ``Stat`` children into ``{type: value}``."""
    if 'Stat' not in obj:
        return {}
    stat_list = obj['Stat'] if isinstance(obj['Stat'], list) else [obj['Stat']]
    return {s['@attributes']['Type']: s['@value'] for s in stat_list}


def _name_of(obj: Dict[str, Any]) -> Optional[str]:
    """A person's display name: the Known name, else 'First Last'."""
    if 'Known' in obj and obj['Known'].strip():
        return obj['Known']
    if 'First' in obj and 'Last' in obj and obj['Last'].strip() or obj['First'].strip():
        return (obj['First'] + ' ' + obj['Last']).strip()
    return None


class F9JSONParser(OptaJSONParser):
    """Extract game, team, player and lineup data from an F9 JSON feed."""

    def _get_doc(self) -> Dict[str, Any]:
        for node in self.root:
            if 'OptaFeed' in node['data'].keys():
                data = assertget(node, 'data')
                feed = assertget(data, 'OptaFeed')
                return assertget(feed, 'OptaDocument')[0]
        raise MissingDataError

    def extract_games(self) -> Dict[int, Dict[str, Any]]:
        """Return ``{game_id: info}``."""
        doc = self._get_doc()
        attr = assertget(doc, '@attributes')
        matchdata = assertget(doc, 'MatchData')
        competition = assertget(doc, 'Competition')
        competition_stats = _stats_of(competition)
        matchinfo = assertget(matchdata, 'MatchInfo')
        matchofficial = assertget(matchdata, 'MatchOfficial')
        matchstat = _stats_of(matchdata)
        venue = assertget(doc, 'Venue')

        game_id = int(assertget(attr, 'uID')[1:])
        record: Dict[str, Any] = dict(
            game_id=game_id,
            competition_id=int(
                assertget(assertget(competition, '@attributes'), 'uID')[1:]
            ),
            season_id=assertget(competition_stats, 'season_id'),
            game_day=competition_stats.get('matchday'),
            game_date=datetime.strptime(
                assertget(matchinfo, 'Date'), '%Y%m%dT%H%M%S%z'
            ).replace(tzinfo=None),
            duration=int(assertget(matchstat, 'match_time')),
            referee=_name_of(matchofficial['OfficialName'])
            if 'OfficialName' in matchofficial
            else None,
            venue=venue.get('Name'),
            attendance=int(matchinfo['Attendance']) if 'Attendance' in matchinfo else None,
        )
        for team in assertget(matchdata, 'TeamData'):
            team_attr = assertget(team, '@attributes')
            prefix = 'home' if assertget(team_attr, 'Side') == 'Home' else 'away'
            record[f'{prefix}_team_id'] = int(assertget(team_attr, 'TeamRef')[1:])
            record[f'{prefix}_score'] = int(assertget(team_attr, 'Score'))
            record[f'{prefix}_manager'] = (
                _name_of(team['TeamOfficial']['PersonName'])
                if 'TeamOfficial' in team
                else None
            )
        return {game_id: record}

    def extract_teams(self) -> Dict[int, Dict[str, Any]]:
        """Return ``{team_id: info}``."""
        doc = self._get_doc()
        teams = {}
        for team in assertget(doc, 'Team'):
            if 'id' in team.keys():
                team_id = int(team['id'])
                teams[team_id] = dict(
                    team_id=team_id,
                    team_name=team.get('nameObj').get('name'),
                )
        return teams

    def extract_players(self) -> Dict[Tuple[int, int], Dict[str, Any]]:
        """Return ``{(game_id, player_id): info}``."""
        doc = self._get_doc()
        attr = assertget(doc, '@attributes')
        game_id = int(assertget(attr, 'uID')[1:])
        lineups = self.extract_lineups()
        players = {}
        for team in assertget(doc, 'Team'):
            team_id = int(team['@attributes']['uID'].replace('t', ''))
            for player in team['Player']:
                player_id = int(player['@attributes']['uID'].replace('p', ''))
                assert 'nameObj' in player['PersonName']
                if player['PersonName']['nameObj'].get('is_unknown'):
                    continue
                record = dict(
                    game_id=game_id,
                    team_id=team_id,
                    player_id=player_id,
                    player_name=_name_of(player['PersonName']),
                )
                in_lineup = lineups[team_id]['players'].get(player_id)
                if in_lineup:
                    record.update(
                        jersey_number=in_lineup['jersey_number'],
                        starting_position=in_lineup['starting_position_name'],
                        is_starter=in_lineup['is_starter'],
                        minutes_played=in_lineup['minutes_played'],
                    )
                players[(game_id, player_id)] = record
        return players

    def extract_lineups(self) -> Dict[int, Dict[str, Any]]:
        """Return ``{team_id: {'players': {player_id: info}}}``."""
        doc = self._get_doc()
        try:
            teamdata = doc['MatchData']['TeamData']
        except KeyError as e:
            raise MissingDataError from e
        match_time = _stats_of(doc['MatchData'])['match_time']

        lineups: Dict[int, Dict[str, Any]] = {}
        for team in teamdata:
            team_id = int(team['@attributes']['TeamRef'].replace('t', ''))
            lineups[team_id] = dict(players=dict())
            substitutions = [s['@attributes'] for s in team['Substitution']]
            sent_off = {
                int(b['@attributes']['PlayerRef'].replace('p', '')): b['@attributes']['Time']
                for b in team.get('Booking', [])
                if 'CardType' in b['@attributes']
                and b['@attributes']['CardType'] in ('Red', 'SecondYellow')
                and 'PlayerRef' in b['@attributes']  # absent for coach cards
            }
            for player in team['PlayerLineUp']['MatchPlayer']:
                p_attr = player['@attributes']
                player_id = int(p_attr['PlayerRef'].replace('p', ''))
                player_stats = {
                    s['@attributes']['Type']: s['@value'] for s in player['Stat']
                }
                sub_on = next(
                    (
                        s['Time']
                        for s in substitutions
                        if 'Retired' not in s and s['SubOn'] == f'p{player_id}'
                    ),
                    match_time if p_attr['Status'] == 'Sub' else 0,
                )
                sub_off = next(
                    (s['Time'] for s in substitutions if s['SubOff'] == f'p{player_id}'),
                    match_time if player_id not in sent_off else sent_off[player_id],
                )
                lineups[team_id]['players'][player_id] = dict(
                    jersey_number=p_attr['ShirtNumber'],
                    starting_position_name=p_attr['Position'],
                    starting_position_id=p_attr['position_id'],
                    is_starter=p_attr['Status'] == 'Start',
                    minutes_played=sub_off - sub_on,
                    **player_stats,
                )
        return lineups

    def extract_teamgamestats(self) -> List[Dict[str, Any]]:
        """Return per-team aggregated match statistics."""
        doc = self._get_doc()
        attr = assertget(doc, '@attributes')
        game_id = int(assertget(attr, 'uID')[1:])
        try:
            teamdata = doc['MatchData']['TeamData']
        except KeyError as e:
            raise MissingDataError from e
        out = []
        for team in teamdata:
            team_attr = team['@attributes']
            out.append(
                dict(
                    game_id=game_id,
                    team_id=int(team_attr['TeamRef'].replace('t', '')),
                    side=team_attr['Side'],
                    score=team_attr['Score'],
                    shootout_score=team_attr['ShootOutScore'],
                    **_stats_of(team),
                )
            )
        return out
