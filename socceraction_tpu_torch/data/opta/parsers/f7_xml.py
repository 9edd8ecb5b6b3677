"""Parser for Opta F7 (match results / lineups) XML feeds.

Parity: reference ``socceraction/data/opta/parsers/f7_xml.py:10-245``.

Port of ``socceraction_tpu/data/opta/parsers/f7_xml.py``.
"""

from __future__ import annotations

from datetime import datetime
from typing import TYPE_CHECKING, Any, Dict, Tuple

if TYPE_CHECKING:
    from lxml import objectify

from .base import OptaXMLParser, assertget


class F7XMLParser(OptaXMLParser):
    """Extract competition, game, team and player data from an F7 XML feed."""

    def _get_doc(self) -> objectify.ObjectifiedElement:
        return self.root.find('SoccerDocument')

    def _stats_of(self, element: objectify.ObjectifiedElement) -> Dict[str, Any]:
        return {stat.attrib['Type']: stat.text for stat in element.find('Stat')}

    def _name_of(self, element: objectify.ObjectifiedElement) -> str:
        if 'Known' in element:
            return element.Known
        return element.First + ' ' + element.Last

    def extract_competitions(self) -> Dict[Tuple[int, int], Dict[str, Any]]:
        """Return ``{(competition_id, season_id): info}``."""
        doc = self._get_doc()
        competition = doc.Competition
        competition_id = int(competition.attrib['uID'][1:])
        stats = self._stats_of(competition)
        season_id = int(assertget(stats, 'season_id'))
        return {
            (competition_id, season_id): dict(
                competition_id=competition_id,
                season_id=season_id,
                season_name=assertget(stats, 'season_name'),
                competition_name=competition.Name.text,
            )
        }

    def extract_games(self) -> Dict[int, Dict[str, Any]]:
        """Return ``{game_id: info}``."""
        doc = self._get_doc()
        competition = doc.Competition
        competition_stats = self._stats_of(competition)
        match_info = doc.MatchData.MatchInfo
        match_stats = self._stats_of(doc.MatchData)
        game_id = int(doc.attrib['uID'][1:])
        sides = {t.attrib['Side']: t for t in doc.MatchData.iterchildren('TeamData')}
        home_ref = int(sides['Home'].attrib['TeamRef'][1:])
        managers = {}
        for team in doc.iterchildren('Team'):
            side = 'Home' if home_ref == int(team.attrib['uID'][1:]) else 'Away'
            for official in team.iterchildren('TeamOfficial'):
                if official.attrib['Type'] == 'Manager':
                    managers[side] = self._name_of(official.PersonName)
        return {
            game_id: dict(
                game_id=game_id,
                season_id=int(assertget(competition_stats, 'season_id')),
                competition_id=int(competition.attrib['uID'][1:]),
                game_day=int(competition_stats['matchday'])
                if 'matchday' in competition_stats
                else None,
                game_date=datetime.strptime(
                    match_info.Date.text, '%Y%m%dT%H%M%S%z'
                ).replace(tzinfo=None),
                home_team_id=home_ref,
                away_team_id=int(sides['Away'].attrib['TeamRef'][1:]),
                home_score=int(sides['Home'].attrib['Score']),
                away_score=int(sides['Away'].attrib['Score']),
                duration=int(match_stats['match_time']),
                referee=self._name_of(doc.MatchData.MatchOfficial.OfficialName),
                venue=doc.Venue.Name.text,
                attendance=int(match_info.Attendance),
                home_manager=managers.get('Home'),
                away_manager=managers.get('Away'),
            )
        }

    def extract_teams(self) -> Dict[int, Dict[str, Any]]:
        """Return ``{team_id: info}``."""
        doc = self._get_doc()
        teams = {}
        for team in doc.iterchildren('Team'):
            team_id = int(assertget(team.attrib, 'uID')[1:])
            teams[team_id] = dict(team_id=team_id, team_name=team.Name.text)
        return teams

    def extract_lineups(self) -> Dict[int, Dict[str, Any]]:
        """Return per-team lineup info incl. per-player minutes played."""
        doc = self._get_doc()
        match_stats = self._stats_of(doc.MatchData)
        lineups: Dict[int, Dict[str, Any]] = {}
        for team in doc.MatchData.iterchildren('TeamData'):
            team_id = int(team.attrib['TeamRef'][1:])
            lineups[team_id] = dict(
                formation=team.attrib['Formation'],
                score=int(team.attrib['Score']),
                side=team.attrib['Side'],
                players=dict(),
            )
            substitutions = [s.attrib for s in team.iterchildren('Substitution')]
            sent_off = {
                int(b.attrib['PlayerRef'][1:]): int(b.attrib['Min'])
                for b in team.iterchildren('Booking')
                if 'CardType' in b.attrib
                and b.attrib['CardType'] in ('Red', 'SecondYellow')
                and 'PlayerRef' in b.attrib  # absent for coach cards
            }
            for player in team.PlayerLineUp.iterchildren('MatchPlayer'):
                player_id = int(player.attrib['PlayerRef'][1:])
                sub_on = int(
                    next(
                        (
                            s['Time']
                            for s in substitutions
                            if 'Retired' not in s and s['SubOn'] == f'p{player_id}'
                        ),
                        match_stats['match_time']
                        if player.attrib['Status'] == 'Sub'
                        else 0,
                    )
                )
                sub_off = int(
                    next(
                        (s['Time'] for s in substitutions if s['SubOff'] == f'p{player_id}'),
                        match_stats['match_time']
                        if player_id not in sent_off
                        else sent_off[player_id],
                    )
                )
                lineups[team_id]['players'][player_id] = dict(
                    starting_position_id=int(player.attrib['Formation_Place']),
                    starting_position_name=player.attrib['Position'],
                    jersey_number=int(player.attrib['ShirtNumber']),
                    is_starter=int(player.attrib['Formation_Place']) != 0,
                    minutes_played=sub_off - sub_on,
                )
        return lineups

    def extract_players(self) -> Dict[Tuple[int, int], Dict[str, Any]]:
        """Return ``{(game_id, player_id): info}``."""
        doc = self._get_doc()
        game_id = int(doc.attrib['uID'][1:])
        lineups = self.extract_lineups()
        players = {}
        for team in doc.iterchildren('Team'):
            team_id = int(team.attrib['uID'][1:])
            for player in team.iterchildren('Player'):
                player_id = int(player.attrib['uID'][1:])
                entry = lineups[team_id]['players'][player_id]
                players[(game_id, player_id)] = dict(
                    game_id=game_id,
                    team_id=team_id,
                    player_id=player_id,
                    player_name=self._name_of(player.PersonName),
                    is_starter=entry['is_starter'],
                    minutes_played=entry['minutes_played'],
                    jersey_number=entry['jersey_number'],
                    starting_position=entry['starting_position_name'],
                )
        return players
