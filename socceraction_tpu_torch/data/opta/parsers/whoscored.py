"""Parser for JSON match-centre data scraped from WhoScored.

Parity: reference ``socceraction/data/opta/parsers/whoscored.py:17-418``.
WhoScored republishes Opta data; ids for competition/season/game are not
always embedded and can be supplied from the file path instead.

Port of ``socceraction_tpu/data/opta/parsers/whoscored.py``.
"""

from __future__ import annotations

import json
from datetime import datetime, timedelta
from typing import Any, Dict, Optional, Tuple

from ...base import MissingDataError, _snake
from .base import OptaParser, _get_end_x, _get_end_y, assertget
from .spec import Field, derived, extract_record, ts


class WhoScoredParser(OptaParser):
    """Extract data from a WhoScored match-centre JSON file.

    Parameters
    ----------
    path : str
        Path of the data file.
    competition_id, season_id, game_id : int, optional
        Ids of the data file's scope; read from same-named JSON fields when
        not given.
    """

    def __init__(
        self,
        path: str,
        competition_id: Optional[int] = None,
        season_id: Optional[int] = None,
        game_id: Optional[int] = None,
    ) -> None:
        with open(path, encoding='utf-8') as fh:
            self.root = json.load(fh)
        for name, value in (
            ('competition_id', competition_id),
            ('season_id', season_id),
            ('game_id', game_id),
        ):
            if value is None:
                try:
                    value = int(assertget(self.root, name))
                except AssertionError as e:
                    raise MissingDataError(
                        f'Could not determine the {name}. Add it to the file '
                        f"path or include a field '{name}' in the JSON."
                    ) from e
            setattr(self, name, value)

    def _period_id(self, event: Dict[str, Any]) -> int:
        return int(assertget(assertget(event, 'period'), 'value'))

    def _period_milliseconds(self, event: Dict[str, Any]) -> int:
        period_id = self._period_id(event)
        if period_id in (14, 16):  # post-game / pre-match
            return 0
        limits = assertget(self.root, 'periodMinuteLimits')
        minute = int(assertget(event, 'minute'))
        period_minute = minute
        if period_id > 1:
            period_minute = minute - limits[str(period_id - 1)]
        return (period_minute * 60 + int(event.get('second', 0))) * 1000

    #: Game header straight off the match-centre root; scope ids come in
    #: via the seed (path-supplied when not embedded in the JSON).
    _GAME_FIELDS = (
        Field('game_date', 'startTime', ts('%Y-%m-%dT%H:%M:%S')),
        Field('home_team_id', ('home', 'teamId'), int),
        Field('away_team_id', ('away', 'teamId'), int),
        Field('home_score', ('home', 'scores', 'running'), int),
        Field('away_score', ('away', 'scores', 'running'), int),
        Field('duration', 'expandedMaxMinute', int, default=None),
        Field('referee', ('referee', 'name'), default=None),
        Field('venue', 'venueName', default=None),
        Field('attendance', 'attendance', int, default=None),
        Field('home_manager', ('home', 'managerName'), default=None),
        Field('away_manager', ('away', 'managerName'), default=None),
    )

    _TEAM_FIELDS = (
        Field('team_id', 'teamId', int),
        Field('team_name', 'name'),
    )

    def extract_games(self) -> Dict[int, Dict[str, Any]]:
        """Return ``{game_id: info}``."""
        record = extract_record(
            self.root,
            self._GAME_FIELDS,
            seed={
                'game_id': self.game_id,
                'season_id': self.season_id,
                'competition_id': self.competition_id,
                'game_day': None,  # not in the data stream
            },
        )
        return {self.game_id: record}

    def extract_teams(self) -> Dict[int, Dict[str, Any]]:
        """Return ``{team_id: info}``."""
        records = [
            extract_record(self.root[side], self._TEAM_FIELDS)
            for side in ('home', 'away')
        ]
        return {r['team_id']: r for r in records}

    def extract_players(self) -> Dict[Tuple[int, int], Dict[str, Any]]:
        """Return ``{(game_id, player_id): info}``."""
        gamestats = self.extract_playergamestats()
        players = {}
        for team in (self.root['home'], self.root['away']):
            team_id = int(assertget(team, 'teamId'))
            for p in team['players']:
                player_id = int(assertget(p, 'playerId'))
                stats = gamestats[(self.game_id, player_id)]
                players[(self.game_id, player_id)] = dict(
                    game_id=self.game_id,
                    team_id=team_id,
                    player_id=player_id,
                    player_name=assertget(p, 'name'),
                    is_starter=bool(p.get('isFirstEleven', False)),
                    minutes_played=stats['minutes_played'],
                    jersey_number=stats['jersey_number'],
                    starting_position=stats['position_code'],
                )
        return players

    def _event_fields(self, time_start: datetime) -> Tuple[Field, ...]:
        """Event spec; closures carry feed-wide context (kickoff, periods)."""
        return (
            # Scraped files disagree on the id key's name.
            derived(
                'event_id',
                lambda rec, raw: int(
                    assertget(raw, 'id' if 'id' in raw else 'eventId')
                ),
            ),
            derived('period_id', lambda rec, raw: self._period_id(raw)),
            Field('team_id', 'teamId', int),
            Field('player_id', 'playerId', int, default=None),
            Field('type_id', ('type', 'value'), int),
            Field('minute', 'expandedMinute', int),
            Field('second', 'second', int, default=0),
            # No true timestamp in the stream; reconstructed from the
            # kickoff time for compatibility with other Opta feeds.
            derived(
                'timestamp',
                lambda rec, raw: time_start
                + timedelta(seconds=rec['minute'] * 60 + rec['second']),
            ),
            derived(
                'outcome',
                lambda rec, raw: bool(raw['outcomeType'].get('value'))
                if 'outcomeType' in raw
                else None,
            ),
            Field('start_x', 'x', float),
            Field('start_y', 'y', float),
            # The stream's own end point wins over the qualifier-derived one.
            derived(
                'end_x',
                lambda rec, raw: raw.get('endX')
                or _get_end_x(rec['qualifiers'])
                or rec['start_x'],
            ),
            derived(
                'end_y',
                lambda rec, raw: raw.get('endY')
                or _get_end_y(rec['qualifiers'])
                or rec['start_y'],
            ),
            Field('related_player_id', 'relatedPlayerId', int, default=None),
            Field('touch', 'isTouch', bool, default=False),
            # NOTE: shot/goal are intentionally crossed to reproduce the
            # reference's mapping (``parsers/whoscored.py:240-241``);
            # downstream SPADL conversion keys off type_id, not these.
            Field('shot', 'isGoal', bool, default=False),
            Field('goal', 'isShot', bool, default=False),
        )

    def extract_events(self) -> Dict[Tuple[int, int], Dict[str, Any]]:
        """Return ``{(game_id, event_id): info}``."""
        time_start = datetime.strptime(
            assertget(self.root, 'startTime'), '%Y-%m-%dT%H:%M:%S'
        )
        fields = self._event_fields(time_start)
        events = {}
        for attr in self.root['events']:
            qualifiers = {
                int(q['type']['value']): q.get('value', True)
                for q in attr.get('qualifiers', [])
            }
            record = extract_record(
                attr,
                fields,
                seed={'game_id': self.game_id, 'qualifiers': qualifiers},
            )
            events[(self.game_id, record['event_id'])] = record
        return events

    def extract_substitutions(self) -> Dict[Tuple[int, int], Dict[str, Any]]:
        """Return ``{(game_id, player_in_id): info}`` for substitutions."""
        subs = {}
        for e in self.root['events']:
            if e['type'].get('value') != 19:
                continue
            sub_id = int(assertget(e, 'playerId'))
            subs[(self.game_id, sub_id)] = dict(
                game_id=self.game_id,
                team_id=int(assertget(e, 'teamId')),
                period_id=self._period_id(e),
                period_milliseconds=self._period_milliseconds(e),
                player_in_id=int(assertget(e, 'playerId')),
                player_out_id=int(assertget(e, 'relatedPlayerId')),
            )
        return subs

    def extract_positions(self) -> Dict[Tuple[int, int, int], Dict[str, Any]]:
        """Return each player's position per formation epoch."""
        positions = {}
        period_end_minutes = assertget(self.root, 'periodEndMinutes')
        period_minute_limits = assertget(self.root, 'periodMinuteLimits')
        for team in (self.root['home'], self.root['away']):
            team_id = int(assertget(team, 'teamId'))
            for formation in assertget(team, 'formations'):
                slots = assertget(formation, 'formationPositions')
                player_ids = assertget(formation, 'playerIds')
                scheme = assertget(formation, 'formationName')
                start_minute = int(assertget(formation, 'startMinuteExpanded'))
                end_minute = int(assertget(formation, 'endMinuteExpanded'))
                for period_id in sorted(period_end_minutes.keys()):
                    if period_end_minutes[period_id] > start_minute:
                        break
                period_id = int(period_id)
                period_minute = start_minute
                if period_id > 1:
                    period_minute = start_minute - period_minute_limits[str(period_id - 1)]
                for i, slot in enumerate(slots):
                    player_id = int(player_ids[i])
                    x = float(assertget(slot, 'vertical'))
                    y = float(assertget(slot, 'horizontal'))
                    positions[(self.game_id, player_id, start_minute)] = dict(
                        game_id=self.game_id,
                        team_id=team_id,
                        player_id=player_id,
                        period_id=period_id,
                        period_milliseconds=period_minute * 60 * 1000,
                        start_milliseconds=start_minute * 60 * 1000,
                        end_milliseconds=end_minute * 60 * 1000,
                        formation_scheme=scheme,
                        player_position='GK' if x == 0 and y == 5 else 'Unknown',
                        player_position_x=x,
                        player_position_y=y,
                    )
        return positions

    def extract_teamgamestats(self) -> Dict[Tuple[int, int], Dict[str, Any]]:
        """Return per-team aggregated game statistics."""
        out = {}
        for team in (self.root['home'], self.root['away']):
            team_id = int(assertget(team, 'teamId'))
            stats = {
                _snake(name): sum(value.values())
                for name, value in team['stats'].items()
                if isinstance(value, dict)
            }
            scores = assertget(team, 'scores')
            out[(self.game_id, team_id)] = dict(
                game_id=self.game_id,
                team_id=team_id,
                side=assertget(team, 'field'),
                score=assertget(scores, 'fulltime'),
                shootout_score=scores.get('penalty'),
                **{k: v for k, v in stats.items() if not k.endswith('Success')},
            )
        return out

    def extract_playergamestats(self) -> Dict[Tuple[int, int], Dict[str, Any]]:
        """Return per-player aggregated game statistics incl. minutes."""
        out = {}
        for team in (self.root['home'], self.root['away']):
            team_id = int(assertget(team, 'teamId'))
            sent_off = {
                e['playerId']: e['expandedMinute']
                for e in team.get('incidentEvents', [])
                if 'cardType' in e
                and e['cardType']['displayName'] in ('Red', 'SecondYellow')
                and 'playerId' in e  # absent for coach cards
            }
            for player in team['players']:
                stats = {
                    _snake(name): sum(stat.values())
                    for name, stat in player['stats'].items()
                }
                player_id = int(assertget(player, 'playerId'))
                p = dict(
                    game_id=self.game_id,
                    team_id=team_id,
                    player_id=player_id,
                    is_starter=bool(player.get('isFirstEleven', False)),
                    position_code=player.get('position', None),
                    jersey_number=int(player.get('shirtNo', 0)),
                    mvp=bool(player.get('isManOfTheMatch', False)),
                    **{k: v for k, v in stats.items() if not k.endswith('success')},
                )
                if 'subbedInExpandedMinute' in player:
                    p['minute_start'] = player['subbedInExpandedMinute']
                if 'subbedOutExpandedMinute' in player:
                    p['minute_end'] = player['subbedOutExpandedMinute']
                if player_id in sent_off:
                    p['minute_end'] = sent_off[player_id]

                full_time = self.root.get('expandedMaxMinute')
                p['minutes_played'] = 0
                if p['is_starter'] and 'minute_end' not in p:
                    p['minute_start'] = 0
                    p['minute_end'] = full_time
                    p['minutes_played'] = full_time
                elif p['is_starter']:
                    p['minute_start'] = 0
                    p['minutes_played'] = p['minute_end']
                elif 'minute_start' in p and 'minute_end' not in p:
                    p['minute_end'] = full_time
                    p['minutes_played'] = full_time - p['minute_start']
                elif 'minute_start' in p:
                    p['minutes_played'] = p['minute_end'] - p['minute_start']
                out[(self.game_id, player_id)] = p
        return out
