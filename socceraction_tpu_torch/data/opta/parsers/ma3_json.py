"""Parser for Stats Perform MA3 (match events) JSON feeds.

Parity: reference ``socceraction/data/opta/parsers/ma3_json.py:11-364``.
MA3 feeds carry one game's event stream; lineups are encoded as
"team set up" events (type 34) whose qualifiers hold parallel id lists.

Port of ``socceraction_tpu/data/opta/parsers/ma3_json.py``: the same code, with pandas imported inside the
functions that take or build frames, so the module imports where pandas is absent.
"""

from __future__ import annotations

from datetime import datetime
from typing import Any, Dict, List, Tuple

from ...base import MissingDataError
from .base import OptaJSONParser, _team_on_side, assertget
from .spec import extract_record
from .statsperform import COMPETITION_FIELDS, EVENT_FIELDS, TEAM_FIELDS

_POSITIONS = {
    1: 'Goalkeeper',
    2: 'Defender',
    3: 'Midfielder',
    4: 'Forward',
    5: 'Substitute',
}


class MA3JSONParser(OptaJSONParser):
    """Extract game, team, player and event data from an MA3 JSON feed."""

    def _match_info(self) -> Dict[str, Any]:
        if 'matchInfo' in self.root:
            return self.root['matchInfo']
        raise MissingDataError

    def _live_data(self) -> Dict[str, Any]:
        if 'liveData' in self.root:
            return self.root['liveData']
        raise MissingDataError

    def extract_competitions(self) -> Dict[Tuple[str, str], Dict[str, Any]]:
        """Return ``{(competition_id, season_id): info}``."""
        record = extract_record(self._match_info(), COMPETITION_FIELDS)
        return {(record['competition_id'], record['season_id']): record}

    def extract_games(self) -> Dict[str, Dict[str, Any]]:
        """Return ``{game_id: info}``."""
        info = self._match_info()
        live = self._live_data()
        game_id = assertget(info, 'id')
        contestants = assertget(info, 'contestant')
        details = assertget(live, 'matchDetails')
        score_total = assertget(assertget(details, 'scores'), 'total')
        home_score = away_score = None
        if isinstance(score_total, dict):
            home_score = assertget(score_total, 'home')
            away_score = assertget(score_total, 'away')
        game_datetime = (
            f"{assertget(info, 'date')[0:10]}T{assertget(info, 'time')[0:8]}"
        )
        return {
            game_id: dict(
                game_id=game_id,
                season_id=assertget(assertget(info, 'tournamentCalendar'), 'id'),
                competition_id=assertget(assertget(info, 'competition'), 'id'),
                game_day=int(assertget(info, 'week')),
                game_date=datetime.strptime(game_datetime, '%Y-%m-%dT%H:%M:%S'),
                home_team_id=_team_on_side(contestants, 'home'),
                away_team_id=_team_on_side(contestants, 'away'),
                home_score=home_score,
                away_score=away_score,
                duration=assertget(details, 'matchLengthMin'),
                venue=assertget(assertget(info, 'venue'), 'shortName'),
            )
        }

    def extract_teams(self) -> Dict[str, Dict[str, Any]]:
        """Return ``{team_id: info}``."""
        info = self._match_info()
        records = [
            extract_record(c, TEAM_FIELDS) for c in assertget(info, 'contestant')
        ]
        return {r['team_id']: r for r in records}

    def extract_players(self) -> Dict[Tuple[str, str], Dict[str, Any]]:
        """Return ``{(game_id, player_id): info}`` (players with minutes > 0).

        Lineups come from the type-34 "team set up" events: qualifier 30
        lists player ids, 44 starting positions, 131 formation slots and 59
        jersey numbers, all as comma-separated parallel lists.
        """
        import pandas as pd

        info = self._match_info()
        game_id = assertget(info, 'id')
        live = self._live_data()
        events = assertget(live, 'event')

        duration = self._extract_duration()
        names: Dict[str, str] = {}
        columns: Dict[str, List[Any]] = {
            'starting_position_id': [],
            'player_id': [],
            'team_id': [],
            'position_in_formation': [],
            'jersey_number': [],
        }
        sent_off: Dict[str, int] = {}
        for event in events:
            type_id = assertget(event, 'typeId')
            if type_id == 34:
                team_id = assertget(event, 'contestantId')
                for q in assertget(event, 'qualifier'):
                    qualifier_id = assertget(q, 'qualifierId')
                    values = assertget(q, 'value').split(', ')
                    if qualifier_id == 30:
                        columns['player_id'] += values
                        columns['team_id'] += [team_id] * len(values)
                    elif qualifier_id == 44:
                        columns['starting_position_id'] += [int(v) for v in values]
                    elif qualifier_id == 131:
                        columns['position_in_formation'] += [int(v) for v in values]
                    elif qualifier_id == 59:
                        columns['jersey_number'] += [int(v) for v in values]
            elif type_id == 17 and 'playerId' in event:
                for q in assertget(event, 'qualifier'):
                    if assertget(q, 'qualifierId') in (32, 33):
                        sent_off[event['playerId']] = event['timeMin']
            player_id = event.get('playerId')
            if player_id is not None and player_id not in names:
                names[player_id] = assertget(event, 'playerName')

        roster = pd.DataFrame.from_dict(columns)

        subs = pd.DataFrame(
            list(self.extract_substitutions().values()),
            columns=['player_id', 'team_id', 'minute_start', 'minute_end'],
        )
        subs = subs.groupby(['player_id', 'team_id']).max().reset_index()
        subs['minute_start'] = subs['minute_start'].fillna(0)
        subs['minute_end'] = subs['minute_end'].fillna(duration)
        if subs.empty:
            roster['minute_start'] = 0
            roster['minute_end'] = duration
        else:
            roster = roster.merge(subs, on=['team_id', 'player_id'], how='left')
        roster['minute_end'] = roster.apply(
            lambda row: sent_off.get(row['player_id'], row['minute_end']), axis=1
        )
        roster['is_starter'] = roster['position_in_formation'] > 0
        starter_rows = roster['is_starter']
        roster.loc[starter_rows & roster['minute_start'].isnull(), 'minute_start'] = 0
        roster.loc[starter_rows & roster['minute_end'].isnull(), 'minute_end'] = duration
        roster['minutes_played'] = (
            (roster['minute_end'] - roster['minute_start']).fillna(0).astype(int)
        )

        players = {}
        for _, row in roster.iterrows():
            if row.minutes_played > 0:
                players[(game_id, row.player_id)] = dict(
                    game_id=game_id,
                    team_id=row.team_id,
                    player_id=row.player_id,
                    player_name=names[row.player_id],
                    is_starter=row.is_starter,
                    minutes_played=row.minutes_played,
                    jersey_number=row.jersey_number,
                    starting_position=_POSITIONS.get(
                        row.starting_position_id, 'Unknown'
                    ),
                )
        return players

    def extract_events(self) -> Dict[Tuple[str, int], Dict[str, Any]]:
        """Return ``{(game_id, event_id): info}``."""
        info = self._match_info()
        live = self._live_data()
        game_id = assertget(info, 'id')
        events = {}
        for element in assertget(live, 'event'):
            qualifiers = {
                int(q['qualifierId']): q.get('value')
                for q in element.get('qualifier', [])
            }
            record = extract_record(
                element,
                EVENT_FIELDS,
                seed={'game_id': game_id, 'qualifiers': qualifiers},
            )
            events[(game_id, record['event_id'])] = record
        return events

    def extract_substitutions(self) -> Dict[Any, Dict[str, Any]]:
        """Return per-player substitution windows from type 18/19 events."""
        live = self._live_data()
        subs: Dict[Any, Dict[str, Any]] = {}
        for e in assertget(live, 'event'):
            type_id = assertget(e, 'typeId')
            if type_id in (18, 19):
                sub_id = assertget(e, 'playerId')
                record = {
                    'player_id': sub_id,
                    'team_id': assertget(e, 'contestantId'),
                }
                if type_id == 18:
                    record['minute_end'] = assertget(e, 'timeMin')
                else:
                    record['minute_start'] = assertget(e, 'timeMin')
                subs[sub_id] = record
        return subs

    def _extract_duration(self) -> int:
        live = self._live_data()
        duration = 90
        for event in assertget(live, 'event'):
            if assertget(event, 'typeId') == 30:
                for q in assertget(event, 'qualifier'):
                    if assertget(q, 'qualifierId') == 209:
                        duration = max(duration, assertget(event, 'timeMin'))
        return duration
