"""StatsBomb event data loader.

Parity: reference ``socceraction/data/statsbomb/loader.py:39-503``.
Supports the open-data local directory layout (``competitions.json``,
``matches/<comp>/<season>.json``, ``lineups/<game>.json``,
``events/<game>.json``, ``three-sixty/<game>.json``) and remote access via
the optional ``statsbombpy`` package.

Port of ``socceraction_tpu/data/statsbomb/loader.py``: the same code, with pandas imported inside the functions
that take or build frames, so the module imports where pandas is absent.
"""

from __future__ import annotations

import os
import warnings
from typing import TYPE_CHECKING, Any, Dict, List, Optional


try:
    from statsbombpy import api_client, sb

    def _quiet_has_auth(creds: Dict[str, str]) -> bool:
        """Suppress statsbombpy's repeated no-auth print messages."""
        if creds.get('user') in [None, ''] or creds.get('passwd') in [None, '']:
            warnings.warn('credentials were not supplied. open data access only')
            return False
        return True

    api_client.has_auth = _quiet_has_auth
except ImportError:  # pragma: no cover
    sb = None

from ..base import EventDataLoader, ParseError, _expand_minute, _localloadjson
from .schema import (
    StatsBombCompetitionSchema,
    StatsBombEventSchema,
    StatsBombGameSchema,
    StatsBombPlayerSchema,
    StatsBombTeamSchema,
)

if TYPE_CHECKING:  # pandas is imported inside the functions that take or build frames
    import pandas as pd

__all__ = ['StatsBombLoader', 'extract_player_games']


class StatsBombLoader(EventDataLoader):
    """Load StatsBomb data from the open-data directory layout or the API.

    Parameters
    ----------
    getter : str
        'remote' (requires ``statsbombpy``) or 'local'.
    root : str, optional
        Root path of the data (required for 'local').
    creds : dict, optional
        ``{'user': ..., 'passwd': ...}`` API credentials ('remote' only).
    """

    def __init__(
        self,
        getter: str = 'remote',
        root: Optional[str] = None,
        creds: Optional[Dict[str, str]] = None,
    ) -> None:
        if getter == 'remote':
            if sb is None:
                raise ImportError(
                    "The 'statsbombpy' package is required for remote access."
                )
            self._creds = creds or sb.DEFAULT_CREDS
            self._local = False
        elif getter == 'local':
            if root is None:
                raise ValueError(
                    "The 'root' parameter is required when loading local data."
                )
            self._local = True
            self._root = root
        else:
            raise ValueError('Invalid getter specified')

    def competitions(self) -> pd.DataFrame:
        """Return all available competitions and seasons."""
        import pandas as pd

        cols = [
            'season_id',
            'competition_id',
            'competition_name',
            'country_name',
            'competition_gender',
            'season_name',
        ]
        if self._local:
            obj = _localloadjson(os.path.join(self._root, 'competitions.json'))
        else:
            obj = list(sb.competitions(fmt='dict', creds=self._creds).values())
        if not isinstance(obj, list):
            raise ParseError('The retrieved data should contain a list of competitions')
        if len(obj) == 0:
            return pd.DataFrame(columns=cols)
        return StatsBombCompetitionSchema.validate(pd.DataFrame(obj)[cols])

    def games(self, competition_id: int, season_id: int) -> pd.DataFrame:
        """Return all available games of a season."""
        import pandas as pd

        cols = [
            'game_id',
            'season_id',
            'competition_id',
            'competition_stage',
            'game_day',
            'game_date',
            'home_team_id',
            'away_team_id',
            'home_score',
            'away_score',
            'venue',
            'referee',
        ]
        if self._local:
            obj = _localloadjson(
                os.path.join(self._root, f'matches/{competition_id}/{season_id}.json')
            )
        else:
            obj = list(
                sb.matches(competition_id, season_id, fmt='dict', creds=self._creds).values()
            )
        if not isinstance(obj, list):
            raise ParseError('The retrieved data should contain a list of games')
        if len(obj) == 0:
            return pd.DataFrame(columns=cols)
        games = pd.DataFrame(_flatten(m) for m in obj)
        games['kick_off'] = games['kick_off'].fillna('12:00:00.000')
        games['match_date'] = pd.to_datetime(
            games[['match_date', 'kick_off']].agg(' '.join, axis=1)
        )
        games = games.rename(
            columns={
                'match_id': 'game_id',
                'match_date': 'game_date',
                'match_week': 'game_day',
                'stadium_name': 'venue',
                'referee_name': 'referee',
                'competition_stage_name': 'competition_stage',
            }
        )
        for optional in ('venue', 'referee'):
            if optional not in games:
                games[optional] = None
        return StatsBombGameSchema.validate(games[cols])

    def _lineups(self, game_id: int) -> List[Dict[str, Any]]:
        if self._local:
            obj = _localloadjson(os.path.join(self._root, f'lineups/{game_id}.json'))
        else:
            obj = list(sb.lineups(game_id, fmt='dict', creds=self._creds).values())
        if not isinstance(obj, list):
            raise ParseError('The retrieved data should contain a list of teams')
        if len(obj) != 2:
            raise ParseError('The retrieved data should contain two teams')
        return obj

    def teams(self, game_id: int) -> pd.DataFrame:
        """Return both teams of a game."""
        import pandas as pd

        obj = self._lineups(game_id)
        return StatsBombTeamSchema.validate(
            pd.DataFrame(obj)[['team_id', 'team_name']]
        )

    def players(self, game_id: int) -> pd.DataFrame:
        """Return all players that appeared in a game, with minutes played."""
        import pandas as pd

        cols = [
            'game_id',
            'team_id',
            'player_id',
            'player_name',
            'nickname',
            'jersey_number',
            'is_starter',
            'starting_position_id',
            'starting_position_name',
            'minutes_played',
        ]
        obj = self._lineups(game_id)
        players = pd.DataFrame(
            _flatten_id(p) for lineup in obj for p in lineup['lineup']
        )
        player_games = extract_player_games(self.events(game_id))
        players = pd.merge(
            players,
            player_games[
                ['player_id', 'team_id', 'position_id', 'position_name', 'minutes_played']
            ],
            on='player_id',
        )
        players['game_id'] = game_id
        players['position_name'] = players['position_name'].replace(0, 'Substitute')
        players['position_id'] = players['position_id'].fillna(0).astype(int)
        players['is_starter'] = players['position_id'] != 0
        players = players.rename(
            columns={
                'player_nickname': 'nickname',
                'country_name': 'country',
                'position_id': 'starting_position_id',
                'position_name': 'starting_position_name',
            }
        )
        return StatsBombPlayerSchema.validate(players[cols])

    def events(self, game_id: int, load_360: bool = False) -> pd.DataFrame:
        """Return the event stream of a game.

        Parameters
        ----------
        game_id : int
            The ID of the game.
        load_360 : bool
            Whether to merge StatsBomb 360 freeze frames into the events.
        """
        import pandas as pd

        cols = [
            'game_id',
            'event_id',
            'period_id',
            'team_id',
            'player_id',
            'type_id',
            'type_name',
            'index',
            'timestamp',
            'minute',
            'second',
            'possession',
            'possession_team_id',
            'possession_team_name',
            'play_pattern_id',
            'play_pattern_name',
            'team_name',
            'duration',
            'extra',
            'related_events',
            'player_name',
            'position_id',
            'position_name',
            'location',
            'under_pressure',
            'counterpress',
        ]
        if self._local:
            obj = _localloadjson(os.path.join(self._root, f'events/{game_id}.json'))
        else:
            obj = list(sb.events(game_id, fmt='dict', creds=self._creds).values())
        if not isinstance(obj, list):
            raise ParseError('The retrieved data should contain a list of events')
        if len(obj) == 0:
            return pd.DataFrame(columns=cols)

        events = pd.DataFrame(_flatten_id(e) for e in obj)
        events['match_id'] = game_id
        events['timestamp'] = pd.to_datetime(events['timestamp'], format='%H:%M:%S.%f')
        # not every game/event carries the optional fields
        for optional in (
            'related_events',
            'player_id',
            'player_name',
            'position_id',
            'position_name',
            'location',
            'duration',
        ):
            if optional not in events:
                events[optional] = None
        events['related_events'] = events['related_events'].apply(
            lambda d: d if isinstance(d, list) else []
        )
        for flag in ('under_pressure', 'counterpress'):
            if flag not in events:
                events[flag] = False
            events[flag] = events[flag].fillna(False).astype(bool)
        events = events.rename(
            columns={'id': 'event_id', 'period': 'period_id', 'match_id': 'game_id'}
        )
        if not load_360:
            return StatsBombEventSchema.validate(events[cols])

        cols_360 = ['visible_area_360', 'freeze_frame_360']
        if self._local:
            obj = _localloadjson(os.path.join(self._root, f'three-sixty/{game_id}.json'))
        else:
            obj = sb.frames(game_id, fmt='dict', creds=self._creds)
        if not isinstance(obj, list):
            raise ParseError('The retrieved data should contain a list of frames')
        if len(obj) == 0:
            events['visible_area_360'] = None
            events['freeze_frame_360'] = None
            return StatsBombEventSchema.validate(events[cols + cols_360])
        frames = pd.DataFrame(obj).rename(
            columns={
                'event_uuid': 'event_id',
                'visible_area': 'visible_area_360',
                'freeze_frame': 'freeze_frame_360',
            }
        )[['event_id', 'visible_area_360', 'freeze_frame_360']]
        merged = pd.merge(events, frames, on='event_id', how='left')
        return StatsBombEventSchema.validate(merged[cols + cols_360])


def extract_player_games(events: pd.DataFrame) -> pd.DataFrame:
    """Compute per-player minutes played from a game's events.

    Handles substitutions and red cards (incl. second yellows), expanding
    minutes with the injury time of earlier periods; shoot-outs contribute
    no minutes. Parity: reference ``statsbomb/loader.py:379-473``.
    """
    import pandas as pd

    periods_regular = pd.DataFrame(
        [
            {'period_id': 1, 'minute': 45},
            {'period_id': 2, 'minute': 45},
            {'period_id': 3, 'minute': 15},
            {'period_id': 4, 'minute': 15},
        ]
    ).set_index('period_id')
    periods_minutes = (
        events.loc[events['type_name'] == 'Half End', ['period_id', 'minute']]
        .drop_duplicates()
        .set_index('period_id')
        .sort_index()
        .subtract(periods_regular.cumsum().shift(1).fillna(0))
        .minute.dropna()
        .astype(int)
        .tolist()
    )
    game_minutes = sum(periods_minutes)

    game_id = events['game_id'].mode().values[0]
    players: Dict[Any, Dict[str, Any]] = {}

    red_cards = events[
        events.apply(
            lambda x: any(
                e in x.extra
                and 'card' in x.extra[e]
                and x.extra[e]['card']['name'] in ['Second Yellow', 'Red Card']
                for e in ['foul_committed', 'bad_behaviour']
            ),
            axis=1,
        )
    ]

    def _minutes_until_red(player_id: Any, default: int) -> int:
        card = red_cards[red_cards['player_id'] == player_id]
        if len(card) > 0:
            return _expand_minute(int(card.iloc[0]['minute']), periods_minutes)
        return default

    for startxi in events[events['type_name'] == 'Starting XI'].itertuples():
        team_id, team_name = startxi.team_id, startxi.team_name
        for player in startxi.extra['tactics']['lineup']:
            player = _flatten_id(player)
            player.update(
                game_id=game_id,
                team_id=team_id,
                team_name=team_name,
                minutes_played=_minutes_until_red(player['player_id'], game_minutes),
            )
            players[player['player_id']] = player

    for sub in events[events['type_name'] == 'Substitution'].itertuples():
        exp_sub_minute = _expand_minute(int(sub.minute), periods_minutes)
        replacement_id = sub.extra['substitution']['replacement']['id']
        players[replacement_id] = {
            'player_id': replacement_id,
            'player_name': sub.extra['substitution']['replacement']['name'],
            'minutes_played': _minutes_until_red(replacement_id, game_minutes)
            - exp_sub_minute,
            'team_id': sub.team_id,
            'game_id': game_id,
            'team_name': sub.team_name,
        }
        players[sub.player_id]['minutes_played'] = exp_sub_minute

    pg = pd.DataFrame(players.values()).fillna(0)
    for col in pg.columns:
        if '_id' in col:
            pg[col] = pg[col].astype(int)
    return pg


def _flatten_id(d: Dict[str, Any]) -> Dict[str, Any]:
    """Flatten ``{'id', 'name'}`` sub-dicts to ``*_id``/``*_name`` columns.

    Remaining dict-valued entries are collected into an ``extra`` dict
    column (reference ``statsbomb/loader.py:475-488``).
    """
    newd: Dict[str, Any] = {}
    extra: Dict[str, Any] = {}
    for k, v in d.items():
        if isinstance(v, dict):
            if 'id' in v and 'name' in v:
                newd[k + '_id'] = v['id']
                newd[k + '_name'] = v['name']
            else:
                extra[k] = v
        else:
            newd[k] = v
    newd['extra'] = extra
    return newd


def _flatten(d: Dict[str, Any]) -> Dict[str, Any]:
    """Recursively flatten nested dicts (match metadata records)."""
    newd: Dict[str, Any] = {}
    for k, v in d.items():
        if isinstance(v, dict):
            if 'id' in v and 'name' in v:
                newd[k + '_id'] = v['id']
                newd[k + '_name'] = v['name']
                newd[k + '_extra'] = {
                    l: w for (l, w) in v.items() if l not in ('id', 'name')
                }
            else:
                newd = {**newd, **_flatten(v)}
        else:
            newd[k] = v
    return newd
