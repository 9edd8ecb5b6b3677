"""Wyscout event data loaders.

Parity: reference ``socceraction/data/wyscout/loader.py:32-804``. Two
loaders share one set of frame converters:

- :class:`PublicWyscoutLoader` — the public figshare release of the
  2017/18 top-5-league + WC2018 + Euro2016 dataset (per-competition
  ``matches_*.json`` / ``events_*.json`` files plus global
  ``competitions.json`` / ``teams.json`` / ``players.json``).
- :class:`WyscoutLoader` — the Wyscout API v2 layout, remote or as local
  feed files discovered by glob patterns.

Everything here is host-side IO; the columnar pipeline starts once events
reach :func:`socceraction_tpu_torch.spadl.wyscout.convert_to_actions`.

Port of ``socceraction_tpu/data/wyscout/loader.py``: the same code, with pandas imported inside the
functions that take or build frames, so the module imports where pandas is absent.
"""

from __future__ import annotations

import glob
import os
import re
import warnings
from pathlib import Path
from typing import TYPE_CHECKING, Any, Dict, List, Optional
from urllib.parse import urlparse
from urllib.request import urlopen, urlretrieve
from zipfile import ZipFile, is_zipfile

from ..base import (
    EventDataLoader,
    MissingDataError,
    ParseError,
    _expand_minute,
    _localloadjson,
    _remoteloadjson,
)
from .schema import (
    WyscoutCompetitionSchema,
    WyscoutEventSchema,
    WyscoutGameSchema,
    WyscoutPlayerSchema,
    WyscoutTeamSchema,
)

if TYPE_CHECKING:  # pandas is imported inside the functions that take or build frames
    import pandas as pd

__all__ = ['PublicWyscoutLoader', 'WyscoutLoader']

#: Wyscout match-period code -> SPADL period id.
wyscout_periods: Dict[str, int] = {'1H': 1, '2H': 2, 'E1': 3, 'E2': 4, 'P': 5}

# The seven competitions in the public dataset release, keyed by
# (competition_id, season_id); reference ``data/wyscout/loader.py:69-122``.
_PUBLIC_DATASET_INDEX = [
    (524, 181248, '2017/2018', 'Italy'),
    (364, 181150, '2017/2018', 'England'),
    (795, 181144, '2017/2018', 'Spain'),
    (412, 181189, '2017/2018', 'France'),
    (426, 181137, '2017/2018', 'Germany'),
    (102, 9291, '2016', 'European_Championship'),
    (28, 10078, '2018', 'World_Cup'),
]

# figshare download ids for the public dataset; reference ``:124-131``.
_PUBLIC_DATASET_URLS = {
    'competitions': 'https://ndownloader.figshare.com/files/15073685',
    'teams': 'https://ndownloader.figshare.com/files/15073697',
    'players': 'https://ndownloader.figshare.com/files/15073721',
    'matches': 'https://ndownloader.figshare.com/files/14464622',
    'events': 'https://ndownloader.figshare.com/files/14464685',
}


def _country_of(area: Dict[str, Any]) -> str:
    name = area.get('name', '')
    return name if name != '' else 'International'


def _competitions_frame(competitions: List[Dict[str, Any]]) -> pd.DataFrame:
    import pandas as pd

    df = pd.DataFrame(competitions)
    return pd.DataFrame(
        {
            'competition_id': df['wyId'],
            'competition_name': df['name'],
            'country_name': df['area'].apply(_country_of),
            'competition_gender': df.get('gender', pd.Series(['male'] * len(df))),
        }
    )


def _seasons_frame(seasons: List[Dict[str, Any]]) -> pd.DataFrame:
    import pandas as pd

    df = pd.DataFrame(seasons)
    return pd.DataFrame(
        {
            'season_id': df['wyId'],
            'season_name': df['name'],
            'competition_id': df['competitionId'],
        }
    )


def _side_team_id(teams_data: Dict[Any, Any], side: str) -> int:
    for team_id, data in teams_data.items():
        if data['side'] == side:
            return int(team_id)
    raise ValueError(f'no team with side {side!r}')


def _games_frame(matches: List[Dict[str, Any]]) -> pd.DataFrame:
    import pandas as pd

    df = pd.DataFrame(matches)
    return pd.DataFrame(
        {
            'game_id': df['wyId'],
            'competition_id': df['competitionId'],
            'season_id': df['seasonId'],
            'game_date': pd.to_datetime(df['dateutc']),
            'game_day': df['gameweek'],
            'home_team_id': df['teamsData'].apply(_side_team_id, side='home'),
            'away_team_id': df['teamsData'].apply(_side_team_id, side='away'),
        }
    )


def _teams_frame(teams: List[Dict[str, Any]]) -> pd.DataFrame:
    import pandas as pd

    df = pd.DataFrame(teams)
    return pd.DataFrame(
        {
            'team_id': df['wyId'],
            'team_name_short': df['name'],
            'team_name': df['officialName'],
        }
    )


def _players_frame(players: pd.DataFrame) -> pd.DataFrame:
    import pandas as pd

    out = pd.DataFrame(
        {
            'player_id': players['wyId'],
            'nickname': players['shortName'],
            'firstname': players['firstName'],
            'lastname': players['lastName'],
            'birth_date': pd.to_datetime(players['birthDate']),
        }
    )
    out['player_name'] = out['firstname'].str.cat(out['lastname'], sep=' ')
    return out


_CAMEL_BOUNDARY = re.compile(r'(?<!^)(?=[A-Z])')


def _events_frame(raw_events: List[Dict[str, Any]]) -> pd.DataFrame:
    """Normalize raw API-v2 event dicts into the WyscoutEventSchema frame.

    In the raw feed ``eventId``/``subEventId`` are the *type* codes and
    ``id`` is the row identifier; reference ``data/wyscout/loader.py:690-734``.
    """
    import pandas as pd

    df = pd.DataFrame(raw_events)
    df.columns = [_CAMEL_BOUNDARY.sub('_', c).lower() for c in df.columns]
    type_ids = pd.to_numeric(df.get('event_id'), errors='coerce').fillna(0).astype(int)
    subtype_ids = pd.to_numeric(df.get('sub_event_id'), errors='coerce').fillna(0).astype(int)
    return pd.DataFrame(
        {
            'event_id': df['id'],
            'game_id': df['match_id'],
            'period_id': df['match_period'].map(wyscout_periods),
            'milliseconds': df['event_sec'] * 1000,
            'team_id': df['team_id'],
            'player_id': df['player_id'],
            'type_id': type_ids,
            'type_name': df['event_name'],
            'subtype_id': subtype_ids,
            'subtype_name': df['sub_event_name'].fillna(''),
            'positions': df['positions'],
            'tags': df['tags'],
        }
    )


def _minutes_played(
    teams_data: Any, events: List[Dict[str, Any]]
) -> pd.DataFrame:
    """Compute per-player minutes played from lineups + the event clock.

    Period durations are estimated as the rounded maximum event timestamp in
    each period; substitutions and red cards truncate a player's span, with
    regular-clock minutes expanded by earlier periods' injury time
    (reference ``data/wyscout/loader.py:737-801``).
    """
    import pandas as pd

    latest: Dict[int, float] = {}
    for e in events:
        pid = wyscout_periods[e['matchPeriod']]
        latest[pid] = max(latest.get(pid, 0.0), e['eventSec'])
    # Penalty shootouts (period id 5) do not count towards minutes played.
    durations = [
        round(latest[pid] / 60)
        for pid in sorted(latest)
        if pid < 5 and latest[pid] != 0
    ]
    match_minutes = sum(durations)

    if isinstance(teams_data, dict):
        teams_data = list(teams_data.values())

    rows: Dict[int, Dict[str, Any]] = {}
    for team in teams_data:
        formation = team.get('formation', {})
        team_id = team['teamId']
        # A red card caps the player's span at its (expanded) minute.
        sent_off = {
            p['playerId']: _expand_minute(int(p['redCards']), durations)
            for group in ('bench', 'lineup')
            for p in formation.get(group, [])
            if p['redCards'] != '0'
        }
        for p in formation.get('lineup', []):
            rows[p['playerId']] = {
                'team_id': team_id,
                'player_id': p['playerId'],
                'jersey_number': p.get('shirtNumber', 0),
                'minutes_played': sent_off.get(p['playerId'], match_minutes),
                'is_starter': True,
            }
        substitutions = formation.get('substitutions', [])
        if substitutions != 'null':
            bench = formation.get('bench', [])
            for sub in substitutions:
                sub_minute = _expand_minute(sub['minute'], durations)
                played = match_minutes - sub_minute
                if sub['playerIn'] in sent_off:
                    played = sent_off[sub['playerIn']] - sub_minute
                rows[sub['playerIn']] = {
                    'team_id': team_id,
                    'player_id': sub['playerIn'],
                    'jersey_number': next(
                        (
                            p.get('shirtNumber', 0)
                            for p in bench
                            if p['playerId'] == sub['playerIn']
                        ),
                        0,
                    ),
                    'minutes_played': played,
                    'is_starter': False,
                }
                if sub['playerOut'] in rows:
                    rows[sub['playerOut']]['minutes_played'] = sub_minute
    return pd.DataFrame(rows.values())


class PublicWyscoutLoader(EventDataLoader):
    """Load the public figshare release of the Wyscout dataset.

    Contains all matches of the 2017/18 season of the top-5 European
    leagues, the FIFA World Cup 2018 and the UEFA Euro 2016 (Pappalardo
    et al., Sci Data 6, 236 (2019)).

    Parameters
    ----------
    root : str, optional
        Directory holding (or receiving) a local copy of the dataset.
        Defaults to ``./wyscout_data``.
    download : bool
        Force a (re)download of the dataset archives.
    """

    def __init__(self, root: Optional[str] = None, download: bool = False) -> None:
        import pandas as pd

        if root is None:
            self.root = os.path.join(os.getcwd(), 'wyscout_data')
            os.makedirs(self.root, exist_ok=True)
        else:
            self.root = root
        self.get = _localloadjson
        if download or len(os.listdir(self.root)) == 0:
            self._download_repo()

        index = pd.DataFrame(
            [
                {
                    'competition_id': cid,
                    'season_id': sid,
                    'season_name': season,
                    'db_matches': f'matches_{name}.json',
                    'db_events': f'events_{name}.json',
                }
                for cid, sid, season, name in _PUBLIC_DATASET_INDEX
            ]
        )
        self._index = index.set_index(['competition_id', 'season_id'])
        self._match_index = self._build_match_index().set_index('match_id')

    def _download_repo(self) -> None:
        for url in _PUBLIC_DATASET_URLS.values():
            resolved = urlopen(url).geturl()
            target = os.path.join(self.root, Path(urlparse(resolved).path).name)
            local_file, _ = urlretrieve(resolved, target)
            if is_zipfile(local_file):
                with ZipFile(local_file) as zf:
                    zf.extractall(self.root)

    def _build_match_index(self) -> pd.DataFrame:
        import pandas as pd

        frames = [
            pd.DataFrame(self.get(path))
            for path in glob.iglob(os.path.join(self.root, 'matches_*.json'))
        ]
        matches = pd.concat(frames) if frames else pd.DataFrame(
            columns=['wyId', 'competitionId', 'seasonId']
        )
        matches = matches.rename(
            columns={
                'wyId': 'match_id',
                'competitionId': 'competition_id',
                'seasonId': 'season_id',
            }
        )
        return pd.merge(
            matches[['match_id', 'competition_id', 'season_id']],
            self._index,
            on=['competition_id', 'season_id'],
            how='left',
        )

    def _db_path(self, game_id: int, kind: str) -> str:
        comp_id, season_id = self._match_index.loc[
            game_id, ['competition_id', 'season_id']
        ]
        return os.path.join(self.root, self._index.at[(comp_id, season_id), kind])

    def competitions(self) -> pd.DataFrame:
        """Return all seven available competition-seasons."""
        import pandas as pd

        raw = self.get(os.path.join(self.root, 'competitions.json'))
        df = _competitions_frame(raw)
        df['competition_gender'] = 'male'
        df = pd.merge(
            df,
            self._index.reset_index()[['competition_id', 'season_id', 'season_name']],
            on='competition_id',
            how='left',
        )
        cols = [
            'competition_id',
            'season_id',
            'country_name',
            'competition_name',
            'competition_gender',
            'season_name',
        ]
        return WyscoutCompetitionSchema.validate(df[cols])

    def games(self, competition_id: int, season_id: int) -> pd.DataFrame:
        """Return all games of one competition-season."""
        path = os.path.join(
            self.root, self._index.at[(competition_id, season_id), 'db_matches']
        )
        return WyscoutGameSchema.validate(_games_frame(self.get(path)))

    def _lineups(self, game_id: int) -> List[Dict[str, Any]]:
        import pandas as pd

        matches = pd.DataFrame(
            self.get(self._db_path(game_id, 'db_matches'))
        ).set_index('wyId')
        return list(matches.at[game_id, 'teamsData'].values())

    def teams(self, game_id: int) -> pd.DataFrame:
        """Return both teams of one game."""
        import pandas as pd

        teams = pd.DataFrame(
            self.get(os.path.join(self.root, 'teams.json'))
        ).set_index('wyId')
        ids = pd.DataFrame(self._lineups(game_id))['teamId']
        selected = teams.loc[ids].reset_index()
        return WyscoutTeamSchema.validate(_teams_frame(selected.to_dict('records')))

    def players(self, game_id: int) -> pd.DataFrame:
        """Return all players that appeared in one game, with minutes played."""
        import pandas as pd

        all_players = pd.DataFrame(
            self.get(os.path.join(self.root, 'players.json'))
        ).set_index('wyId')
        lineups = self._lineups(game_id)
        per_team = []
        for team in lineups:
            squad = team['formation']['lineup']
            if team['formation']['substitutions'] != 'null':
                for sub in team['formation']['substitutions']:
                    try:
                        squad.append(
                            next(
                                p
                                for p in team['formation']['bench']
                                if p['playerId'] == sub['playerIn']
                            )
                        )
                    except StopIteration:
                        warnings.warn(
                            f'Substitute with ID={sub["playerIn"]} (minute '
                            f'{sub["minute"]}, game {game_id}) not found on the bench.'
                        )
            df = pd.DataFrame(squad)
            df['side'] = team['side']
            df['team_id'] = team['teamId']
            per_team.append(df)
        squad_df = (
            pd.concat(per_team)
            .rename(columns={'playerId': 'wyId'})
            .set_index('wyId')
            .join(all_players, how='left')
            .reset_index()
        )
        for c in ('shortName', 'lastName', 'firstName'):
            squad_df[c] = squad_df[c].apply(lambda s: s.encode().decode('unicode-escape'))
        out = _players_frame(squad_df)

        # team_id / jersey / starter flags / minutes all come from the
        # lineup-derived minutes table (reference ``loader.py:294-305``).
        events = self.get(self._db_path(game_id, 'db_events'))
        game_events = [e for e in events if e['matchId'] == game_id]
        out = pd.merge(
            out, _minutes_played(lineups, game_events), on='player_id', how='left'
        )
        out['minutes_played'] = out['minutes_played'].fillna(0).astype(int)
        out['is_starter'] = out['is_starter'].fillna(False).astype(bool)
        out['jersey_number'] = out['jersey_number'].fillna(0).astype(int)
        out['game_id'] = game_id
        return WyscoutPlayerSchema.validate(out)

    def events(self, game_id: int) -> pd.DataFrame:
        """Return the raw event stream of one game."""
        events = self.get(self._db_path(game_id, 'db_events'))
        game_events = [e for e in events if e['matchId'] == game_id]
        return WyscoutEventSchema.validate(_events_frame(game_events))


class WyscoutLoader(EventDataLoader):
    """Load Wyscout API-v2 data from the API or from local feed files.

    Parameters
    ----------
    root : str
        Root path (or API base URL) of the data.
    getter : str
        'remote' or 'local'.
    feeds : dict, optional
        Glob/format pattern per feed. Defaults depend on the getter; see
        reference ``data/wyscout/loader.py:339-356``.
    """

    _wyscout_api: str = 'https://apirest.wyscout.com/v2/'

    def __init__(
        self,
        root: str = _wyscout_api,
        getter: str = 'remote',
        feeds: Optional[Dict[str, str]] = None,
    ) -> None:
        self.root = root
        if getter == 'remote':
            self.get = _remoteloadjson
        elif getter == 'local':
            self.get = _localloadjson
        else:
            raise ValueError('Invalid getter specified')
        if feeds is not None:
            self.feeds = feeds
        elif getter == 'remote':
            self.feeds = {
                'competitions': 'competitions',
                'seasons': 'competitions/{season_id}/seasons',
                'games': 'seasons/{season_id}/matches',
                'events': 'matches/{game_id}/events',
            }
        else:
            self.feeds = {
                'competitions': 'competitions.json',
                'seasons': 'seasons_{competition_id}.json',
                'games': 'matches_{season_id}.json',
                'events': 'matches/events_{game_id}.json',
            }

    def _resolve_feed(
        self,
        feed: str,
        competition_id: Optional[int] = None,
        season_id: Optional[int] = None,
        game_id: Optional[int] = None,
    ) -> List[str]:
        pattern = self.feeds[feed].format(
            competition_id='*' if competition_id is None else competition_id,
            season_id='*' if season_id is None else season_id,
            game_id='*' if game_id is None else game_id,
        )
        if '*' in pattern:
            matches = glob.glob(os.path.join(self.root, pattern))
            if not matches:
                raise MissingDataError
            return matches
        return [pattern]

    def competitions(self) -> pd.DataFrame:
        """Return all available competitions and seasons."""
        import pandas as pd

        if 'competitions' in self.feeds:
            path = os.path.join(self.root, self._resolve_feed('competitions')[0])
            obj = self.get(path)
            if not isinstance(obj, dict) or 'competitions' not in obj:
                raise ParseError(f'{path} should contain a list of competitions')
            season_feeds = [
                self._resolve_feed('seasons', competition_id=c['wyId'])[0]
                for c in obj['competitions']
            ]
        else:
            season_feeds = self._resolve_feed('seasons')
        competitions: List[Dict[str, Any]] = []
        seasons: List[Dict[str, Any]] = []
        for feed in season_feeds:
            path = os.path.join(self.root, feed)
            try:
                obj = self.get(path)
            except FileNotFoundError:
                warnings.warn(f'File not found: {feed}')
                continue
            if not isinstance(obj, dict) or 'competition' not in obj or 'seasons' not in obj:
                raise ParseError(
                    f'{path} should contain a competition and a list of seasons'
                )
            competitions.append(obj['competition'])
            seasons.extend(s['season'] for s in obj['seasons'])
        merged = pd.merge(
            _competitions_frame(competitions),
            _seasons_frame(seasons),
            on='competition_id',
        )
        return WyscoutCompetitionSchema.validate(merged)

    def games(self, competition_id: int, season_id: int) -> pd.DataFrame:
        """Return all available games of one competition-season."""
        if 'games' in self.feeds:
            path = os.path.join(
                self.root,
                self._resolve_feed(
                    'games', competition_id=competition_id, season_id=season_id
                )[0],
            )
            obj = self.get(path)
            if not isinstance(obj, dict) or 'matches' not in obj:
                raise ParseError(f'{path} should contain a list of matches')
            detail_feeds = [
                self._resolve_feed(
                    'events',
                    competition_id=competition_id,
                    season_id=season_id,
                    game_id=g['matchId'],
                )[0]
                for g in obj['matches']
            ]
        else:
            detail_feeds = self._resolve_feed(
                'events', competition_id=competition_id, season_id=season_id
            )
        matches = []
        for feed in detail_feeds:
            path = os.path.join(self.root, feed)
            try:
                obj = self.get(path)
            except FileNotFoundError:
                warnings.warn(f'File not found: {feed}')
                continue
            if not isinstance(obj, dict) or 'match' not in obj:
                raise ParseError(f'{path} should contain a match')
            matches.append(obj['match'])
        return WyscoutGameSchema.validate(_games_frame(matches))

    def _game_feed(self, game_id: int, key: str) -> Dict[str, Any]:
        path = os.path.join(self.root, self._resolve_feed('events', game_id=game_id)[0])
        obj = self.get(path)
        if not isinstance(obj, dict) or key not in obj:
            raise ParseError(f'{path} should contain {key}')
        return obj

    def teams(self, game_id: int) -> pd.DataFrame:
        """Return both teams of one game."""
        obj = self._game_feed(game_id, 'teams')
        teams = [t['team'] for t in obj['teams'].values() if t.get('team')]
        return WyscoutTeamSchema.validate(_teams_frame(teams))

    def players(self, game_id: int) -> pd.DataFrame:
        """Return all players of one game, with minutes played."""
        import pandas as pd

        obj = self._game_feed(game_id, 'players')
        players = [
            entry['player']
            for team in obj['players'].values()
            for entry in team
            if entry.get('player')
        ]
        df = _players_frame(pd.DataFrame(players).drop_duplicates('wyId'))
        df = pd.merge(
            df,
            _minutes_played(obj['match']['teamsData'], obj['events']),
            on='player_id',
            how='right',
        )
        df['minutes_played'] = df['minutes_played'].fillna(0).astype(int)
        df['game_id'] = game_id
        return WyscoutPlayerSchema.validate(df)

    def events(self, game_id: int) -> pd.DataFrame:
        """Return the raw event stream of one game."""
        obj = self._game_feed(game_id, 'events')
        return WyscoutEventSchema.validate(_events_frame(obj['events']))
