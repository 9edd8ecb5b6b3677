"""Opta event data loader.

Parity: reference ``socceraction/data/opta/loader.py:204-465``. Feeds are
discovered by glob patterns with ``{competition_id}/{season_id}/{game_id}``
placeholders; each matching file is handed to the feed's parser and the
per-id dictionaries of all feeds are deep-merged (Opta spreads one game's
data over complementary files).

Port of ``socceraction_tpu/data/opta/loader.py``: the same code, with pandas imported inside the
functions that take or build frames and ``eventtypes_df`` built when it is first asked for, so the
module imports where pandas is absent.
"""

from __future__ import annotations

import copy
import datetime
import glob
import os
import re
import warnings
from typing import TYPE_CHECKING, Any, Dict, Mapping, Optional, Type, Union

from ..base import EventDataLoader
from .parsers import (
    F1JSONParser,
    F7XMLParser,
    F9JSONParser,
    F24JSONParser,
    F24XMLParser,
    MA1JSONParser,
    MA3JSONParser,
    OptaParser,
    WhoScoredParser,
)
from .schema import (
    OptaCompetitionSchema,
    OptaEventSchema,
    OptaGameSchema,
    OptaPlayerSchema,
    OptaTeamSchema,
)

if TYPE_CHECKING:  # pandas is imported inside the functions that take or build frames
    import pandas as pd

__all__ = ['OptaLoader']

_PARSER_SETS: Dict[str, Mapping[str, Type[OptaParser]]] = {
    'json': {
        'f1': F1JSONParser,
        'f9': F9JSONParser,
        'f24': F24JSONParser,
        'ma1': MA1JSONParser,
        'ma3': MA3JSONParser,
    },
    'xml': {'f7': F7XMLParser, 'f24': F24XMLParser},
    'statsperform': {'ma1': MA1JSONParser, 'ma3': MA3JSONParser},
    'whoscored': {'whoscored': WhoScoredParser},
}

_DEFAULT_FEEDS: Dict[str, Dict[str, str]] = {
    'json': {
        'f1': 'f7-{competition_id}-{season_id}-{game_id}.json',
        'f9': 'f7-{competition_id}-{season_id}-{game_id}.json',
        'f24': 'f24-{competition_id}-{season_id}-{game_id}.json',
    },
    'xml': {
        'f7': 'f7-{competition_id}-{season_id}-{game_id}.json',
        'f24': 'f24-{competition_id}-{season_id}-{game_id}.json',
    },
    'statsperform': {
        'ma1': 'ma1-{competition_id}-{season_id}.json',
        'ma3': 'ma3-{competition_id}-{season_id}-{game_id}.json',
    },
    'whoscored': {
        'whoscored': '{competition_id}-{season_id}-{game_id}.json',
    },
}

#: Opta event type id → name (reference ``data/opta/loader.py:56-144``).
_EVENT_TYPES = [
    (1, 'pass'), (2, 'offside pass'), (3, 'take on'), (4, 'foul'),
    (5, 'out'), (6, 'corner awarded'), (7, 'tackle'), (8, 'interception'),
    (9, 'turnover'), (10, 'save'), (11, 'claim'), (12, 'clearance'),
    (13, 'miss'), (14, 'post'), (15, 'attempt saved'), (16, 'goal'),
    (17, 'card'), (18, 'player off'), (19, 'player on'),
    (20, 'player retired'), (21, 'player returns'),
    (22, 'player becomes goalkeeper'), (23, 'goalkeeper becomes player'),
    (24, 'condition change'), (25, 'official change'), (26, 'unknown26'),
    (27, 'start delay'), (28, 'end delay'), (29, 'unknown29'), (30, 'end'),
    (31, 'unknown31'), (32, 'start'), (33, 'unknown33'), (34, 'team set up'),
    (35, 'player changed position'), (36, 'player changed jersey number'),
    (37, 'collection end'), (38, 'temp_goal'), (39, 'temp_attempt'),
    (40, 'formation change'), (41, 'punch'), (42, 'good skill'),
    (43, 'deleted event'), (44, 'aerial'), (45, 'challenge'),
    (46, 'unknown46'), (47, 'rescinded card'), (48, 'unknown46'),
    (49, 'ball recovery'), (50, 'dispossessed'), (51, 'error'),
    (52, 'keeper pick-up'), (53, 'cross not claimed'), (54, 'smother'),
    (55, 'offside provoked'), (56, 'shield ball opp'), (57, 'foul throw in'),
    (58, 'penalty faced'), (59, 'keeper sweeper'), (60, 'chance missed'),
    (61, 'ball touch'), (62, 'unknown62'), (63, 'temp_save'), (64, 'resume'),
    (65, 'contentious referee decision'), (66, 'possession data'),
    (67, '50/50'), (68, 'referee drop ball'), (69, 'failed to block'),
    (70, 'injury time announcement'), (71, 'coach setup'),
    (72, 'caught offside'), (73, 'other ball contact'), (74, 'blocked pass'),
    (75, 'delayed start'), (76, 'early end'), (77, 'player off pitch'),
    (78, 'temp card'), (79, 'coverage interruption'), (80, 'drop of ball'),
    (81, 'obstacle'), (83, 'attempted tackle'), (84, 'deleted after review'),
    (10000, 'offside given'),  # WhoScored-specific
]



def _eventtypes_df() -> pd.DataFrame:
    """The ``type_id``/``type_name`` frame of :data:`_EVENT_TYPES`, built on first use."""
    frame = globals().get('eventtypes_df')
    if frame is None:
        import pandas as pd

        frame = pd.DataFrame(_EVENT_TYPES, columns=['type_id', 'type_name'])
        globals()['eventtypes_df'] = frame
    return frame


def __getattr__(name: str) -> Any:
    # ``eventtypes_df`` is a frame: the module builds it when it is first
    # asked for, so that it imports where pandas is absent
    if name == 'eventtypes_df':
        return _eventtypes_df()
    raise AttributeError(f'module {__name__!r} has no attribute {name!r}')


def _deepupdate(target: Dict[Any, Any], src: Dict[Any, Any]) -> None:
    """Deep-merge ``src`` into ``target`` (lists extend, dicts recurse)."""
    for k, v in src.items():
        if isinstance(v, list):
            if k not in target:
                target[k] = copy.deepcopy(v)
            else:
                target[k].extend(v)
        elif isinstance(v, dict):
            if k not in target:
                target[k] = copy.deepcopy(v)
            else:
                _deepupdate(target[k], v)
        elif isinstance(v, set):
            if k not in target:
                target[k] = v.copy()
            else:
                target[k].update(v.copy())
        else:
            target[k] = copy.copy(v)


def _extract_ids_from_path(path: str, pattern: str) -> Dict[str, Union[str, int]]:
    """Recover the id placeholders of a feed pattern from a concrete path."""
    regex = re.compile(
        '.+?'
        + re.escape(pattern)
        .replace(r'\{competition_id\}', r'(?P<competition_id>[a-zA-Z0-9-_ ]+)')
        .replace(r'\{season_id\}', r'(?P<season_id>[a-zA-Z0-9-_ ]+)')
        .replace(r'\{game_id\}', r'(?P<game_id>[a-zA-Z0-9-_ ]+)')
    )
    m = re.match(regex, path)
    if m is None:
        raise ValueError(f'The filepath {path} does not match the format {pattern}.')
    return {k: int(v) if v.isdigit() else v for k, v in m.groupdict().items()}


class OptaLoader(EventDataLoader):
    """Load Opta data from a local folder.

    Parameters
    ----------
    root : str
        Root path of the data.
    parser : str or dict
        'xml' (F7+F24), 'json' (F1+F9+F24), 'statsperform' (MA1+MA3),
        'whoscored', or a mapping of feed name to a custom
        :class:`~socceraction_tpu_torch.data.opta.parsers.OptaParser` subclass.
    feeds : dict, optional
        Glob pattern per feed, with ``{competition_id}``, ``{season_id}``
        and ``{game_id}`` placeholders.

    Raises
    ------
    ValueError
        If an invalid parser is provided.
    """

    def __init__(
        self,
        root: str,
        parser: Union[str, Mapping[str, Type[OptaParser]]] = 'xml',
        feeds: Optional[Dict[str, str]] = None,
    ) -> None:
        self.root = root
        if isinstance(parser, str):
            if parser not in _PARSER_SETS:
                raise ValueError('Invalid parser provided.')
            if feeds is None:
                feeds = dict(_DEFAULT_FEEDS[parser])
            self.parsers = self._select_parsers(_PARSER_SETS[parser], feeds)
        elif isinstance(parser, dict):
            if feeds is None:
                raise ValueError('You must specify a feed for each parser.')
            self.parsers = self._select_parsers(parser, feeds)
        else:
            raise ValueError('Invalid parser provided.')
        self.feeds = feeds

    @staticmethod
    def _select_parsers(
        available: Mapping[str, Type[OptaParser]], feeds: Dict[str, str]
    ) -> Mapping[str, Type[OptaParser]]:
        parsers = {}
        for feed in feeds:
            if feed in available:
                parsers[feed] = available[feed]
            else:
                warnings.warn(
                    f'No parser available for {feed} feeds. This feed is ignored.'
                )
        return parsers

    def _collect(
        self,
        extractor: str,
        competition_id: Any = '*',
        season_id: Any = '*',
        game_id: Any = '*',
    ) -> Dict[Any, Dict[str, Any]]:
        """Run one ``extract_*`` method over every matching feed file."""
        data: Dict[Any, Dict[str, Any]] = {}
        for feed, feed_pattern in self.feeds.items():
            glob_pattern = feed_pattern.format(
                competition_id=competition_id, season_id=season_id, game_id=game_id
            )
            for path in glob.glob(os.path.join(self.root, glob_pattern)):
                ids = _extract_ids_from_path(path, feed_pattern)
                parser = self.parsers[feed](path, **ids)
                _deepupdate(data, getattr(parser, extractor)())
        return data

    def competitions(self) -> pd.DataFrame:
        """Return all available competitions and seasons."""
        import pandas as pd

        data = self._collect('extract_competitions')
        return OptaCompetitionSchema.validate(pd.DataFrame(list(data.values())))

    def games(self, competition_id: int, season_id: int) -> pd.DataFrame:
        """Return all available games of one competition-season."""
        import pandas as pd

        data = self._collect(
            'extract_games', competition_id=competition_id, season_id=season_id
        )
        return OptaGameSchema.validate(pd.DataFrame(list(data.values())))

    def teams(self, game_id: int) -> pd.DataFrame:
        """Return both teams of one game."""
        import pandas as pd

        data = self._collect('extract_teams', game_id=game_id)
        return OptaTeamSchema.validate(pd.DataFrame(list(data.values())))

    def players(self, game_id: int) -> pd.DataFrame:
        """Return all players of one game."""
        import pandas as pd

        data = self._collect('extract_players', game_id=game_id)
        df = pd.DataFrame(list(data.values()))
        df['game_id'] = game_id
        return OptaPlayerSchema.validate(df)

    def events(self, game_id: int) -> pd.DataFrame:
        """Return the event stream of one game, cleaned and ordered."""
        import pandas as pd

        data = self._collect('extract_events', game_id=game_id)
        events = (
            pd.DataFrame(list(data.values()))
            .merge(_eventtypes_df(), on='type_id', how='left')
            .sort_values(['game_id', 'period_id', 'minute', 'second', 'timestamp'])
            .reset_index(drop=True)
        )
        # pre-match events can carry negative seconds
        events.loc[events['second'] < 0, 'second'] = 0
        events = events.sort_values(
            ['game_id', 'period_id', 'minute', 'second', 'timestamp']
        )
        # drop deleted events (type 43) and rows with corrupt datetimes
        # (negated form keeps NaT timestamps, matching the reference filter)
        events = events[events['type_id'] != 43]
        events = events[
            ~(
                (events['timestamp'] < datetime.datetime(1900, 1, 1))
                | (events['timestamp'] > datetime.datetime(2100, 1, 1))
            )
        ]
        return OptaEventSchema.validate(events)
