"""Base class and utilities shared by all event-stream data loaders.

Parity: reference ``socceraction/data/base.py`` — the 5-method
``EventDataLoader`` ABC (``:82-168``), the JSON getters (``:24-55``), the
injury-time ``_expand_minute`` helper (``:57-79``) and the exception types
(``:16-21``).

Port of ``socceraction_tpu/data/base.py``: the same code, with pandas imported inside the functions
that take or build frames, so the module imports where pandas is absent.
"""

from __future__ import annotations

import json
import re
from abc import ABC, abstractmethod
from typing import TYPE_CHECKING, Any, Dict, List, Union
from urllib.request import urlopen

if TYPE_CHECKING:  # pandas is imported inside the functions that take or build frames
    import pandas as pd


JSONType = Union[str, int, float, bool, None, Dict[str, Any], List[Any]]

__all__ = [
    'EventDataLoader',
    'ParseError',
    'MissingDataError',
    'JSONType',
]


class ParseError(Exception):
    """Raised when a data file is not correctly formatted."""


class MissingDataError(Exception):
    """Raised when a field is missing in the input data."""


def _snake(name: str) -> str:
    """camelCase / PascalCase -> snake_case (shared by the feed parsers)."""
    step = re.sub('(.)([A-Z][a-z]+)', r'\1_\2', name)
    return re.sub('([a-z0-9])([A-Z])', r'\1_\2', step).lower()


def _remoteloadjson(path: str) -> JSONType:
    """Load JSON data from a URL."""
    return json.loads(urlopen(path).read())


def _localloadjson(path: str) -> JSONType:
    """Load JSON data from a local file path."""
    with open(path, encoding='utf-8') as fh:
        return json.load(fh)


def _expand_minute(minute: int, periods_duration: List[int]) -> int:
    """Expand a game-clock minute with the injury time of earlier periods.

    Parameters
    ----------
    minute : int
        Timestamp in regular-clock minutes.
    periods_duration : list of int
        Actual duration of each period in minutes (including injury time).
    """
    expanded_minute = minute
    periods_regular = [45, 45, 15, 15, 0]
    for period in range(len(periods_duration) - 1):
        if minute > sum(periods_regular[: period + 1]):
            expanded_minute += periods_duration[period] - periods_regular[period]
        else:
            break
    return expanded_minute


class EventDataLoader(ABC):
    """Load event data from a remote location or a local folder.

    Every provider implements five methods, each returning a
    schema-validated DataFrame (see :mod:`socceraction_tpu_torch.data.schema`).
    """

    @abstractmethod
    def competitions(self) -> pd.DataFrame:
        """Return all available competitions and seasons."""

    @abstractmethod
    def games(self, competition_id: int, season_id: int) -> pd.DataFrame:
        """Return all available games in a season."""

    @abstractmethod
    def teams(self, game_id: int) -> pd.DataFrame:
        """Return both teams that participated in a game."""

    @abstractmethod
    def players(self, game_id: int) -> pd.DataFrame:
        """Return all players that participated in a game."""

    @abstractmethod
    def events(self, game_id: int) -> pd.DataFrame:
        """Return the event stream of a game."""
