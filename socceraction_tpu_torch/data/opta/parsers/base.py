"""Base classes and helpers for Opta(-derived) feed parsers.

Parity: reference ``socceraction/data/opta/parsers/base.py:15-179``. A
parser wraps a single feed file and exposes ``extract_*`` methods that
return id-keyed dictionaries; the loader deep-merges the dictionaries of
all configured feeds (Opta data is spread over complementary files).

Port of ``socceraction_tpu/data/opta/parsers/base.py``.
"""

from __future__ import annotations

import json
from abc import ABC
from typing import Any, Dict, List, Optional, Tuple

from .spec import derived

__all__ = [
    'OptaParser',
    'OptaJSONParser',
    'OptaXMLParser',
    'assertget',
]


class OptaParser(ABC):
    """Extract data from one Opta data-stream file.

    Parameters
    ----------
    path : str
        Path of the data file.
    """

    def __init__(self, path: str, **kwargs: Any) -> None:
        raise NotImplementedError

    def extract_competitions(self) -> Dict[Tuple[Any, Any], Dict[str, Any]]:
        """Return ``{(competition_id, season_id): info}`` for all competitions."""
        return {}

    def extract_games(self) -> Dict[Any, Dict[str, Any]]:
        """Return ``{game_id: info}`` for all games."""
        return {}

    def extract_teams(self) -> Dict[Any, Dict[str, Any]]:
        """Return ``{team_id: info}`` for all teams."""
        return {}

    def extract_players(self) -> Dict[Tuple[Any, Any], Dict[str, Any]]:
        """Return ``{(game_id, player_id): info}`` for all players."""
        return {}

    def extract_lineups(self) -> Dict[Any, Dict[str, Any]]:
        """Return ``{team_id: lineup info}`` for each team."""
        return {}

    def extract_events(self) -> Dict[Tuple[Any, Any], Dict[str, Any]]:
        """Return ``{(game_id, event_id): info}`` for all events."""
        return {}


class OptaJSONParser(OptaParser):
    """Parser backed by a JSON feed file."""

    def __init__(self, path: str, **kwargs: Any) -> None:
        with open(path, encoding='utf-8') as fh:
            self.root = json.load(fh)


class OptaXMLParser(OptaParser):
    """Parser backed by an XML feed file."""

    def __init__(self, path: str, **kwargs: Any) -> None:
        # lxml is an optional dependency (the 'io' extra): only the XML
        # feeds (F7/F24) need it, so JSON-only installs must still import
        # this package.
        from lxml import objectify

        with open(path, 'rb') as fh:
            self.root = objectify.fromstring(fh.read())


def assertget(dictionary: Dict[str, Any], key: str) -> Any:
    """Return ``dictionary[key]``, raising AssertionError when absent."""
    value = dictionary.get(key)
    assert value is not None, 'KeyError: ' + key + ' not found in ' + str(dictionary)
    return value


def _team_on_side(contestants: List[Dict[str, Any]], side: str) -> Optional[str]:
    """Return the id of the contestant on ``side`` ('home'/'away')."""
    from ...base import MissingDataError

    for team in contestants:
        if assertget(team, 'position') == side:
            return assertget(team, 'id')
    raise MissingDataError


# Qualifier ids carrying end coordinates: 140/141 pass end point, 146/147
# blocked-shot location, 102 goal-mouth y (the x is then the goal line).
def _get_end_x(qualifiers: Dict[int, Any]) -> Optional[float]:
    try:
        if 140 in qualifiers:
            return float(qualifiers[140])
        if 146 in qualifiers:
            return float(qualifiers[146])
        if 102 in qualifiers:
            return 100.0
        return None
    except ValueError:
        return None


def _get_end_y(qualifiers: Dict[int, Any]) -> Optional[float]:
    try:
        if 141 in qualifiers:
            return float(qualifiers[141])
        if 147 in qualifiers:
            return float(qualifiers[147])
        if 102 in qualifiers:
            return float(qualifiers[102])
        return None
    except ValueError:
        return None


def _derive_end_x(record: Dict[str, Any], raw: Any) -> float:
    return _get_end_x(record['qualifiers']) or record['start_x']


def _derive_end_y(record: Dict[str, Any], raw: Any) -> float:
    return _get_end_y(record['qualifiers']) or record['start_y']


#: Spec fragment shared by every event feed: end coordinates derived
#: from the qualifier dict (seeded by the parser), start-point fallback.
END_COORD_FIELDS = (
    derived('end_x', _derive_end_x),
    derived('end_y', _derive_end_y),
)


