"""Opta event data provider.

Parity: reference ``socceraction/data/opta/__init__.py``.

Port of ``socceraction_tpu/data/opta/__init__.py``: ``eventtypes_df`` resolves when it is first
asked for, so the package imports where pandas is absent.
"""

from typing import Any

from . import loader as _loader
from .loader import OptaLoader
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

__all__ = [
    'OptaLoader',
    'eventtypes_df',
    'OptaParser',
    'F1JSONParser',
    'F7XMLParser',
    'F9JSONParser',
    'F24JSONParser',
    'F24XMLParser',
    'MA1JSONParser',
    'MA3JSONParser',
    'WhoScoredParser',
    'OptaCompetitionSchema',
    'OptaGameSchema',
    'OptaPlayerSchema',
    'OptaTeamSchema',
    'OptaEventSchema',
]


def __getattr__(name: str) -> Any:
    # ``eventtypes_df`` is built on first use (see ``loader.__getattr__``)
    if name == 'eventtypes_df':
        return _loader.eventtypes_df
    raise AttributeError(f'module {__name__!r} has no attribute {name!r}')
