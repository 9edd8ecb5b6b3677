"""Action languages of the benchmark: the seeded draw and the plain reference of
each, one module a language, found by the name a configuration gives.

A language's ``features`` returns the feature row with its column layout: one
:class:`Block` for each run of columns that one transformer makes for one
game state, in the row's order (transformer-major, lag-major within)."""

from typing import NamedTuple, Tuple


class Block(NamedTuple):
    """Columns ``offset .. offset + width`` of a feature row: what
    transformer ``name`` makes of the game state ``lag`` actions back
    (0 for the current action, and for a transformer of the whole state),
    and whether they are a one-hot block."""

    name: str
    lag: int
    offset: int
    width: int
    onehot: bool


Layout = Tuple[Block, ...]
