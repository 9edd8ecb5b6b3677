"""Player-level aggregation of action values.

Port of ``socceraction_tpu/ratings.py``. The reference ships this only as
notebook code (``public-notebooks/4-compute-vaep-values-and-top-players.ipynb``:
per-player sums of VAEP values, minutes-played normalization to a per-90
rating and a minimum-minutes cut); here it is library API. pandas is
imported inside the function.
"""

from __future__ import annotations

from typing import TYPE_CHECKING, Optional

import numpy as np

if TYPE_CHECKING:
    import pandas as pd

__all__ = ['player_ratings']

_VALUE_COLS = ['vaep_value', 'offensive_value', 'defensive_value']


def player_ratings(
    rated_actions: 'pd.DataFrame',
    players: Optional['pd.DataFrame'] = None,
    player_games: Optional['pd.DataFrame'] = None,
    min_minutes: float = 180.0,
) -> 'pd.DataFrame':
    """Aggregate rated actions into per-player (per-90) VAEP ratings.

    Parameters
    ----------
    rated_actions : pd.DataFrame
        Actions with ``player_id`` and the value columns ``VAEP.rate``
        produces (``vaep_value``, ``offensive_value``, ``defensive_value``).
    players : pd.DataFrame, optional
        Player table with ``player_id`` and ``player_name`` (and optionally
        ``nickname``, preferred when non-empty, as in the reference
        notebook).
    player_games : pd.DataFrame, optional
        Per-game appearances with ``player_id`` and ``minutes_played``.
        When given, adds ``*_rating`` columns normalized to 90 minutes and
        drops players with ``min_minutes`` total minutes or fewer.
    min_minutes : float
        Cut-off on total minutes for the normalized table; the boundary is
        EXCLUSIVE (strictly more than ``min_minutes`` survives), the
        reference notebook's ``minutes_played > 180`` filter.

    Returns
    -------
    pd.DataFrame
        One row per player, sorted by total (or per-90, when normalized)
        VAEP value, descending.
    """
    cols = [c for c in _VALUE_COLS if c in rated_actions.columns]
    if not cols:
        raise ValueError(f'rated_actions must contain at least one of {_VALUE_COLS}')
    summed = (
        rated_actions[['player_id', *cols]]
        .groupby('player_id')
        .agg(count=('player_id', 'size'), **{c: (c, 'sum') for c in cols})
        .reset_index()
    )

    if players is not None:
        name_cols = [c for c in ('nickname', 'player_name') if c in players.columns]
        lookup = players[['player_id', *name_cols]].drop_duplicates('player_id')
        summed = summed.merge(lookup, on='player_id', how='left')
        if 'nickname' in name_cols and 'player_name' in name_cols:
            nick = summed['nickname']
            use_nick = nick.notna() & (nick.astype(str) != '')
            summed['player_name'] = np.where(use_nick, nick, summed['player_name'])
            summed = summed.drop(columns=['nickname'])

    sort_col = cols[0] if 'vaep_value' not in cols else 'vaep_value'
    if player_games is not None:
        minutes = (
            player_games[['player_id', 'minutes_played']]
            .groupby('player_id')
            .sum()
            .reset_index()
        )
        summed = summed.merge(minutes, on='player_id', how='inner')
        summed = summed[summed['minutes_played'] > min_minutes]
        for c in cols:
            summed[c.replace('_value', '_rating')] = summed[c] * 90.0 / summed['minutes_played']
        sort_col = sort_col.replace('_value', '_rating')
    return summed.sort_values(sort_col, ascending=False).reset_index(drop=True)
