"""The port's ``player_ratings`` against the JAX package's: the same
grouping, the same name merge (a non-empty nickname wins) and the
exclusive ``min_minutes`` cut, on seeded rated-action frames."""

import numpy as np
import pandas as pd
import pytest

from socceraction_tpu.ratings import player_ratings as jax_player_ratings
from socceraction_tpu_torch.ratings import player_ratings


@pytest.fixture(scope='module')
def tables():
    rng = np.random.default_rng(4)
    n = 400
    rated = pd.DataFrame({
        'player_id': rng.integers(0, 25, size=n),
        'vaep_value': rng.normal(0, 0.05, size=n),
        'offensive_value': rng.normal(0, 0.05, size=n),
        'defensive_value': rng.normal(0, 0.02, size=n),
    })
    rated.loc[rng.random(n) < 0.05, 'vaep_value'] = np.nan
    players = pd.DataFrame({
        'player_id': np.arange(25),
        'player_name': [f'Player {i}' for i in range(25)],
        'nickname': [('Nick %d' % i) if i % 3 == 0 else ('' if i % 3 == 1 else None) for i in range(25)],
    })
    player_games = pd.DataFrame({
        'player_id': rng.integers(0, 25, size=80),
        'minutes_played': rng.choice([45, 90, 90, 30, 180], size=80).astype(float),
    })
    return rated, players, player_games


@pytest.mark.parametrize('with_players', [False, True])
@pytest.mark.parametrize('with_minutes', [False, True])
def test_player_ratings_equal_jax(tables, with_players, with_minutes):
    rated, players, player_games = tables
    kw = {}
    if with_players:
        kw['players'] = players
    if with_minutes:
        kw['player_games'] = player_games
    pd.testing.assert_frame_equal(player_ratings(rated, **kw), jax_player_ratings(rated, **kw))


@pytest.mark.parametrize('min_minutes', [0.0, 90.0, 180.0, 270.0])
def test_min_minutes_cut_is_exclusive_as_in_jax(tables, min_minutes):
    rated, _, player_games = tables
    got = player_ratings(rated, player_games=player_games, min_minutes=min_minutes)
    want = jax_player_ratings(rated, player_games=player_games, min_minutes=min_minutes)
    pd.testing.assert_frame_equal(got, want)
    assert (got['minutes_played'] > min_minutes).all()


def test_a_single_value_column_and_no_column(tables):
    rated, _, player_games = tables
    one = rated[['player_id', 'offensive_value']]
    pd.testing.assert_frame_equal(
        player_ratings(one, player_games=player_games), jax_player_ratings(one, player_games=player_games)
    )
    with pytest.raises(ValueError, match='at least one of'):
        player_ratings(rated[['player_id']])
