"""The port's chain generator and season writers against the JAX package's.

- ``synthetic_actions_frame``, with and without latents, is bitwise the
  JAX package's for several seeds and shapes; its pandas-free core
  ``_chain_columns`` returns the frame's columns.
- ``chip_smoke.SEASON_DIGEST`` is the sha256 of the JAX package's frames
  of the quality tier's season, so the card's machine, which has no
  pandas, provably draws the reference's season; ``pack_chain_games``
  packs those columns as ``pack_actions`` packs the frames.
- The stores ``write_synthetic_season`` and ``append_synthetic_games``
  write read back equal in the other package, both ways, on both engines.
- Phase 19's numpy AUROC and Brier equal scikit-learn's.
"""

import numpy as np
import pandas as pd
import pytest
import torch
from sklearn.metrics import brier_score_loss, roc_auc_score

import chip_smoke
from socceraction_tpu.core import synthetic as jax_synthetic
from socceraction_tpu.pipeline import SeasonStore as JaxSeasonStore
from socceraction_tpu_torch.core import synthetic
from socceraction_tpu_torch.core.batch import pack_actions
from socceraction_tpu_torch.pipeline import SeasonStore

CASES = [
    # (game_id, home, away, n_actions, seed)
    (1, 100, 200, 1600, 0),
    (7003, 100, 200, 1000, 3),
    (42, 7, 8, 300, 11),
    (9, 200, 100, 777, 123),
]


def assert_same(got, want):
    pd.testing.assert_frame_equal(got, want, check_exact=True, check_dtype=True)


def _frames(module, case, include_latents):
    game_id, home, away, n, seed = case
    return module.synthetic_actions_frame(
        game_id, home_team_id=home, away_team_id=away, n_actions=n, seed=seed,
        include_latents=include_latents,
    )


@pytest.mark.parametrize('include_latents', [False, True])
@pytest.mark.parametrize('case', CASES, ids=lambda c: f'game{c[0]}-seed{c[4]}')
def test_chain_frame_is_bitwise_jax(case, include_latents):
    got = _frames(synthetic, case, include_latents)
    want = _frames(jax_synthetic, case, include_latents)
    assert_same(got, want)
    for c in want.columns:
        if want[c].dtype.kind == 'f':
            assert got[c].to_numpy().tobytes() == want[c].to_numpy().tobytes(), c


def test_chain_frame_defaults_equal_jax():
    assert_same(synthetic.synthetic_actions_frame(), jax_synthetic.synthetic_actions_frame())


@pytest.mark.parametrize('case', CASES[:2], ids=lambda c: f'game{c[0]}-seed{c[4]}')
def test_chain_core_is_the_frame_columns(case):
    game_id, home, away, n, seed = case
    cols = synthetic._chain_columns(game_id, home_team_id=home, away_team_id=away, n_actions=n,
                                    seed=seed, include_latents=True)
    frame = _frames(synthetic, case, True)
    assert list(cols) == list(synthetic.CHAIN_COLUMNS) + list(synthetic.LATENT_COLUMNS)
    assert list(frame.columns) == (['game_id', 'original_event_id'] + list(synthetic.CHAIN_COLUMNS[1:])
                                   + list(synthetic.LATENT_COLUMNS))
    for c, a in cols.items():
        assert isinstance(a, np.ndarray) and a.shape == (n,)
        np.testing.assert_array_equal(a, frame[c].to_numpy())
        assert a.dtype == frame[c].to_numpy().dtype, c
    plain = synthetic._chain_columns(game_id, home_team_id=home, away_team_id=away, n_actions=n, seed=seed)
    assert list(plain) == list(synthetic.CHAIN_COLUMNS)


@pytest.mark.parametrize('team', [100, 200, 7, 123457])
def test_persistent_skills_equal_jax(team):
    assert synthetic._team_strength(team) == jax_synthetic._team_strength(team)
    for j in range(1, 12):
        assert synthetic._player_finish(team * 1000 + j, j) == jax_synthetic._player_finish(team * 1000 + j, j)


# -- phase 19's season -------------------------------------------------------------------


@pytest.fixture(scope='module')
def jax_season():
    sizes = chip_smoke.QualitySizes()
    return [
        jax_synthetic.synthetic_actions_frame(
            7000 + i, home_team_id=chip_smoke.QUALITY_HOME, away_team_id=chip_smoke.QUALITY_AWAY,
            n_actions=sizes.actions, seed=i,
        )
        for i in range(sizes.train_games + sizes.test_games)
    ]


def test_season_digest_is_the_jax_frames(jax_season):
    assert chip_smoke.QualitySizes().digest == chip_smoke.SEASON_DIGEST
    cols = [{c: f[c].to_numpy() for c in synthetic.CHAIN_COLUMNS} for f in jax_season]
    assert chip_smoke.season_digest(cols) == chip_smoke.SEASON_DIGEST


def test_season_digest_sees_one_changed_value(jax_season):
    cols = [{c: f[c].to_numpy().copy() for c in synthetic.CHAIN_COLUMNS} for f in jax_season[:2]]
    base = chip_smoke.season_digest(cols)
    cols[1]['start_x'][500] = np.nextafter(cols[1]['start_x'][500], np.inf)
    assert chip_smoke.season_digest(cols) != base


def test_pack_chain_games_is_pack_actions(jax_season):
    sizes = chip_smoke.QualitySizes(train_games=3, test_games=2, actions=1000)
    games = chip_smoke.chain_season(sizes)
    got = chip_smoke.pack_chain_games(games, chip_smoke.QUALITY_HOME, 'cpu')
    want, _ = pack_actions(pd.concat(jax_season[:5], ignore_index=True),
                           home_team_id=chip_smoke.QUALITY_HOME, device='cpu')
    assert got.total_actions == want.total_actions == 5000
    for name, t in want.fields().items():
        assert torch.equal(getattr(got, name), t), name
        assert getattr(got, name).dtype == t.dtype, name


def test_pack_chain_games_pads_ragged_games():
    games = [synthetic._chain_columns(i, home_team_id=100, away_team_id=200, n_actions=n, seed=i)
             for i, n in enumerate((130, 60))]
    frames = [synthetic.synthetic_actions_frame(i, n_actions=n, seed=i) for i, n in enumerate((130, 60))]
    got = chip_smoke.pack_chain_games(games, 100, 'cpu')
    want, _ = pack_actions(pd.concat(frames, ignore_index=True), home_team_id=100, device='cpu')
    assert got.max_actions == 256
    for name, t in want.fields().items():
        assert torch.equal(getattr(got, name), t), name


@pytest.mark.parametrize('seed', [0, 1, 2])
def test_auroc_and_brier_equal_sklearn(seed):
    rng = np.random.default_rng(seed)
    n = 5000
    y = rng.random(n) < 0.05
    # coarse probabilities: many ties, as a saturated head gives
    p = np.round(np.clip(rng.normal(0.05 + 0.1 * y, 0.05), 0, 1), 2 + seed).astype(np.float32)
    assert abs(chip_smoke.auroc(y, p) - roc_auc_score(y, p)) <= 1e-12
    # brier sums in f64; scikit-learn sums in the probabilities' dtype
    assert abs(chip_smoke.brier(y, p) - brier_score_loss(y, p.astype(np.float64))) <= 1e-12


def test_auroc_of_a_perfect_and_a_constant_score():
    y = np.array([0, 0, 1, 1, 0, 1], dtype=bool)
    assert chip_smoke.auroc(y, y.astype(float)) == 1.0
    assert chip_smoke.auroc(y, np.full(6, 0.3)) == 0.5


# -- the season writers ------------------------------------------------------------------


def _store_path(tmp_path, name, engine):
    return str(tmp_path / (f'{name}.h5' if engine == 'hdf5' else name))


def _assert_stores_equal(got_path, want_path, got_cls, want_cls):
    with got_cls(got_path, mode='r') as got, want_cls(want_path, mode='r') as want:
        assert got.keys() == want.keys()
        for key in want.keys():
            assert_same(got.get(key), want.get(key))


@pytest.mark.parametrize('engine', ['parquet', 'hdf5'])
def test_write_synthetic_season_equals_jax_both_ways(tmp_path, engine):
    port = _store_path(tmp_path, 'port', engine)
    jax = _store_path(tmp_path, 'jax', engine)
    assert synthetic.write_synthetic_season(port, n_games=5, n_actions=150, seed=4) == port
    jax_synthetic.write_synthetic_season(jax, n_games=5, n_actions=150, seed=4)
    # the port's store read by the JAX package, and the JAX store by the port
    _assert_stores_equal(port, jax, JaxSeasonStore, JaxSeasonStore)
    _assert_stores_equal(jax, port, SeasonStore, SeasonStore)
    _assert_stores_equal(port, jax, SeasonStore, JaxSeasonStore)


@pytest.mark.parametrize('engine', ['parquet', 'hdf5'])
def test_append_synthetic_games_equals_jax_both_ways(tmp_path, engine):
    port = _store_path(tmp_path, 'port', engine)
    jax = _store_path(tmp_path, 'jax', engine)
    jax_synthetic.write_synthetic_season(port, n_games=2, n_actions=64, seed=1)
    jax_synthetic.write_synthetic_season(jax, n_games=2, n_actions=64, seed=1)
    got = synthetic.append_synthetic_games(port, n_games=3, n_actions=120, seed=5)
    want = jax_synthetic.append_synthetic_games(jax, n_games=3, n_actions=120, seed=5)
    assert got == want == [9002, 9003, 9004]
    assert synthetic.append_synthetic_games(port, n_games=1, n_actions=80, seed=2, start_id=9003) == \
        jax_synthetic.append_synthetic_games(jax, n_games=1, n_actions=80, seed=2, start_id=9003)
    _assert_stores_equal(port, jax, JaxSeasonStore, JaxSeasonStore)
    _assert_stores_equal(jax, port, SeasonStore, SeasonStore)
