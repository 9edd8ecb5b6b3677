"""The port's ``build_spadl_store`` with its default converters and
``atomic=True`` against the JAX package's.

The same loader goes through both packages' ``build_spadl_store`` without
``convert=``: the port picks its own converter by the loader's class name,
as the JAX package does, and the stores must hold the same keys and equal
frames, dtypes included. StatsBomb runs through both packages' loaders;
the Wyscout and Opta converters run through the JAX package's loaders (the
port's are not ported yet). The built store is then packed and rated on
the CPU with a model the JAX package trained, within 1e-5 of its ``rate``.
"""

import os

import numpy as np
import pandas as pd
import pytest

from socceraction_tpu.atomic.spadl import convert_to_atomic as jax_convert_to_atomic
from socceraction_tpu.atomic.vaep import AtomicVAEP as JaxAtomicVAEP
from socceraction_tpu.core.synthetic import synthetic_actions_frame
from socceraction_tpu.data.opta import OptaLoader
from socceraction_tpu.data.statsbomb import StatsBombLoader as JaxStatsBombLoader
from socceraction_tpu.data.wyscout import PublicWyscoutLoader
from socceraction_tpu.pipeline import SeasonStore as JaxSeasonStore
from socceraction_tpu.pipeline import build_spadl_store as jax_build_spadl_store
from socceraction_tpu.vaep import VAEP as JaxVAEP
from socceraction_tpu.vaep.base import load_model as jax_load_model
from socceraction_tpu_torch.core.batch import unpack_values
from socceraction_tpu_torch.data.statsbomb import StatsBombLoader
from socceraction_tpu_torch.pipeline import SeasonStore, build_spadl_store, load_batch
from socceraction_tpu_torch.vaep.base import load_model

DATASETS = os.path.join(os.path.dirname(__file__), 'datasets')
STATSBOMB_DIR = os.path.join(DATASETS, 'statsbomb', 'raw')


def _statsbomb(cls):
    return cls(getter='local', root=STATSBOMB_DIR)


def _wyscout(_=None):
    return PublicWyscoutLoader(root=os.path.join(DATASETS, 'wyscout_public', 'raw'), download=False)


def _opta(_=None):
    return OptaLoader(
        root=os.path.join(DATASETS, 'opta'), parser='xml',
        feeds={'f7': 'f7-{competition_id}-{season_id}-{game_id}.xml',
               'f24': 'f24-{competition_id}-{season_id}-{game_id}.xml'},
    )


LOADERS = {
    'statsbomb-port': (StatsBombLoader, _statsbomb),
    'statsbomb-jax': (JaxStatsBombLoader, _statsbomb),
    'wyscout-jax': (None, _wyscout),
    'opta-jax': (None, _opta),
}


def build_both(tmp_path, loader, engine='parquet', **kwargs):
    """The store each package builds from ``loader``; returns the paths."""
    ext = '.h5' if engine == 'hdf5' else ''
    paths = str(tmp_path / f'port{ext}'), str(tmp_path / f'jax{ext}')
    with SeasonStore(paths[0], mode='w') as ts:
        assert build_spadl_store(loader, ts, **kwargs) is ts
    with JaxSeasonStore(paths[1], mode='w') as js:
        jax_build_spadl_store(loader, js, **kwargs)
    return paths


def assert_stores_equal(port, jax):
    with SeasonStore(port, mode='r') as ts, JaxSeasonStore(jax, mode='r') as js:
        assert ts.keys() == js.keys()
        for key in js.keys():
            pd.testing.assert_frame_equal(ts.get(key), js.get(key), check_exact=True, check_dtype=True)
        return ts.keys()


@pytest.mark.parametrize('engine', ['parquet', 'hdf5'])
@pytest.mark.parametrize('name', list(LOADERS))
def test_default_converter_and_atomic_store_equals_jax(tmp_path, name, engine):
    cls, make = LOADERS[name]
    port, jax = build_both(tmp_path, make(cls), engine, atomic=True)
    keys = assert_stores_equal(port, jax)
    assert 'atomic_actiontypes' in keys
    game_keys = [k for k in keys if k.startswith('actions/game_')]
    assert game_keys and all(k.replace('actions/', 'atomic_actions/') in keys for k in game_keys)


@pytest.mark.parametrize('name', ['statsbomb-port', 'wyscout-jax', 'opta-jax'])
def test_default_converter_without_atomic_equals_jax(tmp_path, name):
    cls, make = LOADERS[name]
    keys = assert_stores_equal(*build_both(tmp_path, make(cls)))
    assert not any(k.startswith('atomic') for k in keys)


class StatsBombLoaderWithMissingGame(StatsBombLoader):
    """The fixture's loader, listing one more game whose files are absent."""

    def games(self, competition_id, season_id):
        games = super().games(competition_id, season_id)
        missing = games.iloc[[0]].assign(game_id=99999)
        return pd.concat([games, missing], ignore_index=True)


@pytest.mark.parametrize('atomic', [False, True])
def test_on_error_skip_equals_jax(tmp_path, atomic):
    loader = StatsBombLoaderWithMissingGame(getter='local', root=STATSBOMB_DIR)
    port, jax = build_both(tmp_path, loader, atomic=atomic, on_error='skip')
    keys = assert_stores_equal(port, jax)
    assert 'actions/game_7584' in keys and 'actions/game_99999' not in keys
    with SeasonStore(port, mode='r') as ts:
        assert list(ts.get('games')['game_id']) == [7584]
    with SeasonStore(str(tmp_path / 'raise'), mode='w') as ts:
        with pytest.raises(FileNotFoundError):
            build_spadl_store(loader, ts, atomic=atomic)


def test_failed_atomic_conversion_is_skipped_whole(tmp_path, monkeypatch):
    """A game whose atomic conversion fails leaves neither of its frames."""
    from socceraction_tpu_torch.atomic import spadl as atomic_spadl

    def broken(actions):
        raise RuntimeError('atomic conversion failed')

    monkeypatch.setattr(atomic_spadl, 'convert_to_atomic', broken)
    with SeasonStore(str(tmp_path / 'port'), mode='w') as ts:
        build_spadl_store(_statsbomb(StatsBombLoader), ts, atomic=True, on_error='skip')
        assert not any(k.startswith(('actions/', 'atomic_actions/')) for k in ts.keys())
        assert len(ts.get('games')) == 0


class MysteryFeedLoader(StatsBombLoader):
    """A loader whose class name names no provider."""


def test_unknown_loader_raises_the_jax_error(tmp_path):
    loader = MysteryFeedLoader(getter='local', root=STATSBOMB_DIR)
    with SeasonStore(str(tmp_path / 'port'), mode='w') as ts, \
            JaxSeasonStore(str(tmp_path / 'jax'), mode='w') as js:
        with pytest.raises(ValueError) as want:
            jax_build_spadl_store(loader, js)
        with pytest.raises(ValueError) as got:
            build_spadl_store(loader, ts)
    assert str(got.value) == str(want.value)
    assert 'cannot infer a SPADL converter for loader MysteryFeedLoader' in str(got.value)


# -- the built store, packed and rated -----------------------------------------------------


@pytest.fixture(scope='module')
def jax_models(tmp_path_factory):
    """A standard and an atomic JAX VAEP with small MLP heads, trained on a
    synthetic game and saved; the port loads them."""
    params = {'hidden': (8,), 'batch_size': 256, 'max_epochs': 2}
    frame = synthetic_actions_frame(5, n_actions=600, seed=4)
    game = pd.Series({'game_id': 5, 'home_team_id': 100})
    paths = {}
    for family, cls, actions in (('standard', JaxVAEP, frame),
                                 ('atomic', JaxAtomicVAEP, jax_convert_to_atomic(frame))):
        model = cls(backend='jax')
        X, y = model.compute_features(game, actions), model.compute_labels(game, actions)
        model.fit(X, y, learner='mlp', tree_params=params, random_state=0)
        paths[family] = str(tmp_path_factory.mktemp(family))
        model.save_model(paths[family])
    return paths


@pytest.mark.parametrize('family', ['standard', 'atomic'])
def test_built_store_packs_and_rates_as_jax(tmp_path, jax_models, family):
    port, jax = build_both(tmp_path, _statsbomb(StatsBombLoader), atomic=True)
    model = load_model(jax_models[family], device='cpu')
    jmodel = jax_load_model(jax_models[family])
    assert type(model).__name__ == type(jmodel).__name__ == (
        'VAEP' if family == 'standard' else 'AtomicVAEP')
    prefix = 'actions' if family == 'standard' else 'atomic_actions'
    with SeasonStore(port, mode='r') as ts, JaxSeasonStore(jax, mode='r') as js:
        batch, game_ids = load_batch(ts, device='cpu', family=family)
        got = unpack_values(model.rate_batch(batch), batch)
        games = js.get('games').set_index('game_id')
        want = np.concatenate([
            jmodel.rate(pd.Series({'game_id': g, 'home_team_id': games.loc[g, 'home_team_id']}),
                        js.get(f'{prefix}/game_{g}')).to_numpy()
            for g in game_ids
        ])
    assert got.shape == want.shape and len(got) > 0
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-5)
