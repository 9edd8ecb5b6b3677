"""The port's ``build_spadl_store`` with its default converters and
``atomic=True`` against the JAX package's.

The same loader goes through both packages' ``build_spadl_store`` without
``convert=``: the port picks its own converter by the loader's class name,
as the JAX package does, and the stores must hold the same keys and equal
frames, dtypes included. StatsBomb, Wyscout and Opta run through both
packages' loaders; a store the port builds from its own Wyscout or Opta
loader equals the one the JAX package builds from its own. Each provider
fixture layout's chain (loader, ``convert_to_actions``,
``convert_to_atomic``) equals the JAX package's. The built store is then
packed and rated on the CPU with a model the JAX package trained, within
1e-5 of its ``rate``.
"""

import importlib.util
import os

import numpy as np
import pandas as pd
import pytest

from socceraction_tpu.atomic.spadl import convert_to_atomic as jax_convert_to_atomic
from socceraction_tpu.atomic.vaep import AtomicVAEP as JaxAtomicVAEP
from socceraction_tpu.core.synthetic import synthetic_actions_frame
from socceraction_tpu.data.opta import OptaLoader as JaxOptaLoader
from socceraction_tpu.data.statsbomb import StatsBombLoader as JaxStatsBombLoader
from socceraction_tpu.data.wyscout import PublicWyscoutLoader as JaxPublicWyscoutLoader
from socceraction_tpu.pipeline import SeasonStore as JaxSeasonStore
from socceraction_tpu.pipeline import build_spadl_store as jax_build_spadl_store
from socceraction_tpu.vaep import VAEP as JaxVAEP
from socceraction_tpu.vaep.base import load_model as jax_load_model
from socceraction_tpu_torch.atomic.spadl import convert_to_atomic
from socceraction_tpu_torch.core.batch import unpack_values
from socceraction_tpu_torch.data.opta import OptaLoader
from socceraction_tpu_torch.data.statsbomb import StatsBombLoader
from socceraction_tpu_torch.data.wyscout import PublicWyscoutLoader
from socceraction_tpu_torch.pipeline import SeasonStore, build_spadl_store, load_batch
from socceraction_tpu_torch.vaep.base import load_model

DATASETS = os.path.join(os.path.dirname(__file__), 'datasets')
STATSBOMB_DIR = os.path.join(DATASETS, 'statsbomb', 'raw')


def _statsbomb(cls):
    return cls(getter='local', root=STATSBOMB_DIR)


def _wyscout(cls):
    return cls(root=os.path.join(DATASETS, 'wyscout_public', 'raw'), download=False)


def _opta(cls):
    return cls(
        root=os.path.join(DATASETS, 'opta'), parser='xml',
        feeds={'f7': 'f7-{competition_id}-{season_id}-{game_id}.xml',
               'f24': 'f24-{competition_id}-{season_id}-{game_id}.xml'},
    )


def _statsperform(cls):
    return cls(root=os.path.join(DATASETS, 'statsperform'), parser='statsperform')


LOADERS = {
    'statsbomb-port': (StatsBombLoader, _statsbomb),
    'statsbomb-jax': (JaxStatsBombLoader, _statsbomb),
    'wyscout-jax': (JaxPublicWyscoutLoader, _wyscout),
    'opta-jax': (JaxOptaLoader, _opta),
    'wyscout-port': (PublicWyscoutLoader, _wyscout),
    'opta-port': (OptaLoader, _opta),
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


@pytest.mark.parametrize('name', ['statsbomb-port', 'wyscout-jax', 'opta-jax', 'wyscout-port', 'opta-port'])
def test_default_converter_without_atomic_equals_jax(tmp_path, name):
    cls, make = LOADERS[name]
    keys = assert_stores_equal(*build_both(tmp_path, make(cls)))
    assert not any(k.startswith('atomic') for k in keys)


# the port's own loaders: (port loader, JAX loader, make); a WhoScored
# loader has no competitions, which build_spadl_store lists
OWN_LOADERS = {
    'wyscout': (PublicWyscoutLoader, JaxPublicWyscoutLoader, _wyscout),
    'opta-statsperform': (OptaLoader, JaxOptaLoader, _statsperform),
    'opta-xml': (OptaLoader, JaxOptaLoader, _opta),
}


@pytest.mark.parametrize('atomic', [False, True])
@pytest.mark.parametrize('name', list(OWN_LOADERS))
def test_own_loader_store_equals_the_jax_loaders(tmp_path, name, atomic):
    """The port's loader through the port's ``build_spadl_store`` and the
    JAX package's loader through the JAX package's give equal stores."""
    cls, jax_cls, make = OWN_LOADERS[name]
    with SeasonStore(str(tmp_path / 'port'), mode='w') as ts:
        build_spadl_store(make(cls), ts, atomic=atomic)
    with JaxSeasonStore(str(tmp_path / 'jax'), mode='w') as js:
        jax_build_spadl_store(make(jax_cls), js, atomic=atomic)
    keys = assert_stores_equal(str(tmp_path / 'port'), str(tmp_path / 'jax'))
    game_keys = [k for k in keys if k.startswith('actions/game_')]
    assert len(game_keys) == 1
    assert any(k.startswith('atomic_actions/') for k in keys) == atomic


def _provider_chains():
    """The provider fixture layouts' loaders and converters in both packages
    (``tests/datasets/port/make_provider_spadl.py``)."""
    path = os.path.join(DATASETS, 'port', 'make_provider_spadl.py')
    spec = importlib.util.spec_from_file_location('make_provider_spadl', path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


MAKE = _provider_chains()


@pytest.fixture(scope='module')
def provider_actions():
    pytest.importorskip('lxml')
    return {package: MAKE.provider_actions(package) for package in ('socceraction_tpu_torch', 'socceraction_tpu')}


@pytest.mark.parametrize('layout', ['opta_xml', 'opta_json', 'statsperform', 'whoscored', 'wyscout_public',
                                    'wyscout_api'])
def test_loader_to_atomic_chain_equals_jax(provider_actions, layout):
    """The port's loader, ``convert_to_actions`` and ``convert_to_atomic``
    against the JAX package's, on each provider fixture layout."""
    (home, actions), (jax_home, jax_actions) = (
        provider_actions['socceraction_tpu_torch'][layout], provider_actions['socceraction_tpu'][layout])
    assert home == jax_home and len(actions) > 0
    pd.testing.assert_frame_equal(actions, jax_actions, check_exact=True, check_dtype=True)
    atomic = convert_to_atomic(actions)
    assert len(atomic) >= len(actions)
    pd.testing.assert_frame_equal(atomic, jax_convert_to_atomic(jax_actions), check_exact=True, check_dtype=True)


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
