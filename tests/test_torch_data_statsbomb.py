"""The port's StatsBomb loader and loader core against the JAX package's.

Every ``StatsBombLoader`` frame of the open-data fixture (game 7584, its
360 feed included) and ``extract_player_games`` must equal the JAX
package's exactly, dtypes included; the errors are the same. The remote
getter needs ``statsbombpy``, which is absent: only its import error is
tested (no test reaches the network).
"""

import importlib
import json
import os
import shutil
import sys

import pandas as pd
import pytest

from socceraction_tpu import data as jax_data
from socceraction_tpu.data import base as jax_base
from socceraction_tpu.data import schema as jax_schema
from socceraction_tpu.data import statsbomb as jax_statsbomb
from socceraction_tpu_torch import data
from socceraction_tpu_torch.data import base
from socceraction_tpu_torch.data import schema
from socceraction_tpu_torch.data import statsbomb
from socceraction_tpu_torch.data.statsbomb import loader as loader_mod

DATA_DIR = os.path.join(os.path.dirname(__file__), 'datasets', 'statsbomb', 'raw')
GAME_ID = 7584


def assert_same(got, want):
    pd.testing.assert_frame_equal(got, want, check_exact=True, check_dtype=True)


@pytest.fixture(scope='module')
def loaders():
    return (statsbomb.StatsBombLoader(getter='local', root=DATA_DIR),
            jax_statsbomb.StatsBombLoader(getter='local', root=DATA_DIR))


def test_surfaces_equal_jax():
    assert data.__all__ == jax_data.__all__
    assert statsbomb.__all__ == jax_statsbomb.__all__
    assert base.__all__ == jax_base.__all__
    assert issubclass(statsbomb.StatsBombLoader, data.EventDataLoader)
    for name in ('CompetitionSchema', 'GameSchema', 'TeamSchema', 'PlayerSchema', 'EventSchema'):
        got, want = getattr(schema, name), getattr(jax_schema, name)
        assert list(got.fields) == list(want.fields) and got.strict == want.strict
    for name in statsbomb.__all__:
        if name.endswith('Schema'):
            got, want = getattr(statsbomb, name), getattr(jax_statsbomb, name)
            assert list(got.fields) == list(want.fields)
            for field in want.fields:
                assert vars(got.fields[field]) == vars(want.fields[field]), (name, field)


@pytest.mark.parametrize(
    ('method', 'args'),
    [
        ('competitions', ()),
        ('games', (43, 3)),
        ('teams', (GAME_ID,)),
        ('players', (GAME_ID,)),
        ('events', (GAME_ID,)),
        ('events', (GAME_ID, True)),
    ],
)
def test_loader_frame_equals_jax(loaders, method, args):
    port, jax = loaders
    got = getattr(port, method)(*args)
    assert len(got) > 0
    assert_same(got, getattr(jax, method)(*args))


def test_360_frames_merge_as_jax(loaders):
    port, jax = loaders
    got = port.events(GAME_ID, load_360=True)
    assert got['visible_area_360'].notna().sum() == 2
    assert_same(got, jax.events(GAME_ID, load_360=True))


def test_empty_360_feed_equals_jax(tmp_path):
    root = tmp_path / 'raw'
    shutil.copytree(DATA_DIR, root)
    (root / 'three-sixty' / f'{GAME_ID}.json').write_text('[]')
    got = statsbomb.StatsBombLoader(getter='local', root=str(root)).events(GAME_ID, load_360=True)
    want = jax_statsbomb.StatsBombLoader(getter='local', root=str(root)).events(GAME_ID, load_360=True)
    assert got['visible_area_360'].isna().all() and got['freeze_frame_360'].isna().all()
    assert_same(got, want)


def test_extract_player_games_equals_jax(loaders):
    events = loaders[1].events(GAME_ID)
    got = statsbomb.extract_player_games(events.copy())
    assert len(got) > 0
    assert_same(got, jax_statsbomb.extract_player_games(events.copy()))


@pytest.mark.parametrize(
    ('name', 'content', 'call'),
    [
        ('competitions.json', '{"not": "a list"}', lambda l: l.competitions()),
        ('matches/43/3.json', '{"not": "a list"}', lambda l: l.games(43, 3)),
        ('lineups/7584.json', '{"not": "a list"}', lambda l: l.teams(GAME_ID)),
        ('lineups/7584.json', '[{"team_id": 1, "team_name": "A", "lineup": []}]',
         lambda l: l.players(GAME_ID)),
        ('events/7584.json', '{"not": "a list"}', lambda l: l.events(GAME_ID)),
        ('three-sixty/7584.json', '{"not": "a list"}', lambda l: l.events(GAME_ID, load_360=True)),
    ],
)
def test_malformed_json_raises_parse_error(tmp_path, name, content, call):
    root = tmp_path / 'raw'
    shutil.copytree(DATA_DIR, root)
    (root / name).write_text(content)
    with pytest.raises(base.ParseError):
        call(statsbomb.StatsBombLoader(getter='local', root=str(root)))
    with pytest.raises(jax_base.ParseError):
        call(jax_statsbomb.StatsBombLoader(getter='local', root=str(root)))


def test_missing_game_and_bad_getters_raise_as_jax(loaders):
    with pytest.raises(FileNotFoundError):
        loaders[0].events(99999)
    for kwargs in ({'getter': 'foo'}, {'getter': 'local'}):
        with pytest.raises(ValueError):
            statsbomb.StatsBombLoader(**kwargs)


def test_remote_getter_without_statsbombpy(monkeypatch):
    monkeypatch.setitem(sys.modules, 'statsbombpy', None)
    reloaded = importlib.reload(loader_mod)
    try:
        assert reloaded.sb is None
        with pytest.raises(ImportError, match='statsbombpy'):
            reloaded.StatsBombLoader(getter='remote')
        with pytest.raises(ImportError, match='statsbombpy'):
            reloaded.StatsBombLoader()  # remote is the default getter, as in JAX
        assert len(reloaded.StatsBombLoader(getter='local', root=DATA_DIR).competitions()) == 1
    finally:
        monkeypatch.delitem(sys.modules, 'statsbombpy', raising=False)
        importlib.reload(loader_mod)


@pytest.mark.parametrize('minute', [0, 30, 45, 46, 90, 91, 105, 106, 120, 121])
@pytest.mark.parametrize('periods', [[47, 48], [45, 50, 16, 17], [46, 46, 15, 15, 0]])
def test_expand_minute_equals_jax(minute, periods):
    assert base._expand_minute(minute, periods) == jax_base._expand_minute(minute, periods)


def test_json_helpers_equal_jax(tmp_path):
    path = tmp_path / 'x.json'
    path.write_text(json.dumps([{'a': 1, 'b': [1.5, None]}, 'é']), encoding='utf-8')
    assert base._localloadjson(str(path)) == jax_base._localloadjson(str(path))
    for name in ('typePrimary', 'PassEndLocation', 'shotXG', 'x', 'matchPeriod2'):
        assert base._snake(name) == jax_base._snake(name)
