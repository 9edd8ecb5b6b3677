"""The port's Wyscout loaders against the JAX package's.

The same fixture feeds go through ``socceraction_tpu.data.wyscout`` and
``socceraction_tpu_torch.data.wyscout``: every frame of
``PublicWyscoutLoader`` (the public World Cup fixture game) and of
``WyscoutLoader(getter='local')`` (the API-v2 fixture game) must equal the
JAX package's exactly, dtypes included; so must ``_minutes_played`` on its
edge cases and the v3 flattener. Every error and warning the JAX loaders
raise on a bad feed, the port's raise alike. The download path is served
from a zip built under ``tmp_path`` through a patched
``urlopen``/``urlretrieve``: no test reaches the network.
"""

import json
import os
import shutil
import warnings
import zipfile

import pandas as pd
import pytest

from socceraction_tpu.data import base as jax_base
from socceraction_tpu.data import wyscout as jax_wyscout
from socceraction_tpu.data.wyscout import loader as jax_loader
from socceraction_tpu_torch.data import base
from socceraction_tpu_torch.data import wyscout
from socceraction_tpu_torch.data.wyscout import loader

DATASETS = os.path.join(os.path.dirname(os.path.abspath(__file__)), 'datasets')
PUBLIC_DIR = os.path.join(DATASETS, 'wyscout_public', 'raw')
API_DIR = os.path.join(DATASETS, 'wyscout_api')
GAME_ID = 2058007
API_GAME = 555001
API_FEEDS = {
    'competitions': 'competitions.json',
    'seasons': 'seasons_{competition_id}.json',
    'events': 'events_{game_id}.json',
}


def assert_same(got, want):
    pd.testing.assert_frame_equal(got, want, check_exact=True, check_dtype=True)


def outcome(fn):
    """``(result, error)`` of ``fn()`` with its warnings: the error as its
    class name and message, each warning as its category name and message."""
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter('always')
        try:
            result, error = fn(), None
        except Exception as e:  # noqa: BLE001 - the test compares what either package raises
            result, error = None, (type(e).__name__, str(e))
    return result, error, [(w.category.__name__, str(w.message)) for w in caught]


def assert_same_outcome(port_fn, jax_fn):
    got, want = outcome(port_fn), outcome(jax_fn)
    assert got[1:] == want[1:]
    if want[0] is not None:
        assert_same(got[0], want[0])
    return got


def test_surfaces_equal_jax():
    assert wyscout.__all__ == jax_wyscout.__all__
    assert loader.__all__ == jax_loader.__all__
    assert wyscout.wyscout_periods == jax_wyscout.wyscout_periods
    assert loader._PUBLIC_DATASET_INDEX == jax_loader._PUBLIC_DATASET_INDEX
    assert loader._PUBLIC_DATASET_URLS == jax_loader._PUBLIC_DATASET_URLS
    assert issubclass(wyscout.PublicWyscoutLoader, base.EventDataLoader)
    assert issubclass(wyscout.WyscoutLoader, base.EventDataLoader)
    for name in wyscout.__all__:
        if name.endswith('Schema'):
            got, want = getattr(wyscout, name), getattr(jax_wyscout, name)
            assert list(got.fields) == list(want.fields) and got.strict == want.strict
            for field in want.fields:
                assert vars(got.fields[field]) == vars(want.fields[field]), (name, field)


@pytest.fixture(scope='module')
def public():
    return (wyscout.PublicWyscoutLoader(root=PUBLIC_DIR, download=False),
            jax_wyscout.PublicWyscoutLoader(root=PUBLIC_DIR, download=False))


@pytest.fixture(scope='module')
def api():
    return (wyscout.WyscoutLoader(root=API_DIR, getter='local', feeds=API_FEEDS),
            jax_wyscout.WyscoutLoader(root=API_DIR, getter='local', feeds=API_FEEDS))


FRAMES = [('competitions', ()), ('games', 'season'), ('teams', 'game'), ('players', 'game'),
          ('events', 'game')]


def _args(spec, season, game):
    return {'season': season, 'game': (game,)}.get(spec, spec)


@pytest.mark.parametrize(('method', 'args'), FRAMES, ids=[m for m, _ in FRAMES])
def test_public_loader_frame_equals_jax(public, method, args):
    port, jax = public
    args = _args(args, (28, 10078), GAME_ID)
    got = getattr(port, method)(*args)
    assert len(got) > 0
    assert_same(got, getattr(jax, method)(*args))


def test_public_loader_match_index_equals_jax(public):
    port, jax = public
    assert_same(port._match_index, jax._match_index)
    assert_same(port._index, jax._index)


@pytest.mark.parametrize(('method', 'args'), FRAMES, ids=[m for m, _ in FRAMES])
def test_api_loader_frame_equals_jax(api, method, args):
    port, jax = api
    args = _args(args, (77, 2021), API_GAME)
    got = getattr(port, method)(*args)
    assert len(got) > 0
    assert_same(got, getattr(jax, method)(*args))


def test_getters_and_default_feeds_equal_jax():
    for getter in ('local', 'remote'):
        got = wyscout.WyscoutLoader(root=API_DIR, getter=getter)
        want = jax_wyscout.WyscoutLoader(root=API_DIR, getter=getter)
        assert got.feeds == want.feeds
        assert got.get.__name__ == want.get.__name__
    assert wyscout.WyscoutLoader._wyscout_api == jax_wyscout.WyscoutLoader._wyscout_api
    got = outcome(lambda: wyscout.WyscoutLoader(root=API_DIR, getter='ftp'))
    assert got[1] == ('ValueError', 'Invalid getter specified')
    assert got[1:] == outcome(lambda: jax_wyscout.WyscoutLoader(root=API_DIR, getter='ftp'))[1:]


# -- the download path, served from tmp_path ------------------------------------------------


def _fake_network(monkeypatch, module, archive, calls):
    """Patch ``module``'s ``urlopen``/``urlretrieve`` to serve ``archive``
    for every URL, recording the URLs asked for."""

    class Response:
        def __init__(self, url):
            self.url = url

        def geturl(self):
            return self.url

    def urlopen(url):
        calls.append(url)
        return Response(url)

    def urlretrieve(url, target):
        shutil.copy(archive, target)
        return target, None

    monkeypatch.setattr(module, 'urlopen', urlopen)
    monkeypatch.setattr(module, 'urlretrieve', urlretrieve)


@pytest.mark.parametrize('download', [True, False])
def test_download_from_a_served_zip_equals_jax(tmp_path, monkeypatch, download):
    """An empty root (or ``download=True``) downloads every archive of the
    release; the zips unpack into the root and load as the fixture does."""
    archive = tmp_path / 'release.zip'
    with zipfile.ZipFile(archive, 'w') as zf:
        for name in sorted(os.listdir(PUBLIC_DIR)):
            zf.write(os.path.join(PUBLIC_DIR, name), name)
    loaders, calls = [], {}
    for name, module, package in (('port', loader, wyscout), ('jax', jax_loader, jax_wyscout)):
        root = tmp_path / name
        root.mkdir()
        if not download:
            assert os.listdir(root) == []
        calls[name] = []
        _fake_network(monkeypatch, module, archive, calls[name])
        loaders.append(package.PublicWyscoutLoader(root=str(root), download=download))
    assert calls['port'] == calls['jax'] == list(jax_loader._PUBLIC_DATASET_URLS.values())
    assert sorted(os.listdir(tmp_path / 'port')) == sorted(os.listdir(tmp_path / 'jax'))
    port, jax = loaders
    for method, args in FRAMES:
        args = _args(args, (28, 10078), GAME_ID)
        assert_same(getattr(port, method)(*args), getattr(jax, method)(*args))


def test_default_root_is_made_in_the_working_directory(tmp_path, monkeypatch):
    archive = tmp_path / 'release.zip'
    with zipfile.ZipFile(archive, 'w') as zf:
        zf.write(os.path.join(PUBLIC_DIR, 'competitions.json'), 'competitions.json')
    calls = []
    _fake_network(monkeypatch, loader, archive, calls)
    monkeypatch.chdir(tmp_path)
    got = wyscout.PublicWyscoutLoader()
    assert got.root == os.path.join(str(tmp_path), 'wyscout_data')
    assert os.path.exists(os.path.join(got.root, 'competitions.json'))
    assert len(calls) == len(jax_loader._PUBLIC_DATASET_URLS)


# -- minutes played -------------------------------------------------------------------------


def _team(team_id, lineup, bench=(), substitutions='null'):
    return {'teamId': team_id, 'formation': {
        'lineup': [{'playerId': p, 'shirtNumber': p % 30, 'redCards': red} for p, red in lineup],
        'bench': [{'playerId': p, 'shirtNumber': p % 30, 'redCards': red} for p, red in bench],
        'substitutions': substitutions,
    }}


_HALVES = [{'matchPeriod': '1H', 'eventSec': 47 * 60.0}, {'matchPeriod': '2H', 'eventSec': 49 * 60.0}]

MINUTES_CASES = {
    'shootout excluded': (
        [_team(1, [(1, '0')])],
        _HALVES + [{'matchPeriod': 'E1', 'eventSec': 15 * 60.0}, {'matchPeriod': 'E2', 'eventSec': 16 * 60.0},
                   {'matchPeriod': 'P', 'eventSec': 10 * 60.0}],
    ),
    'substitution and injury time': (
        [_team(1, [(1, '0'), (2, '0')], bench=[(3, '0')],
               substitutions=[{'playerIn': 3, 'playerOut': 2, 'minute': 60}])],
        _HALVES,
    ),
    'red card for a starter': ([_team(1, [(1, '0'), (2, '80')])], _HALVES),
    'red card for a substitute': (
        [_team(1, [(1, '0'), (2, '0')], bench=[(3, '88')],
               substitutions=[{'playerIn': 3, 'playerOut': 2, 'minute': 30}])],
        _HALVES,
    ),
    'substitute not on the bench': (
        [_team(1, [(1, '0')], substitutions=[{'playerIn': 9, 'playerOut': 1, 'minute': 70}])],
        _HALVES,
    ),
    'teams as a dict, two teams': (
        {'1': _team(1, [(1, '0')]), '2': _team(2, [(5, '0'), (6, '30')])},
        _HALVES,
    ),
    'a period with no time': (
        [_team(1, [(1, '0')])],
        [{'matchPeriod': '1H', 'eventSec': 45 * 60.0}, {'matchPeriod': '2H', 'eventSec': 0.0}],
    ),
}


@pytest.mark.parametrize('case', list(MINUTES_CASES))
def test_minutes_played_equals_jax(case):
    teams, events = MINUTES_CASES[case]
    got = loader._minutes_played(teams, events)
    assert len(got) > 0
    assert_same(got, jax_loader._minutes_played(teams, events))


# -- the v3 flattener ------------------------------------------------------------------------


def _v3_events():
    base_event = {'matchId': 9000, 'matchPeriod': '1H', 'team': {'id': 1, 'name': 'Home FC'}}
    return [
        {**base_event, 'id': 1, 'minute': 0, 'second': 10, 'player': {'id': 11, 'name': 'A'},
         'location': {'x': 50, 'y': 50}, 'type': {'primary': 'pass', 'secondary': []},
         'pass': {'accurate': True, 'endLocation': {'x': 62, 'y': 41}, 'height': None, 'length': 14.2}},
        {**base_event, 'id': 2, 'minute': 0, 'second': 16, 'player': {'id': 12, 'name': 'B'},
         'location': {'x': 62, 'y': 41}, 'type': {'primary': 'pass', 'secondary': ['cross', 'head_pass']},
         'pass': {'accurate': False, 'endLocation': {'x': 92, 'y': 30}, 'height': 'high', 'length': 30.0}},
        {**base_event, 'id': 3, 'minute': 1, 'second': 2, 'team': {'id': 2, 'name': 'Away FC'},
         'player': {'id': 21, 'name': 'C'}, 'location': {'x': 85, 'y': 48},
         'type': {'primary': 'shot', 'secondary': []},
         'shot': {'isGoal': 1, 'onTarget': True, 'goalZone': 'gc', 'xg': 0.31}},
        {**base_event, 'id': 4, 'matchPeriod': '2H', 'minute': 50, 'second': 30, 'player': None,
         'location': {'x': 40, 'y': 60}, 'type': {'primary': 'duel', 'secondary': ['ground_duel']},
         'groundDuel': {'duelType': 'dribble', 'takeOn': True, 'keptPossession': True, 'relatedDuelId': None}},
    ]


def test_flatten_v3_events_equals_jax():
    got = wyscout.flatten_v3_events(_v3_events())
    assert list(got['type_cross']) == [0, 1, 0, 0]
    assert_same(got, jax_wyscout.flatten_v3_events(_v3_events()))


@pytest.mark.parametrize('wrapped', [True, False])
def test_load_v3_events_equals_jax(tmp_path, wrapped):
    path = tmp_path / 'match.json'
    path.write_text(json.dumps({'events': _v3_events()} if wrapped else _v3_events()))
    got = wyscout.load_v3_events(str(path))
    assert len(got) == 4
    assert_same(got, jax_wyscout.load_v3_events(str(path)))


# -- bad feeds: errors and warnings alike ----------------------------------------------------


@pytest.fixture()
def api_root(tmp_path):
    for name in os.listdir(API_DIR):
        shutil.copy(os.path.join(API_DIR, name), tmp_path / name)
    return tmp_path


def _write(path, obj):
    path.write_text(json.dumps(obj))


# (what the root gets, the feeds, the call, the error class name or None)
API_ERROR_CASES = {
    'games index feed': (
        {'matches_2021.json': {'matches': [{'matchId': API_GAME}]}},
        {'games': 'matches_{season_id}.json', 'events': 'events_{game_id}.json'},
        lambda l: l.games(77, 2021), None,
    ),
    'missing detail file warns and skips': (
        {'matches_2021.json': {'matches': [{'matchId': API_GAME}, {'matchId': 555999}]}},
        {'games': 'matches_{season_id}.json', 'events': 'events_{game_id}.json'},
        lambda l: l.games(77, 2021), None,
    ),
    'missing seasons file warns and skips': (
        {'competitions.json': {'competitions': [{'wyId': 77}, {'wyId': 78}]}},
        API_FEEDS, lambda l: l.competitions(), None,
    ),
    'competitions from the seasons glob': (
        {}, {'seasons': 'seasons_*.json', 'events': 'events_{game_id}.json'},
        lambda l: l.competitions(), None,
    ),
    'malformed competitions feed': (
        {'competitions.json': {'not_competitions': []}}, API_FEEDS,
        lambda l: l.competitions(), 'ParseError',
    ),
    'malformed seasons feed': (
        {'seasons_77.json': {'seasons': []}}, API_FEEDS, lambda l: l.competitions(), 'ParseError',
    ),
    'malformed games feed': (
        {'matches_2021.json': {'wrong': True}},
        {'games': 'matches_{season_id}.json', 'events': 'events_{game_id}.json'},
        lambda l: l.games(77, 2021), 'ParseError',
    ),
    'malformed match detail': (
        {'events_555001.json': {'teams': {}}}, API_FEEDS, lambda l: l.games(77, 2021), 'ParseError',
    ),
    'events feed without events': (
        {'events_555001.json': {'match': {}}}, API_FEEDS, lambda l: l.events(API_GAME), 'ParseError',
    ),
    'teams feed without teams': (
        {'events_555001.json': {'match': {}}}, API_FEEDS, lambda l: l.teams(API_GAME), 'ParseError',
    ),
    'players feed without players': (
        {'events_555001.json': {'match': {}}}, API_FEEDS, lambda l: l.players(API_GAME), 'ParseError',
    ),
    'empty glob is missing data': (
        {}, {'seasons': 'nonexistent_*.json', 'events': 'events_{game_id}.json'},
        lambda l: l.competitions(), 'MissingDataError',
    ),
    'no events for the game': (
        {}, {'events': 'nothing_{game_id}.json'}, lambda l: l.games(77, 2021), 'MissingDataError',
    ),
}


@pytest.mark.parametrize('case', list(API_ERROR_CASES))
def test_api_feed_outcome_equals_jax(api_root, case):
    files, feeds, call, error = API_ERROR_CASES[case]
    for name, obj in files.items():
        _write(api_root / name, obj)
    got = assert_same_outcome(
        lambda: call(wyscout.WyscoutLoader(root=str(api_root), getter='local', feeds=feeds)),
        lambda: call(jax_wyscout.WyscoutLoader(root=str(api_root), getter='local', feeds=feeds)),
    )
    assert (got[1] or (None,))[0] == error
    if 'warns' in case:
        assert got[2] and got[2][0][0] == 'UserWarning'


def test_error_classes_are_the_ports():
    with pytest.raises(base.ParseError) as info:
        wyscout.WyscoutLoader(root=API_DIR, getter='local', feeds={
            'competitions': 'events_555001.json', 'events': 'events_{game_id}.json'}).competitions()
    assert not isinstance(info.value, jax_base.ParseError)
    with pytest.raises(base.MissingDataError):
        wyscout.WyscoutLoader(root=API_DIR, getter='local', feeds={'events': 'x_{game_id}.json'}).games(1, 2)


def test_public_substitute_not_on_the_bench_warns_alike(tmp_path):
    root = tmp_path / 'raw'
    shutil.copytree(PUBLIC_DIR, root)
    path = root / 'matches_World_Cup.json'
    matches = json.loads(path.read_text())
    team = next(iter(matches[0]['teamsData'].values()))
    team['formation']['substitutions'].append({'playerIn': 424242, 'playerOut': 101, 'minute': 80})
    _write(path, matches)
    got = assert_same_outcome(
        lambda: wyscout.PublicWyscoutLoader(root=str(root)).players(GAME_ID),
        lambda: jax_wyscout.PublicWyscoutLoader(root=str(root)).players(GAME_ID),
    )
    assert any('424242' in message for _, message in got[2])


def test_public_unknown_game_raises_alike(public):
    port, jax = public
    got = outcome(lambda: port.events(1))
    assert got[1] is not None and got[1:] == outcome(lambda: jax.events(1))[1:]
