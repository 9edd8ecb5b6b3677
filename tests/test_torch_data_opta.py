"""The port's Opta loader and feed parsers against the JAX package's.

The four loader layouts of ``tests/data/test_load_opta.py`` (XML, JSON,
StatsPerform, WhoScored) go through both packages' ``OptaLoader``: every
frame must equal the JAX package's exactly, dtypes included. Every
parser's ``extract_*`` records over its fixture feed, ``eventtypes_df``,
the loader's helpers and the spec engine's must equal the JAX package's,
and every error and warning must be alike.

Also held here, for ``chip_smoke.py``'s providers' phase, which runs on a
machine with neither pandas nor lxml:

- ``chip_smoke.PROVIDER_DIGESTS`` is the sha256 of the JAX package's
  parser records, so the card's machine provably parses what the JAX
  package parses;
- ``tests/datasets/port/provider_spadl.json`` is what both packages'
  loaders and converters give for the six fixture layouts, and
  ``pack_chain_games`` packs it as ``pack_actions`` packs the frames.
"""

import importlib.util
import json
import os
import warnings

import numpy as np
import pandas as pd
import pytest

import chip_smoke
from socceraction_tpu.data import base as jax_base
from socceraction_tpu.data import opta as jax_opta
from socceraction_tpu.data.opta import loader as jax_loader
from socceraction_tpu.data.opta import parsers as jax_parsers
from socceraction_tpu.data.opta.parsers import base as jax_pbase
from socceraction_tpu.data.opta.parsers import spec as jax_spec
from socceraction_tpu_torch.core.batch import pack_actions
from socceraction_tpu_torch.data import base
from socceraction_tpu_torch.data import opta
from socceraction_tpu_torch.data.opta import loader
from socceraction_tpu_torch.data.opta import parsers
from socceraction_tpu_torch.data.opta.parsers import base as pbase
from socceraction_tpu_torch.data.opta.parsers import spec

DATASETS = os.path.join(os.path.dirname(os.path.abspath(__file__)), 'datasets')
GAME = 501


def assert_same(got, want):
    pd.testing.assert_frame_equal(got, want, check_exact=True, check_dtype=True)


def outcome(fn):
    """``(result, error, warnings)`` of ``fn()``: the error as its class
    name and message, each warning as its category name and message."""
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter('always')
        try:
            result, error = fn(), None
        except Exception as e:  # noqa: BLE001 - the test compares what either package raises
            result, error = None, (type(e).__name__, str(e))
    return result, error, [(w.category.__name__, str(w.message)) for w in caught]


def _make_script():
    path = os.path.join(DATASETS, 'port', 'make_provider_spadl.py')
    spec_ = importlib.util.spec_from_file_location('make_provider_spadl', path)
    module = importlib.util.module_from_spec(spec_)
    spec_.loader.exec_module(module)
    return module


MAKE = _make_script()


def test_surfaces_equal_jax():
    assert opta.__all__ == jax_opta.__all__
    assert parsers.__all__ == jax_parsers.__all__
    assert loader.__all__ == jax_loader.__all__
    assert pbase.__all__ == jax_pbase.__all__
    assert spec.__all__ == jax_spec.__all__
    assert loader._EVENT_TYPES == jax_loader._EVENT_TYPES
    assert loader._DEFAULT_FEEDS == jax_loader._DEFAULT_FEEDS
    assert {k: {f: c.__name__ for f, c in v.items()} for k, v in loader._PARSER_SETS.items()} == {
        k: {f: c.__name__ for f, c in v.items()} for k, v in jax_loader._PARSER_SETS.items()}
    field, jax_field = vars(spec.Field('a', 'b', int)), vars(jax_spec.Field('a', 'b', int))
    assert isinstance(field.pop('default'), spec._Required)
    assert isinstance(jax_field.pop('default'), jax_spec._Required)
    assert field == jax_field
    for name in parsers.__all__:
        assert issubclass(getattr(opta, name), parsers.OptaParser)
        assert getattr(opta, name).__module__.startswith('socceraction_tpu_torch.')
    for name in opta.__all__:
        if name.endswith('Schema'):
            got, want = getattr(opta, name), getattr(jax_opta, name)
            assert list(got.fields) == list(want.fields) and got.strict == want.strict
            for field in want.fields:
                assert vars(got.fields[field]) == vars(want.fields[field]), (name, field)


def test_eventtypes_df_equals_jax():
    got = opta.eventtypes_df
    assert got is loader.eventtypes_df is loader._eventtypes_df()
    assert_same(got, jax_opta.eventtypes_df)
    with pytest.raises(AttributeError, match='no_such_frame'):
        opta.no_such_frame
    with pytest.raises(AttributeError, match='no_such_frame'):
        loader.no_such_frame


# -- the four loader layouts -----------------------------------------------------------------

LAYOUTS = ['opta_xml', 'opta_json', 'statsperform', 'whoscored']
METHODS = ['competitions', 'games', 'teams', 'players', 'events']


@pytest.fixture(scope='module')
def loaders():
    """Each Opta layout's loader in both packages, its competition and
    season ids (``tests/datasets/port/make_provider_spadl.py``)."""
    port, jax = MAKE.layouts('socceraction_tpu_torch'), MAKE.layouts('socceraction_tpu')
    return {layout: (port[layout][0], jax[layout][0], port[layout][1:3]) for layout in LAYOUTS}


@pytest.mark.parametrize('method', METHODS)
@pytest.mark.parametrize('layout', LAYOUTS)
def test_loader_frame_equals_jax(loaders, layout, method):
    if layout == 'opta_xml':
        pytest.importorskip('lxml')
    port, jax, season = loaders[layout]
    game = '501' if layout == 'statsperform' else GAME
    args = {'competitions': (), 'games': season}.get(method, (game,))
    got, want = outcome(lambda: getattr(port, method)(*args)), outcome(lambda: getattr(jax, method)(*args))
    assert got[1:] == want[1:]
    if want[0] is None:
        # WhoScored carries no competition feed: both packages raise alike
        assert (layout, method) == ('whoscored', 'competitions') and got[1][0] == 'SchemaError'
    else:
        assert len(got[0]) > 0
        assert_same(got[0], want[0])


# -- every parser's records ------------------------------------------------------------------

# the smoke's parsers, and the XML ones (lxml)
PARSERS = list(chip_smoke.PROVIDER_PARSERS) + [
    ('F7XMLParser', 'opta/f7-8-2017-501.xml', {'competition_id': 8, 'season_id': 2017, 'game_id': GAME}),
    ('F24XMLParser', 'opta/f24-8-2017-501.xml', {'competition_id': 8, 'season_id': 2017, 'game_id': GAME}),
]
PARSER_METHODS = [
    (name, rel, ids, method) for name, rel, ids in PARSERS
    for method in sorted(m for m in dir(getattr(jax_parsers, name)) if m.startswith('extract_'))
]


@pytest.mark.parametrize(('name', 'rel', 'ids', 'method'), PARSER_METHODS,
                         ids=[f'{n}.{m}' for n, _, _, m in PARSER_METHODS])
def test_parser_records_equal_jax(name, rel, ids, method):
    if 'XML' in name:
        pytest.importorskip('lxml')
    path = os.path.join(DATASETS, rel)
    assert sorted(m for m in dir(getattr(parsers, name)) if m.startswith('extract_')) == sorted(
        m for m in dir(getattr(jax_parsers, name)) if m.startswith('extract_'))
    got = getattr(getattr(parsers, name)(path, **ids), method)()
    want = getattr(getattr(jax_parsers, name)(path, **ids), method)()
    assert type(got) is type(want)
    assert got == want


def _edit(tmp_path, rel, change):
    """A copy of a fixture feed under ``tmp_path``, replaced by ``change(feed)``."""
    with open(os.path.join(DATASETS, rel), encoding='utf-8') as fh:
        obj = change(json.load(fh))
    path = tmp_path / os.path.basename(rel)
    path.write_text(json.dumps(obj))
    return str(path)


def _f9_doc(obj):
    return obj[0]['data']['OptaFeed']['OptaDocument'][0]


def mutated(fn):
    """A ``change`` that edits the feed in place with ``fn`` and keeps it."""
    return lambda obj: (fn(obj), obj)[1]


# (parser, fixture, change to the feed, ids, method, error class name or None)
PARSER_CASES = {
    'WhoScored ids not derivable': (
        'WhoScoredParser', 'whoscored/8-2017-501.json', lambda o: {'events': []}, {}, None, 'MissingDataError'),
    'WhoScored ids from the file': (
        'WhoScoredParser', 'whoscored/8-2017-501.json',
        mutated(lambda o: o.update(competition_id=8, season_id=2017, game_id=GAME)), {}, 'extract_games', None),
    'F9 without TeamData (team stats)': (
        'F9JSONParser', 'opta/f7-8-2017-501.json', mutated(lambda o: _f9_doc(o)['MatchData'].pop('TeamData')), {},
        'extract_teamgamestats', 'MissingDataError'),
    'F9 without TeamData (lineups)': (
        'F9JSONParser', 'opta/f7-8-2017-501.json', mutated(lambda o: _f9_doc(o)['MatchData'].pop('TeamData')), {},
        'extract_lineups', 'MissingDataError'),
    'F9 with an unknown player': (
        'F9JSONParser', 'opta/f7-8-2017-501.json',
        mutated(lambda o: _f9_doc(o)['Team'][0]['Player'][0]['PersonName']['nameObj'].update(is_unknown=True)), {},
        'extract_players', None),
    'F9 without an OptaDocument': (
        'F9JSONParser', 'opta/f7-8-2017-501.json', lambda o: [{'data': {'Else': {}}}], {}, 'extract_games',
        'MissingDataError'),
    'F24 without Games': (
        'F24JSONParser', 'opta/f7-8-2017-501.json', lambda o: [{'data': {'Else': {}}}], {}, 'extract_events',
        'MissingDataError'),
    'F1 without an OptaDocument': (
        'F1JSONParser', 'opta/tournament-2017-8.json', lambda o: [{'data': {'Else': {}}}], {},
        'extract_competitions', 'MissingDataError'),
    'MA1 as a match list': (
        'MA1JSONParser', 'statsperform/ma1-8-2017.json', lambda o: {'match': [o]}, {}, 'extract_players', None),
    'MA1 with neither matchInfo nor match': (
        'MA1JSONParser', 'statsperform/ma1-8-2017.json', lambda o: {'else': 1}, {}, 'extract_games',
        'MissingDataError'),
    'MA3 without matchInfo': (
        'MA3JSONParser', 'statsperform/ma3-8-2017-501.json', mutated(lambda o: o.pop('matchInfo')), {}, 'extract_events',
        'MissingDataError'),
    'MA3 without liveData': (
        'MA3JSONParser', 'statsperform/ma3-8-2017-501.json', mutated(lambda o: o.pop('liveData')), {}, 'extract_players',
        'MissingDataError'),
    'MA3 event without a type': (
        'MA3JSONParser', 'statsperform/ma3-8-2017-501.json', mutated(lambda o: o['liveData']['event'][0].pop('typeId')),
        {}, 'extract_events', 'AssertionError'),
}


@pytest.mark.parametrize('case', list(PARSER_CASES))
def test_parser_outcome_equals_jax(tmp_path, case):
    name, rel, change, ids, method, error = PARSER_CASES[case]
    path = _edit(tmp_path, rel, change)

    def run(module):
        parser = getattr(module, name)(path, **ids)
        return getattr(parser, method)() if method else parser

    got, want = outcome(lambda: run(parsers)), outcome(lambda: run(jax_parsers))
    assert got[1:] == want[1:]
    assert (got[1] or (None,))[0] == error
    if error is None and method:
        assert got[0] == want[0] and len(got[0]) > 0


# -- the loader's options and helpers ---------------------------------------------------------

LOADER_CASES = {
    'unknown parser name': lambda m: m.OptaLoader(root='.', parser='nope'),
    'parser of another type': lambda m: m.OptaLoader(root='.', parser=42),
    'parser map without feeds': lambda m: m.OptaLoader(root='.', parser={'f24': m.F24JSONParser}),
    'unknown feed': lambda m: sorted(m.OptaLoader(root='.', parser='xml', feeds={'f42': 'f42-{game_id}.xml'}).parsers),
    'custom parser map': lambda m: {
        f: c.__name__ for f, c in m.OptaLoader(
            root='.', parser={'f24': m.F24JSONParser, 'f9': m.F9JSONParser},
            feeds={'f24': 'a-{game_id}.json', 'f99': 'b-{game_id}.json'}).parsers.items()},
    'default feeds': lambda m: {p: m.OptaLoader(root='.', parser=p).feeds for p in
                                ('xml', 'json', 'statsperform', 'whoscored')},
}


@pytest.mark.parametrize('case', list(LOADER_CASES))
def test_loader_options_equal_jax(case):
    got, want = outcome(lambda: LOADER_CASES[case](opta)), outcome(lambda: LOADER_CASES[case](jax_opta))
    assert got == want
    if 'parser' in case and case != 'custom parser map':
        assert got[1] == ('ValueError', want[1][1])
    if case == 'unknown feed':
        assert got[2] and got[2][0][0] == 'UserWarning'


@pytest.mark.parametrize(('path', 'pattern'), [
    ('/data/f24-8-2017-501.json', 'f24-{competition_id}-{season_id}-{game_id}.json'),
    ('/data/tournament-2017-8.json', 'tournament-{season_id}-{competition_id}.json'),
    ('/data/ma3-8-2017-abc_1.json', 'ma3-{competition_id}-{season_id}-{game_id}.json'),
    ('/data/other.json', 'f24-{competition_id}-{season_id}-{game_id}.json'),
])
def test_extract_ids_from_path_equals_jax(path, pattern):
    got = outcome(lambda: loader._extract_ids_from_path(path, pattern))
    assert got == outcome(lambda: jax_loader._extract_ids_from_path(path, pattern))


def test_deepupdate_equals_jax():
    def draw():
        return ({'a': [1], 'b': {'c': 1, 'd': [2]}, 'e': {1, 2}, 'f': 'x'},
                {'a': [3], 'b': {'c': 5, 'd': [4], 'g': {'h': 1}}, 'e': {3}, 'f': 'y', 'i': [7]})

    got, src = draw()
    want, jsrc = draw()
    loader._deepupdate(got, src)
    jax_loader._deepupdate(want, jsrc)
    assert got == want
    assert got['b']['g'] is not src['b']['g']  # merged values are copies


# -- the parsers' shared helpers and the spec engine -------------------------------------------


@pytest.mark.parametrize('qualifiers', [
    {140: '62.5', 141: '41.0'}, {146: '88.0', 147: '52.0'}, {102: '48.0'}, {}, {140: 'junk', 141: 'junk'},
    {140: '0', 141: '0'},
])
def test_end_coordinates_equal_jax(qualifiers):
    assert pbase._get_end_x(qualifiers) == jax_pbase._get_end_x(qualifiers)
    assert pbase._get_end_y(qualifiers) == jax_pbase._get_end_y(qualifiers)
    record = {'qualifiers': qualifiers, 'start_x': 33.0, 'start_y': 44.0}
    assert pbase._derive_end_x(record, None) == jax_pbase._derive_end_x(record, None)
    assert pbase._derive_end_y(record, None) == jax_pbase._derive_end_y(record, None)


@pytest.mark.parametrize(('fn', 'args'), [
    ('assertget', ({'a': 1}, 'a')),
    ('assertget', ({'a': 1}, 'missing')),
    ('assertget', ({'a': None}, 'a')),
    ('_team_on_side', ([{'position': 'home', 'id': 't1'}, {'position': 'away', 'id': 't2'}], 'away')),
    ('_team_on_side', ([{'position': 'home', 'id': 't1'}], 'away')),
    ('_team_on_side', ([{'id': 't1'}], 'home')),
])
def test_base_helpers_equal_jax(fn, args):
    assert outcome(lambda: getattr(pbase, fn)(*args)) == outcome(lambda: getattr(jax_pbase, fn)(*args))


def _spec_cases(m):
    nested = {'id': '7', 'nest': {'deep': {'x': '3.5'}}, 'outcome': '0', 'ref': 'g123456'}
    return {
        'cast and path walk': lambda: m.extract_record(
            nested, (m.Field('event_id', 'id', int), m.Field('x', ('nest', 'deep', 'x'), float))),
        'missing required': lambda: m.extract_record({}, (m.Field('event_id', 'id', int),)),
        'explicit null': lambda: m.extract_record({'id': None}, (m.Field('event_id', 'id', int),)),
        'path through a leaf': lambda: m.extract_record(nested, (m.Field('x', ('id', 'x'), default=None),)),
        'default never cast': lambda: [
            m.extract_record(raw, (m.Field('outcome', 'outcome', m.flag, default=True),))
            for raw in ({}, nested)],
        'seed and derived': lambda: m.extract_record(
            {'x': '10'}, (m.Field('start_x', 'x', float),
                          m.derived('end_x', lambda rec, raw: rec['qualifiers'].get(140, rec['start_x']))),
            seed={'qualifiers': {140: 55.0}}),
        'no src, no derive': lambda: m.extract_record({}, (m.Field('x'),)),
        'ref_id and flag': lambda: m.extract_record(nested, (m.Field('game_id', 'ref', m.ref_id),
                                                             m.Field('ok', 'outcome', m.flag))),
        'ts fallback': lambda: [m.ts('%Y-%m-%dT%H:%M:%S.%fZ', '%Y-%m-%dT%H:%M:%SZ')(v)
                                for v in ('2018-06-14T15:00:00.123Z', '2018-06-14T15:00:00Z')],
        'ts strips the offset': lambda: m.ts('%Y%m%dT%H%M%S%z')('20180614T150000+0200'),
        'ts no format fits': lambda: m.ts('%Y-%m-%dT%H:%M:%S.%fZ', '%Y-%m-%dT%H:%M:%SZ')('June 14th'),
        'flag of ints': lambda: [m.flag(1), m.flag(0), m.flag('1')],
    }


@pytest.mark.parametrize('case', list(_spec_cases(spec)))
def test_spec_engine_equals_jax(case):
    got, want = outcome(_spec_cases(spec)[case]), outcome(_spec_cases(jax_spec)[case])
    assert got == want


# -- what the card's machine parses and rates --------------------------------------------------


def test_provider_digests_are_the_jax_parsers():
    want = chip_smoke.provider_digests(jax_parsers)
    assert {name: r['digest'] for name, r in want.items()} == chip_smoke.PROVIDER_DIGESTS
    assert chip_smoke.provider_digests(parsers) == want
    assert [name for name, _, _ in chip_smoke.PROVIDER_PARSERS] == list(chip_smoke.PROVIDER_DIGESTS)


def test_provider_digest_sees_one_changed_value():
    name, rel, ids = chip_smoke.PROVIDER_PARSERS[-1]
    records = chip_smoke.parser_records(jax_parsers, name, os.path.join(chip_smoke.DATASETS, rel), ids)
    assert chip_smoke.provider_digest(records) == chip_smoke.PROVIDER_DIGESTS[name]
    key = next(iter(records['extract_events']))
    records['extract_events'][key]['start_x'] += 1e-9
    assert chip_smoke.provider_digest(records) != chip_smoke.PROVIDER_DIGESTS[name]


def test_canonical_form():
    from datetime import datetime

    got = chip_smoke.canonical({(2, 'b'): {'z': 1, 'a': datetime(2017, 8, 11, 19, 45)}, (1, 'a'): [1.5, None]})
    assert got == [[[1, 'a'], [1.5, None]], [[2, 'b'], [['a', '2017-08-11T19:45:00'], ['z', 1]]]]
    with pytest.raises(TypeError):
        chip_smoke.canonical({'x': object()})


@pytest.fixture(scope='module')
def provider_frames():
    pytest.importorskip('lxml')
    return {package: MAKE.provider_actions(package) for package in ('socceraction_tpu_torch', 'socceraction_tpu')}


def test_provider_spadl_file_is_both_packages_actions(provider_frames):
    port, jax = provider_frames['socceraction_tpu_torch'], provider_frames['socceraction_tpu']
    assert list(port) == list(jax) == list(chip_smoke.PROVIDER_ACTIONS)
    with open(chip_smoke.PROVIDER_SPADL) as fh:
        stored = json.load(fh)
    assert list(stored) == list(jax)
    for layout, (home, actions) in jax.items():
        assert port[layout][0] == home
        assert_same(port[layout][1], actions)
        assert len(actions) == chip_smoke.PROVIDER_ACTIONS[layout]
        assert stored[layout] == MAKE.provider_record(home, actions), layout


def test_provider_batch_packs_as_pack_actions(provider_frames):
    games = chip_smoke.provider_games()
    batch = chip_smoke.pack_chain_games([g['columns'] for g in games.values()],
                                        [g['home_team_id'] for g in games.values()], 'cpu')
    # the frames, one game id a layout (three layouts share game 501), and
    # every team id as text: StatsPerform's are text, and pack_actions holds
    # the games' home ids in one numpy array
    layouts = list(provider_frames['socceraction_tpu'].values())
    frames = [actions.assign(game_id=i, team_id=actions['team_id'].astype(str))
              for i, (_, actions) in enumerate(layouts)]
    homes = {i: str(home) for i, (home, _) in enumerate(layouts)}
    want, game_ids = pack_actions(pd.concat(frames, ignore_index=True), homes, device='cpu')
    assert game_ids == list(range(len(frames)))
    for name, value in want.fields().items():
        got = getattr(batch, name)
        assert got.dtype == value.dtype and got.shape == value.shape, name
        assert np.array_equal(got.numpy(), value.numpy()), name
    assert int(batch.is_home.sum()) > 0 and not bool(batch.is_home.all())


def test_error_classes_are_the_ports():
    with pytest.raises(base.MissingDataError) as info:
        pbase._team_on_side([], 'home')
    assert not isinstance(info.value, jax_base.MissingDataError)
