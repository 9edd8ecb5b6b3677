"""The port's SPADL converters against the JAX package's.

The same provider events go through ``socceraction_tpu.spadl.<provider>``
and ``socceraction_tpu_torch.spadl.<provider>``; the frames must be equal
exactly, dtypes included:

- StatsBomb game 7584, with events from both packages' loaders;
- the Wyscout public World Cup game, events from the JAX
  ``PublicWyscoutLoader``;
- the Opta F24/F7 game, events from the JAX ``OptaLoader``;
- the Wyscout v3 events of ``tests/spadl/test_wyscout_v3.py``;
- every public Wyscout stage, on the input the JAX converter hands it;
- the columnar decision tables on seeded numpy draws over the fuzz space
  of ``tests/spadl/test_fuzz_oracles.py``;
- the deprecated re-exports.
"""

import importlib
import importlib.util
import inspect
import os
import pickle
import warnings

import numpy as np
import pandas as pd
import pytest

from socceraction_tpu import spadl as jax_spadl
from socceraction_tpu.data.opta import OptaLoader
from socceraction_tpu.data.statsbomb import StatsBombLoader as JaxStatsBombLoader
from socceraction_tpu.data.wyscout import PublicWyscoutLoader
from socceraction_tpu.spadl import base as jax_base
from socceraction_tpu.spadl import opta as jax_opta
from socceraction_tpu.spadl import statsbomb as jax_statsbomb
from socceraction_tpu.spadl import wyscout as jax_wyscout
from socceraction_tpu.spadl import wyscout_v3 as jax_wyscout_v3
from socceraction_tpu_torch import spadl
from socceraction_tpu_torch.data.statsbomb import StatsBombLoader
from socceraction_tpu_torch.spadl import base, opta, statsbomb, wyscout, wyscout_v3

HERE = os.path.dirname(__file__)
DATASETS = os.path.join(HERE, 'datasets')
STATSBOMB_DIR = os.path.join(DATASETS, 'statsbomb', 'raw')
WYSCOUT_DIR = os.path.join(DATASETS, 'wyscout_public', 'raw')


def _test_module(name):
    """A module of ``tests/spadl`` (not a package), loaded by path."""
    spec = importlib.util.spec_from_file_location(
        f'_torch_convert_{name}', os.path.join(HERE, 'spadl', f'{name}.py')
    )
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


FUZZ = _test_module('test_fuzz_oracles')
COMPAT = _test_module('test_compat')
V3 = _test_module('test_wyscout_v3')


def _copy(obj):
    """A deep copy, nested dicts and lists in object columns included."""
    return pickle.loads(pickle.dumps(obj))


def assert_same(got, want):
    if isinstance(want, pd.DataFrame):
        pd.testing.assert_frame_equal(got, want, check_exact=True, check_dtype=True)
    elif isinstance(want, pd.Series):
        pd.testing.assert_series_equal(got, want, check_exact=True, check_dtype=True)
    else:
        np.testing.assert_array_equal(np.asarray(got), np.asarray(want))
        assert np.asarray(got).dtype == np.asarray(want).dtype


# -- the packages' surfaces ------------------------------------------------------------


def test_spadl_all_equals_jax():
    assert spadl.__all__ == jax_spadl.__all__
    for name in ('statsbomb', 'wyscout', 'wyscout_v3', 'opta'):
        assert getattr(spadl, name).convert_to_actions.__module__.startswith('socceraction_tpu_torch.')


@pytest.mark.parametrize('module', ['wyscout', 'wyscout_v3', 'opta', 'statsbomb'])
def test_converter_all_equals_jax(module):
    assert getattr(spadl, module).__all__ == getattr(jax_spadl, module).__all__


# -- shared passes ---------------------------------------------------------------------


@pytest.fixture(scope='module')
def statsbomb_actions():
    events = JaxStatsBombLoader(getter='local', root=STATSBOMB_DIR).events(7584)
    return jax_statsbomb.convert_to_actions(events, 782)


@pytest.mark.parametrize('fn', ['_fix_clearances', '_add_dribbles'])
def test_base_passes_equal_jax(statsbomb_actions, fn):
    frame = statsbomb_actions.drop(columns=['original_event_id'])
    assert_same(getattr(base, fn)(frame.copy()), getattr(jax_base, fn)(frame.copy()))


@pytest.mark.parametrize('home', [782, 778, 1])
def test_fix_direction_of_play_equals_jax(statsbomb_actions, home):
    assert_same(
        base._fix_direction_of_play(statsbomb_actions.copy(), home),
        jax_base._fix_direction_of_play(statsbomb_actions.copy(), home),
    )


def test_single_event_equals_jax(statsbomb_actions):
    row = statsbomb_actions.iloc[3]
    assert_same(base._single_event(row), jax_base._single_event(row))
    assert base._single_event(statsbomb_actions) is statsbomb_actions


# -- the providers' games --------------------------------------------------------------


@pytest.mark.parametrize('loader', ['jax', 'port'])
def test_statsbomb_game_equals_jax(loader):
    cls = JaxStatsBombLoader if loader == 'jax' else StatsBombLoader
    events = cls(getter='local', root=STATSBOMB_DIR).events(7584)
    want = jax_statsbomb.convert_to_actions(_copy(events), 782)
    got = statsbomb.convert_to_actions(_copy(events), 782)
    assert len(got) > 0
    assert_same(got, want)


@pytest.fixture(scope='module')
def wyscout_events():
    return PublicWyscoutLoader(root=WYSCOUT_DIR, download=False).events(2058007)


@pytest.mark.parametrize('home', [5629, 12913])
def test_wyscout_game_equals_jax(wyscout_events, home):
    want = jax_wyscout.convert_to_actions(_copy(wyscout_events), home)
    got = wyscout.convert_to_actions(_copy(wyscout_events), home)
    assert len(got) > 0
    assert_same(got, want)


@pytest.mark.parametrize('home', [100, 200])
def test_opta_game_equals_jax(home):
    loader = OptaLoader(
        root=os.path.join(DATASETS, 'opta'), parser='xml',
        feeds={'f7': 'f7-{competition_id}-{season_id}-{game_id}.xml',
               'f24': 'f24-{competition_id}-{season_id}-{game_id}.xml'},
    )
    events = loader.events(501)
    want = jax_opta.convert_to_actions(_copy(events), home)
    got = opta.convert_to_actions(_copy(events), home)
    assert len(got) > 0
    assert_same(got, want)


@pytest.fixture(scope='module')
def v3_events():
    return V3.v3_events.__wrapped__()


@pytest.mark.parametrize('home', [V3.HOME, V3.AWAY, None])
def test_wyscout_v3_events_equal_jax(v3_events, home):
    want = jax_wyscout_v3.convert_to_actions(_copy(v3_events), home)
    got = wyscout_v3.convert_to_actions(_copy(v3_events), home)
    assert len(got) > 0
    assert_same(got, want)


def test_wyscout_v3_without_home_raises_as_jax(v3_events):
    frame = v3_events.drop(columns=['home_team_id'])
    with pytest.raises(ValueError, match='home_team_id must be given'):
        jax_wyscout_v3.convert_to_actions(frame)
    with pytest.raises(ValueError, match='home_team_id must be given'):
        wyscout_v3.convert_to_actions(frame)


def test_wyscout_v3_add_expected_assists_equals_jax(v3_events):
    assert_same(wyscout_v3.add_expected_assists(_copy(v3_events)),
                jax_wyscout_v3.add_expected_assists(_copy(v3_events)))


# -- every public Wyscout stage, on the input the JAX converter hands it ----------------


def _record_stages(module, names, run):
    """Run ``run()`` with each of ``module``'s stages ``names`` recording a
    copy of its first input; returns {name: input}."""
    seen = {}
    saved = {name: getattr(module, name) for name in names}

    def recorder(name, fn):
        def wrapped(arg, *args, **kwargs):
            seen.setdefault(name, _copy(arg))
            return fn(arg, *args, **kwargs)
        return wrapped

    try:
        for name, fn in saved.items():
            setattr(module, name, recorder(name, fn))
        run()
    finally:
        for name, fn in saved.items():
            setattr(module, name, fn)
    return seen


@pytest.fixture(scope='module')
def wyscout_stage_inputs(wyscout_events):
    names = [n for n in COMPAT.REFERENCE_WYSCOUT_STAGES if not n.startswith('determine_')]
    seen = _record_stages(jax_wyscout, names,
                          lambda: jax_wyscout.convert_to_actions(_copy(wyscout_events), 5629))
    seen['get_tagsdf'] = _copy(wyscout_events)
    return seen


@pytest.fixture(scope='module')
def wyscout_v3_stage_inputs(v3_events):
    names = [n for n in COMPAT.REFERENCE_WYSCOUT_V3_STAGES if not n.startswith('determine_')]
    return _record_stages(jax_wyscout_v3, names,
                          lambda: jax_wyscout_v3.convert_to_actions(_copy(v3_events), V3.HOME))


@pytest.mark.parametrize('name', [n for n in COMPAT.REFERENCE_WYSCOUT_STAGES if not n.startswith('determine_')])
def test_wyscout_stage_equals_jax(wyscout_stage_inputs, name):
    frame = wyscout_stage_inputs[name]  # the JAX converter calls every stage
    assert_same(getattr(wyscout, name)(_copy(frame)), getattr(jax_wyscout, name)(_copy(frame)))


@pytest.mark.parametrize('name', [n for n in COMPAT.REFERENCE_WYSCOUT_V3_STAGES if not n.startswith('determine_')])
def test_wyscout_v3_stage_equals_jax(wyscout_v3_stage_inputs, name):
    frame = wyscout_v3_stage_inputs[name]
    assert_same(getattr(wyscout_v3, name)(_copy(frame)), getattr(jax_wyscout_v3, name)(_copy(frame)))


@pytest.mark.parametrize('name', ['determine_type_id', 'determine_result_id', 'determine_bodypart_id'])
def test_wyscout_row_wise_stages_equal_jax(wyscout_stage_inputs, name):
    events = wyscout_stage_inputs['create_df_actions']
    for i in range(0, len(events), 7):
        row = events.iloc[i]
        assert getattr(wyscout, name)(row) == getattr(jax_wyscout, name)(row), (name, i)


@pytest.mark.parametrize('name', ['determine_type_id', 'determine_result_id', 'determine_bodypart_id'])
def test_wyscout_v3_row_wise_stages_equal_jax(name):
    frame = FUZZ._v3_fuzz_frame(seed=3, n=60)
    for i in range(len(frame)):
        row = frame.iloc[i]
        assert getattr(wyscout_v3, name)(row) == getattr(jax_wyscout_v3, name)(row), (name, i)


# -- the decision tables on seeded draws over the fuzz space -----------------------------

SEEDS = [0, 1, 2, 3, 4]


@pytest.mark.parametrize('seed', SEEDS)
def test_wyscout_tables_equal_jax(seed):
    frame = FUZZ._wy2_fuzz_frame(seed=seed, n=2000)
    for fn in ('_type_ids', '_result_ids', '_bodypart_ids'):
        assert_same(getattr(wyscout, fn)(frame.copy()), getattr(jax_wyscout, fn)(frame.copy()))


@pytest.mark.parametrize('seed', SEEDS)
def test_wyscout_v3_tables_equal_jax(seed):
    frame = FUZZ._v3_fuzz_frame(seed=seed, n=2000)
    primary = jax_wyscout_v3._str_col(frame, 'type_primary')
    assert_same(wyscout_v3._str_col(frame, 'type_primary'), primary)
    types = jax_wyscout_v3._determine_type_ids(frame, primary)
    assert_same(wyscout_v3._determine_type_ids(frame, primary), types)
    assert_same(wyscout_v3._determine_result_ids(frame, primary, types),
                jax_wyscout_v3._determine_result_ids(frame, primary, types))
    assert_same(wyscout_v3._determine_bodypart_ids(frame, primary),
                jax_wyscout_v3._determine_bodypart_ids(frame, primary))


def _opta_draw(seed, n=2000):
    """The fuzz test's Opta draw (event names, tri-state outcomes and
    qualifier sets) at ``seed``."""
    rng = np.random.default_rng(seed)
    names = pd.Series(rng.choice(FUZZ._OPTA_NAMES, size=n))
    outcomes = [[True, False, None][i] for i in rng.integers(0, 3, size=n)]
    quals = []
    for _ in range(n):
        ids = [qid for qid in FUZZ._OPTA_QUALIFIERS if rng.random() < 0.25]
        if rng.random() < 0.2:
            ids.append(999)
        quals.append({qid: '1' for qid in ids})
    return names, outcomes, pd.Series(quals)


@pytest.mark.parametrize('seed', SEEDS)
def test_opta_tables_equal_jax(seed):
    names, outcomes, quals = _opta_draw(seed)
    n = len(names)
    outcome_false = np.fromiter((v is False for v in outcomes), bool, count=n)
    outcome_truthy = np.fromiter((bool(v) for v in outcomes), bool, count=n)
    masks = jax_opta._qualifier_masks(quals, FUZZ._OPTA_QUALIFIERS)
    got_masks = opta._qualifier_masks(quals, FUZZ._OPTA_QUALIFIERS)
    assert sorted(got_masks) == sorted(masks)
    for qid in masks:
        assert_same(got_masks[qid], masks[qid])
    assert_same(opta._determine_type(names, outcome_false, masks),
                jax_opta._determine_type(names, outcome_false, masks))
    assert_same(opta._determine_result(names, outcome_truthy, masks),
                jax_opta._determine_result(names, outcome_truthy, masks))


# -- deprecated re-exports ---------------------------------------------------------------

STATSBOMB_NAMES = ['StatsBombLoader', 'extract_player_games', 'StatsBombCompetitionSchema',
                   'StatsBombGameSchema', 'StatsBombPlayerSchema', 'StatsBombTeamSchema',
                   'StatsBombEventSchema']


@pytest.mark.parametrize('name', STATSBOMB_NAMES)
def test_statsbomb_reexport_warns_and_resolves_to_the_port(name):
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter('always')
        obj = getattr(statsbomb, name)
    assert any(issubclass(w.category, DeprecationWarning) for w in caught)
    assert obj is getattr(importlib.import_module('socceraction_tpu_torch.data.statsbomb'), name)


def _deprecated_names(module):
    """The names a converter module forwards to its data subpackage."""
    return inspect.getclosurevars(module.__getattr__).nonlocals['names']


LOADER_NAMES = [(module, name) for module in (opta, wyscout) for name in _deprecated_names(module)]


@pytest.mark.parametrize(('module', 'name'), LOADER_NAMES,
                         ids=[f'{m.__name__.rsplit(".", 1)[1]}.{n}' for m, n in LOADER_NAMES])
def test_loader_reexport_warns_and_resolves_to_the_port(module, name):
    provider = module.__name__.rsplit('.', 1)[1]
    assert _deprecated_names(module) == _deprecated_names(getattr(jax_spadl, provider))
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter('always')
        obj = getattr(module, name)
    assert any(issubclass(w.category, DeprecationWarning) and f'socceraction_tpu_torch.data.{provider}.{name}'
               in str(w.message) for w in caught)
    assert obj is getattr(importlib.import_module(f'socceraction_tpu_torch.data.{provider}'), name)
    assert obj.__module__.startswith('socceraction_tpu_torch.')


@pytest.mark.parametrize('module', [statsbomb, opta, wyscout])
def test_unknown_attribute_still_raises(module):
    with pytest.raises(AttributeError, match='NoSuchThing'):
        module.NoSuchThing
