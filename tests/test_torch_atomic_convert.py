"""The port's ``convert_to_atomic`` against the JAX package's and the golden
Atomic-SPADL snapshot.

The 200-action golden SPADL game (``tests/datasets/spadl/spadl.json``) and
the converted StatsBomb game 7584 go through both packages; the atomic
frames, and each stage's, must be equal exactly, dtypes included. The
port's frame also reproduces the reference's golden ``atomic_spadl.json``
as the JAX package's own test holds it.
"""

import os

import numpy as np
import pandas as pd
import pytest

from socceraction_tpu.atomic import spadl as jax_atomic
from socceraction_tpu.atomic.spadl import base as jax_base
from socceraction_tpu.data.statsbomb import StatsBombLoader
from socceraction_tpu.spadl import statsbomb as jax_statsbomb
from socceraction_tpu_torch.atomic import spadl as atomic
from socceraction_tpu_torch.atomic.spadl import base

STATSBOMB_DIR = os.path.join(os.path.dirname(__file__), 'datasets', 'statsbomb', 'raw')
STAGES = ['_extra_from_passes', '_extra_from_shots', '_extra_from_fouls']


def assert_same(got, want):
    pd.testing.assert_frame_equal(got, want, check_exact=True, check_dtype=True)


@pytest.fixture(scope='module')
def statsbomb_actions():
    events = StatsBombLoader(getter='local', root=STATSBOMB_DIR).events(7584)
    return jax_statsbomb.convert_to_actions(events, 782)


@pytest.fixture(params=['golden', 'statsbomb'])
def actions(request, spadl_actions, statsbomb_actions):
    return spadl_actions if request.param == 'golden' else statsbomb_actions


def test_atomic_all_equals_jax():
    assert atomic.__all__ == jax_atomic.__all__
    assert atomic.convert_to_atomic is base.convert_to_atomic


def test_convert_to_atomic_equals_jax(actions):
    got = atomic.convert_to_atomic(actions.copy())
    assert len(got) > len(actions)
    assert_same(got, jax_atomic.convert_to_atomic(actions.copy()))


@pytest.mark.parametrize('stage', STAGES)
def test_stage_equals_jax(actions, stage):
    assert_same(getattr(base, stage)(actions.copy()), getattr(jax_base, stage)(actions.copy()))


def test_column_stages_equal_jax(actions):
    frame = jax_base._extra_from_fouls(jax_base._extra_from_shots(jax_base._extra_from_passes(
        actions.copy())))
    converted = base._convert_columns(frame.copy())
    assert_same(converted, jax_base._convert_columns(frame.copy()))
    assert_same(base._simplify(converted.copy()), jax_base._simplify(converted.copy()))


def test_convert_to_atomic_matches_golden(spadl_actions, atomic_spadl_actions):
    """The JAX package's golden check, on the port's frame: the first 200
    atomic rows are the reference's snapshot."""
    got = atomic.convert_to_atomic(spadl_actions).head(200).reset_index(drop=True)
    want = atomic_spadl_actions.reset_index(drop=True)
    for col in ('type_id', 'bodypart_id', 'team_id', 'player_id', 'period_id'):
        assert list(got[col]) == list(want[col]), col
    for col in ('x', 'y', 'dx', 'dy', 'time_seconds'):
        np.testing.assert_allclose(got[col].to_numpy(), want[col].to_numpy(), atol=1e-6, err_msg=col)


def test_converted_frame_validates_and_names(actions):
    converted = atomic.convert_to_atomic(actions)
    assert len(atomic.AtomicSPADLSchema.validate(converted)) == len(converted)
    named = atomic.add_names(converted)
    assert named['type_name'].notna().all()
    assert_same(named, jax_atomic.add_names(jax_atomic.convert_to_atomic(actions)))
