"""The port's Wyscout-v3 xT (``xthreat_v3``) against the JAX package's.

A seeded v3 frame covering all six move primaries, shots and other
events (made with numpy, as the JAX package's ``tests/test_xthreat_v3.py``
makes its own): the encoding, selectors and matrices equal JAX's; the
oracle's fits and ratings equal JAX's pandas backend; the port's device
backend is held to its own oracle within 1e-5; saved surfaces load in
either package.
"""

import numpy as np
import pandas as pd
import pytest
import torch

from socceraction_tpu import xthreat_v3 as jv3
from socceraction_tpu_torch import xthreat_v3 as tv3


@pytest.fixture(scope='module', params=[7, 11])
def v3_frame(request):
    rng = np.random.default_rng(request.param)
    n = 2400
    primaries = rng.choice(
        list(tv3.MOVE_PRIMARIES) + ['shot', 'infraction', 'shot_against'],
        size=n, p=[0.12] * 6 + [0.14, 0.07, 0.07],
    )
    is_shot = primaries == 'shot'
    frame = pd.DataFrame({
        'type_primary': primaries,
        'result': rng.integers(0, 2, size=n),
        'shot_is_goal': np.where(is_shot, rng.integers(0, 2, size=n), 0),
        'start_x': rng.uniform(0, 105, size=n),
        'start_y': rng.uniform(0, 68, size=n),
        'end_x': rng.uniform(0, 105, size=n),
        'end_y': rng.uniform(0, 68, size=n),
        'game_id': np.repeat(np.arange(4), n // 4),
    })
    frame.loc[is_shot, 'start_x'] = rng.uniform(85, 105, size=int(is_shot.sum()))
    return frame


def test_exports_equal_jax():
    assert tv3.__all__ == jv3.__all__
    assert tv3.ExpectedThreat is tv3.ExpectedThreatV3
    assert tv3.MOVE_PRIMARIES == jv3.MOVE_PRIMARIES


def test_encoding_and_selectors_equal_jax(v3_frame):
    pd.testing.assert_frame_equal(tv3.encode_v3_actions(v3_frame), jv3.encode_v3_actions(v3_frame))
    no_goal_column = v3_frame.drop(columns=['shot_is_goal'])
    pd.testing.assert_frame_equal(
        tv3.encode_v3_actions(no_goal_column), jv3.encode_v3_actions(no_goal_column)
    )
    for fn in ('get_move_actions', 'get_successful_move_actions'):
        pd.testing.assert_frame_equal(getattr(tv3, fn)(v3_frame), getattr(jv3, fn)(v3_frame))


@pytest.mark.parametrize('grid', [(16, 12), (8, 6)])
def test_matrices_equal_jax(v3_frame, grid):
    l, w = grid
    np.testing.assert_array_equal(tv3.scoring_prob(v3_frame, l, w), jv3.scoring_prob(v3_frame, l, w))
    for got, want in zip(tv3.action_prob(v3_frame, l, w), jv3.action_prob(v3_frame, l, w)):
        np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(
        tv3.move_transition_matrix(v3_frame, l, w), jv3.move_transition_matrix(v3_frame, l, w)
    )


@pytest.mark.parametrize('solver', ['dense', 'matrix-free'])
def test_oracle_equals_jax_and_the_device_backend_is_held_to_it(v3_frame, solver):
    want = jv3.ExpectedThreatV3(backend='pandas', solver=solver).fit(v3_frame)
    oracle = tv3.ExpectedThreatV3(backend='pandas', solver=solver).fit(v3_frame)
    np.testing.assert_array_equal(oracle.xT, want.xT)
    assert oracle.n_iter == want.n_iter
    for interp in (False, True):
        np.testing.assert_array_equal(oracle.rate(v3_frame, interp), want.rate(v3_frame, interp))
    device = tv3.ExpectedThreatV3(solver=solver, device='cpu').fit(v3_frame)
    np.testing.assert_allclose(device.xT, oracle.xT, rtol=0, atol=1e-5)
    assert abs(device.n_iter - oracle.n_iter) <= 1
    got, ref = device.rate(v3_frame), oracle.rate(v3_frame)
    np.testing.assert_array_equal(np.isnan(got), np.isnan(ref))
    np.testing.assert_allclose(got[~np.isnan(ref)], ref[~np.isnan(ref)], rtol=0, atol=1e-5)


def test_surfaces_move_between_the_packages(v3_frame, tmp_path, monkeypatch):
    jmodel = jv3.ExpectedThreatV3(backend='pandas').fit(v3_frame)
    jmodel.save_model(str(tmp_path / 'jax.json'))
    oracle = tv3.load_model(str(tmp_path / 'jax.json'), backend='pandas')
    assert isinstance(oracle, tv3.ExpectedThreatV3) and oracle.backend == 'pandas'
    np.testing.assert_array_equal(oracle.rate(v3_frame), jmodel.rate(v3_frame))
    device = tv3.load_model(str(tmp_path / 'jax.json'), device='cpu')
    assert device.backend == 'torch' and device.device == torch.device('cpu')
    device.save_model(str(tmp_path / 'port.json'))
    np.testing.assert_array_equal(jv3.load_model(str(tmp_path / 'port.json'), backend='pandas').xT, jmodel.xT)
    monkeypatch.setattr(torch.cuda, 'is_available', lambda: False)
    with pytest.raises(RuntimeError, match='device="cpu"'):
        tv3.load_model(str(tmp_path / 'jax.json'))
