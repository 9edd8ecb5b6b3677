"""xT's numpy oracle (``ExpectedThreat(backend='pandas')``) on the port.

The oracle's module functions and fits equal the JAX package's pandas
backend exactly on the same SPADL frames: the golden game and a season
of synthetic games (the JAX package's ``synthetic_actions_frame``, used
only to make inputs). The port's device backend (``'torch'``, on the CPU
here) is held to its own oracle: grids and ratings within 1e-5,
probability matrices within 1e-6, sweeps within one. The oracle needs no
device.
"""

import json

import numpy as np
import pandas as pd
import pytest
import torch

from socceraction_tpu import xthreat as jxt
from socceraction_tpu.core.synthetic import synthetic_actions_frame
from socceraction_tpu_torch import xthreat as txt
from socceraction_tpu_torch.core.batch import pack_actions


@pytest.fixture(scope='module', params=['golden', 'season'])
def actions(request, spadl_actions):
    if request.param == 'golden':
        return spadl_actions
    return pd.concat(
        [synthetic_actions_frame(g, n_actions=1600, seed=g) for g in range(1, 5)],
        ignore_index=True,
    )


@pytest.mark.parametrize('fn', ['get_move_actions', 'get_successful_move_actions'])
def test_move_selectors_equal_jax(actions, fn):
    pd.testing.assert_frame_equal(getattr(txt, fn)(actions), getattr(jxt, fn)(actions))


@pytest.mark.parametrize('grid', [(16, 12), (5, 3)])
def test_probability_functions_equal_jax(actions, grid):
    l, w = grid
    np.testing.assert_array_equal(txt.scoring_prob(actions, l, w), jxt.scoring_prob(actions, l, w))
    for got, want in zip(txt.action_prob(actions, l, w), jxt.action_prob(actions, l, w)):
        np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(
        txt.move_transition_matrix(actions, l, w), jxt.move_transition_matrix(actions, l, w)
    )


@pytest.mark.parametrize('solver', ['dense', 'matrix-free'])
def test_oracle_fit_and_rate_equal_jax(actions, solver):
    got = txt.ExpectedThreat(backend='pandas', solver=solver, keep_heatmaps=True).fit(actions)
    want = jxt.ExpectedThreat(backend='pandas', solver=solver, keep_heatmaps=True).fit(actions)
    assert got.device is None and got.solver == solver
    np.testing.assert_array_equal(got.xT, want.xT)
    assert (got.n_iter, got.solve_residual, got.converged) == (
        want.n_iter, want.solve_residual, want.converged
    )
    for name in ('scoring_prob_matrix', 'shot_prob_matrix', 'move_prob_matrix'):
        np.testing.assert_array_equal(getattr(got, name), getattr(want, name))
    if solver == 'dense':
        np.testing.assert_array_equal(got.transition_matrix, want.transition_matrix)
    else:
        assert got.transition_matrix is None
    assert len(got.heatmaps) == len(want.heatmaps) == got.n_iter + 1
    for a, b in zip(got.heatmaps, want.heatmaps):
        np.testing.assert_array_equal(a, b)
    for interp in (False, True):
        np.testing.assert_array_equal(got.rate(actions, interp), want.rate(actions, interp))


@pytest.mark.parametrize('solver', ['dense', 'matrix-free'])
def test_device_backend_is_held_to_the_oracle(actions, solver):
    oracle = txt.ExpectedThreat(backend='pandas', solver=solver).fit(actions)
    device = txt.ExpectedThreat(solver=solver, device='cpu').fit(actions)
    assert device.backend == 'torch'
    np.testing.assert_allclose(device.xT, oracle.xT, rtol=0, atol=1e-5)
    assert abs(device.n_iter - oracle.n_iter) <= 1
    for name in ('scoring_prob_matrix', 'shot_prob_matrix', 'move_prob_matrix'):
        np.testing.assert_allclose(getattr(device, name), getattr(oracle, name), rtol=0, atol=1e-6)
    if solver == 'dense':
        np.testing.assert_allclose(device.transition_matrix, oracle.transition_matrix, rtol=0, atol=1e-6)
    for interp in (False, True):
        got, want = device.rate(actions, interp), oracle.rate(actions, interp)
        np.testing.assert_array_equal(np.isnan(got), np.isnan(want))
        ok = ~np.isnan(want)
        np.testing.assert_allclose(got[ok], want[ok], rtol=0, atol=1e-5)


def test_device_heatmaps_are_the_oracle_iteration(actions):
    """``keep_heatmaps`` on the device backend steps the oracle's value
    iteration over the device's matrices."""
    device = txt.ExpectedThreat(keep_heatmaps=True, device='cpu').fit(actions)
    oracle = txt.ExpectedThreat(backend='pandas', keep_heatmaps=True).fit(actions)
    assert len(device.heatmaps) == device.n_iter + 1
    assert abs(device.n_iter - oracle.n_iter) <= 1
    for a, b in zip(device.heatmaps, oracle.heatmaps):
        np.testing.assert_allclose(a, b, rtol=0, atol=1e-5)


def test_oracle_needs_no_device(spadl_actions, tmp_path, monkeypatch):
    monkeypatch.setattr(torch.cuda, 'is_available', lambda: False)
    model = txt.ExpectedThreat(backend='pandas').fit(spadl_actions)
    model.save_model(str(tmp_path / 'xt.json'))
    back = txt.load_model(str(tmp_path / 'xt.json'), backend='pandas')
    assert back.backend == 'pandas' and back.device is None
    np.testing.assert_array_equal(back.rate(spadl_actions), model.rate(spadl_actions))
    f = back.interpolator()
    assert f(np.array([10.0, 50.0]), np.array([30.0])).shape == (1, 2)
    with pytest.raises(RuntimeError, match='device="cpu"'):
        txt.ExpectedThreat()
    with pytest.raises(RuntimeError, match='device="cpu"'):
        txt.load_model(str(tmp_path / 'xt.json'))


def test_jax_surface_loads_into_the_oracle(spadl_actions, tmp_path):
    jmodel = jxt.ExpectedThreat(backend='pandas').fit(spadl_actions)
    jmodel.save_model(str(tmp_path / 'jax.json'))
    model = txt.load_model(str(tmp_path / 'jax.json'), backend='pandas')
    np.testing.assert_array_equal(model.xT, jmodel.xT)
    np.testing.assert_array_equal(model.rate(spadl_actions, True), jmodel.rate(spadl_actions, True))
    with open(tmp_path / 'jax.json') as f:
        assert np.array_equal(np.asarray(json.load(f)), model.xT)


def test_oracle_refuses_device_features(spadl_actions):
    with pytest.raises(ValueError, match='device-backend feature'):
        txt.ExpectedThreat(backend='pandas', variant='anderson')
    with pytest.raises(ValueError, match='device-backend feature'):
        txt.ExpectedThreat(backend='pandas').fit(spadl_actions, group_by='team_id')
    with pytest.raises(ValueError, match='leave device unset'):
        txt.ExpectedThreat(backend='pandas', device='cpu')
    with pytest.raises(ValueError, match='unknown backend'):
        txt.ExpectedThreat(backend='jax', device='cpu')
    batch, _ = pack_actions(spadl_actions, home_team_id=782, device='cpu')
    with pytest.raises(TypeError, match='not packed batches'):
        txt.ExpectedThreat(backend='pandas').fit(batch)
    fitted = txt.ExpectedThreat(backend='pandas').fit(spadl_actions)
    with pytest.raises(TypeError, match='not packed batches'):
        fitted.rate(batch)
