"""The port's counterfactual scenario engine against the JAX package's.

A JAX ``VAEP`` with seeded numpy MLP heads is saved and loaded into the
port (``tests/test_torch_vaep.py``); both packages rate the same seeded
batches (``synthetic_batch`` draws bitwise equal in both). On the CPU:

- the port's fold (one ``rate_batch`` over ``P·G`` games) equals its
  loop of ``P`` calls bitwise, across pad shapes, bucketing, quantized
  storage, field and dense-override grids and tiled caller overrides,
  for both families;
- the fold is within 1e-5 of the JAX package's ``rate_scenarios_batch``
  (the f32 contract; the two packages' matrix products sum in another
  order), and within 1e-5 of the port's materialized reference;
- the folded batch, the grids, the ladder, the product helpers and the
  xT fleet match the JAX package's (bitwise, or within 1e-5 for fitted
  surfaces).
"""

import numpy as np
import pandas as pd
import pytest
import torch

from socceraction_tpu import scenario as jsc
from socceraction_tpu.core.synthetic import synthetic_batch as jax_synthetic_batch
from socceraction_tpu_torch import scenario as tsc
from socceraction_tpu_torch.core.synthetic import synthetic_batch
from socceraction_tpu_torch.vaep.base import load_model
from tests.test_torch_atomic import _jax_model as _jax_atomic_model
from tests.test_torch_atomic import atomic_batches
from tests.test_torch_vaep import _saved_pair

ATOL = 1e-5


@pytest.fixture(scope='module', autouse=True)
def _drain_pair_probs_storm_window():
    """Retire this module's serving compiles from the JAX compile
    observatory's storm window (as tests/test_torch_vaep.py does)."""
    yield
    from socceraction_tpu.ops.fused import _pair_probs, _pair_probs_prepared

    for fn in (_pair_probs, _pair_probs_prepared):
        fn.drain_storm_window()


@pytest.fixture(scope='module')
def pair(tmp_path_factory):
    """(JAX model, the port's model loaded from its checkpoint)."""
    return _saved_pair((8,), tmp_path_factory)


@pytest.fixture(scope='module')
def atomic_pair(tmp_path_factory):
    jb, _ = atomic_batches(seed=1)
    jmodel = _jax_atomic_model((16,), jb)
    path = str(tmp_path_factory.mktemp('atomic-scenario'))
    jmodel.save_model(path)
    return jmodel, load_model(path, device='cpu')


def _batches(n_games, n_actions, fill=0.8, seed=40):
    return (
        jax_synthetic_batch(n_games, n_actions, fill=fill, seed=seed),
        synthetic_batch(n_games, n_actions, fill=fill, seed=seed, device='cpu'),
    )


def _grids(lib):
    return (lib.end_location_grid(nx=4, ny=3), lib.action_type_sweep(type_ids=[0, 1, 2, 11, 21]))


def _close(got, want, mask):
    """Within ATOL of the reference on the valid rows (values on padding
    rows are garbage by contract); ``mask`` is ``(G, A)``."""
    got = got.numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    want = want.numpy() if isinstance(want, torch.Tensor) else np.asarray(want)
    assert got.shape == want.shape
    np.testing.assert_allclose(got[:, mask], want[:, mask], rtol=0, atol=ATOL)


@pytest.mark.parametrize(
    'n_games,n_actions,fill', [(1, 128, 0.4), (1, 256, 0.5), (2, 256, 0.8), (3, 128, 1.0)]
)
def test_fold_matches_looped_bitwise_and_jax(pair, n_games, n_actions, fill):
    """The headline parity: one folded call equals P looped calls bit for
    bit on the CPU, regardless of game count and pad shape, and lands
    within 1e-5 of the JAX package's fold."""
    jmodel, model = pair
    jb, tb = _batches(n_games, n_actions, fill)
    for tgrid, jgrid in zip(_grids(tsc), _grids(jsc)):
        P = tgrid.n_perturbations
        fold = tsc.rate_scenarios_batch(model, tb, tgrid, bucket=False)
        loop = tsc.rate_scenarios_looped(model, tb, tgrid, bucket=False)
        assert fold.shape == (P, n_games, n_actions, 3)
        assert torch.equal(fold, loop)
        _close(fold, jsc.rate_scenarios_batch(jmodel, jb, jgrid, bucket=False), tb.mask.numpy())


def test_fold_matches_looped_with_bucketing(pair):
    """Bitwise through the power-of-two bucketing too (the folded P·G
    axis snaps to another rung than G does)."""
    _, model = pair
    _, tb = _batches(3, 128)
    grid = tsc.action_type_sweep(type_ids=[0, 1, 2])
    assert torch.equal(tsc.rate_scenarios_batch(model, tb, grid),
                       tsc.rate_scenarios_looped(model, tb, grid))


def test_fold_matches_the_materialized_reference(pair):
    _, model = pair
    _, tb = _batches(2, 128, fill=0.6)
    grid = tsc.end_location_grid(nx=3, ny=2)
    fold = tsc.rate_scenarios_batch(model, tb, grid)
    _close(fold, tsc.rate_scenarios_reference(model, tb, grid), tb.mask.numpy())


@pytest.mark.parametrize('mode', ['bf16', 'int8'])
def test_quantized_fold_matches_looped(pair, mode):
    """Narrow storage changes the values, never the fold's agreement with
    the loop (both read the same tables)."""
    _, model = pair
    _, tb = _batches(1, 256)
    grid = tsc.action_type_sweep(type_ids=[0, 1, 11])
    model.set_quantize(mode)
    try:
        fold = tsc.rate_scenarios_batch(model, tb, grid, bucket=False)
        loop = tsc.rate_scenarios_looped(model, tb, grid, bucket=False)
    finally:
        model.set_quantize('none')
    assert torch.equal(fold, loop)


def _goalscore_block(shape, seed):
    return np.random.default_rng(seed).integers(0, 3, size=(*shape, 3)).astype(np.float32)


def test_dense_override_grid(pair):
    """A grid of goalscore blocks rides the same fold: bitwise against the
    loop, within 1e-5 of the JAX package."""
    jmodel, model = pair
    jb, tb = _batches(2, 128)
    block = _goalscore_block((3, 2, 128), seed=3)
    fold = tsc.rate_scenarios_batch(model, tb, tsc.custom_grid(dense_overrides={'goalscore': block}),
                                    bucket=False)
    loop = tsc.rate_scenarios_looped(model, tb, tsc.custom_grid(dense_overrides={'goalscore': block}),
                                     bucket=False)
    assert torch.equal(fold, loop)
    want = jsc.rate_scenarios_batch(jmodel, jb, jsc.custom_grid(dense_overrides={'goalscore': block}),
                                    bucket=False)
    _close(fold, want, tb.mask.numpy())


def test_caller_override_is_tiled_and_conflicts_are_named(pair):
    jmodel, model = pair
    jb, tb = _batches(1, 128)
    per_game = _goalscore_block((1, 128), seed=5)
    grid = tsc.action_type_sweep(type_ids=[0, 1])
    kw = dict(dense_overrides={'goalscore': per_game}, bucket=False)
    fold = tsc.rate_scenarios_batch(model, tb, grid, **kw)
    assert torch.equal(fold, tsc.rate_scenarios_looped(model, tb, grid, **kw))
    _close(fold, jsc.rate_scenarios_batch(jmodel, jb, jsc.action_type_sweep(type_ids=[0, 1]), **kw),
           tb.mask.numpy())
    both = tsc.custom_grid(field_updates={'type_id': [0, 1]},
                           dense_overrides={'goalscore': np.tile(per_game, (2, 1, 1, 1))})
    with pytest.raises(ValueError, match='both by the grid and the caller'):
        tsc.expand_scenarios(tb, both, dense_overrides={'goalscore': per_game})
    with pytest.raises(ValueError, match='both by the grid and the caller'):
        tsc.rate_scenarios_looped(model, tb, both, dense_overrides={'goalscore': per_game})


def test_atomic_fold_matches_looped_and_jax(atomic_pair):
    """Either family's batch folds: Atomic-VAEP re-typed per perturbation."""
    jmodel, model = atomic_pair
    jb, tb = atomic_batches((256, 200, 131), seed=4)
    fields = {'type_id': [0, 21, 23, 11], 'bodypart_id': [0, 1, 0, 2]}
    fold = tsc.rate_scenarios_batch(model, tb, tsc.custom_grid(field_updates=fields))
    loop = tsc.rate_scenarios_looped(model, tb, tsc.custom_grid(field_updates=fields))
    assert fold.shape == (4, 3, 256, 3)
    assert torch.equal(fold, loop)
    _close(fold, jsc.rate_scenarios_batch(jmodel, jb, jsc.custom_grid(field_updates=fields)),
           tb.mask.numpy())
    _close(fold, tsc.rate_scenarios_reference(model, tb, tsc.custom_grid(field_updates=fields)),
           tb.mask.numpy())


def test_expand_scenarios_matches_jax():
    """The folded batch and overrides, field by field, bitwise: updates
    cast to each field's dtype, bookkeeping repeated, per-action (P, G, A)
    rewrites placed perturbation-major."""
    jb, tb = _batches(2, 128)
    rng = np.random.default_rng(7)
    fields = {'end_x': rng.uniform(0, 105, size=(3, 2, 128)), 'type_id': [4, 5, 6]}
    per_game = _goalscore_block((2, 128), seed=8)
    got, got_o = tsc.expand_scenarios(tb, tsc.custom_grid(field_updates=fields),
                                      dense_overrides={'goalscore': per_game})
    want, want_o = jsc.expand_scenarios(jb, jsc.custom_grid(field_updates=fields),
                                        dense_overrides={'goalscore': per_game})
    for name, a in got.fields().items():
        b = np.asarray(getattr(want, name))
        assert a.numpy().dtype == b.dtype and np.array_equal(a.numpy(), b), name
    assert sorted(got_o) == sorted(want_o) == ['goalscore']
    np.testing.assert_array_equal(got_o['goalscore'].numpy(), want_o['goalscore'])


def test_expand_scenarios_shape_errors():
    _, tb = _batches(2, 128)
    with pytest.raises(ValueError, match=r'batch needs \(P, G, A\)'):
        tsc.expand_scenarios(tb, tsc.custom_grid(field_updates={'end_x': np.zeros((2, 1, 128))}))
    with pytest.raises(ValueError, match='batch needs'):
        tsc.expand_scenarios(tb, tsc.custom_grid(dense_overrides={'goalscore': np.zeros((2, 2, 64, 3))}))


# -- grids, ladder, products ---------------------------------------------------------


GRIDS = {
    'end_location': lambda lib: lib.end_location_grid(nx=5, ny=4),
    'action_type_default': lambda lib: lib.action_type_sweep(),
    'action_type_fixed': lambda lib: lib.action_type_sweep([0, 11], result_id=1, bodypart_id=1),
    'custom': lambda lib: lib.custom_grid(
        field_updates={'start_x': [1.5, 2.5]},
        dense_overrides={'goalscore': np.ones((2, 1, 4, 3))}, meta={'k': 1},
    ),
    'padded': lambda lib: lib.pad_perturbations(lib.end_location_grid(nx=3, ny=1), 4),
}


@pytest.mark.parametrize('grid', list(GRIDS))
def test_grids_match_jax(grid):
    got, want = GRIDS[grid](tsc), GRIDS[grid](jsc)
    assert got.n_perturbations == want.n_perturbations
    assert got.meta == want.meta
    for mine, theirs in ((got.field_updates, want.field_updates),
                         (got.dense_overrides, want.dense_overrides)):
        assert sorted(mine) == sorted(theirs)
        for k in mine:
            assert mine[k].dtype == theirs[k].dtype and np.array_equal(mine[k], theirs[k]), k
    assert got.to_wire() == want.to_wire()
    back = tsc.ScenarioGrid.from_wire(want.to_wire())
    assert back.to_wire() == want.to_wire()


def test_grid_validation_errors():
    with pytest.raises(ValueError, match='not a perturbable'):
        tsc.custom_grid(field_updates={'mask': [1]})
    with pytest.raises(ValueError, match='at least one'):
        tsc.custom_grid()
    with pytest.raises(ValueError, match='inconsistent'):
        tsc.custom_grid(field_updates={'type_id': [0, 1], 'end_x': [1.0]})
    with pytest.raises(ValueError, match=r'type ids must be in \[0, 23\)'):
        tsc.action_type_sweep([40])
    with pytest.raises(ValueError, match='down to'):
        tsc.pad_perturbations(tsc.action_type_sweep([0, 1]), 1)
    assert tsc.PERTURBABLE_FIELDS == jsc.PERTURBABLE_FIELDS


def test_ladder_and_buckets_match_jax():
    assert tsc.perturbation_ladder(4096) == jsc.perturbation_ladder(4096)
    for n in (1, 2, 3, 64, 65, 4096):
        assert tsc.bucket_perturbations(n) == jsc.bucket_perturbations(n)


def test_product_helpers_match_jax(pair):
    """Decision surfaces and option rankings, from the port's value tensor
    and from the same values as numpy through the JAX package."""
    _, model = pair
    _, tb = _batches(2, 128)
    grid = tsc.end_location_grid(nx=4, ny=3)
    values = tsc.rate_scenarios_batch(model, tb, grid)
    jgrid = jsc.end_location_grid(nx=4, ny=3)
    for game, action in ((0, 5), (1, 17)):
        got = tsc.decision_surface(values, grid, game=game, action=action)
        want = jsc.decision_surface(values.numpy(), jgrid, game=game, action=action)
        assert got.shape == (3, 4)
        np.testing.assert_array_equal(got, want)
        pd.testing.assert_frame_equal(
            tsc.pass_option_ranking(values, grid, game=game, action=action, top=5),
            jsc.pass_option_ranking(values.numpy(), jgrid, game=game, action=action, top=5),
        )
    sweep = tsc.action_type_sweep([0, 1, 11])
    swept = tsc.rate_scenarios_batch(model, tb, sweep)
    ranking = tsc.pass_option_ranking(swept, sweep, column='offensive_value')
    pd.testing.assert_frame_equal(
        ranking,
        jsc.pass_option_ranking(swept.numpy(), jsc.action_type_sweep([0, 1, 11]),
                                column='offensive_value'),
    )
    assert list(ranking.columns) == ['rank', 'perturbation', 'type_id', 'type_name',
                                     'offensive_value']
    with pytest.raises(ValueError, match='end_location_grid'):
        tsc.decision_surface(swept, sweep)
    with pytest.raises(ValueError, match='unknown value column'):
        tsc.pass_option_ranking(swept, sweep, column='nope')


def _flip(frame):
    out = frame.copy()
    out['result_id'] = 1 - out['result_id'].clip(0, 1)
    return out


def test_xt_scenario_fleet_matches_jax(spadl_actions):
    """One grouped fit over three scenarios: the same fleet keys, every
    surface within 1e-5 of the JAX package's, every grid converged."""
    scenarios = {'factual': None, 'flipped': _flip, 'first_half': spadl_actions[
        spadl_actions.period_id == 1]}
    got = tsc.xt_scenario_fleet(spadl_actions, scenarios, l=16, w=12, device='cpu')
    want = jsc.xt_scenario_fleet(spadl_actions, scenarios, l=16, w=12, backend='jax')
    assert sorted(got.group_keys_.tolist()) == sorted(want.group_keys_.tolist())
    assert got.converged_per_grid_.all()
    for key in scenarios:
        np.testing.assert_allclose(got.surface(key), np.asarray(want.surface(key)), rtol=0,
                                   atol=ATOL)


def test_xt_scenario_fleet_validation(spadl_actions):
    with pytest.raises(ValueError, match='at least one scenario'):
        tsc.xt_scenario_fleet(spadl_actions, {}, device='cpu')
    with pytest.raises(ValueError, match='no base actions'):
        tsc.xt_scenario_fleet(None, {'a': _flip}, device='cpu')
    with pytest.raises(ValueError, match='no base'):
        tsc.xt_scenario_fleet(None, {'a': None}, device='cpu')
    tainted = spadl_actions.head(10).assign(__scenario__='x')
    with pytest.raises(ValueError, match='must not already carry'):
        tsc.xt_scenario_fleet(None, {'a': tainted}, device='cpu')
