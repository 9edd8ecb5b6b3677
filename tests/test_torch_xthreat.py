"""The xT path of the PyTorch port against the JAX package, on the CPU.

The same seeded inputs (the golden game ``tests/datasets/spadl/spadl.json``
and a ``synthetic_batch(8, 256)``) go through the JAX package (its XLA
scatter, and once its Pallas segment-sum kernel in interpret mode) and
through the port with ``device='cpu'`` (its plain versions). Tolerances:

- cells and count matrices bitwise (integer-valued f32 sums are exact);
- probabilities within 1e-6 (the same divisions);
- ``XTSolution`` grids within 1e-5 with equal iteration counts and
  ``converged`` flags, for every solver, dense and matrix-free, single
  grid and fleet (the dense mat-vec sums in another order);
- ratings within 1e-5, NaN in the same places.

Small grids (16 x 12, 24 x 16) keep the added wall time small.
"""

from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pandas as pd
import pytest
import torch

from socceraction_tpu import xthreat as jxthreat
from socceraction_tpu.core import batch as jbatch
from socceraction_tpu.core.synthetic import synthetic_actions_frame
from socceraction_tpu.ops import xt as jxt
from socceraction_tpu_torch import xthreat as txthreat
from socceraction_tpu_torch.core import batch as tbatch
from socceraction_tpu_torch.core.synthetic import synthetic_batch
from socceraction_tpu_torch.ops import segment as tseg
from socceraction_tpu_torch.ops import xt as txt

GOLDEN = Path(__file__).resolve().parent / 'datasets' / 'spadl' / 'spadl.json'
FIELDS = ('type_id', 'result_id', 'start_x', 'start_y', 'end_x', 'end_y', 'mask')
N_GROUPS = 3


@pytest.fixture(scope='module')
def golden():
    return pd.read_json(GOLDEN)


def _inputs(name, golden):
    """``(numpy fields, numpy group ids)`` of one named input."""
    if name == 'golden':
        batch, _ = tbatch.pack_actions(golden, home_team_id=782, device='cpu')
        codes, _ = pd.factorize(golden['team_id'], sort=True)
        gid = tbatch.pack_row_values(codes.astype(np.int32), batch, fill=-1)
    else:
        batch = synthetic_batch(8, 256, seed=5, device='cpu')
        gid = np.broadcast_to((np.arange(8, dtype=np.int32) % N_GROUPS)[:, None], (8, 256)).copy()
        gid[0, :10] = -1  # "in no group" rows are dropped
    return {f: getattr(batch, f).numpy() for f in FIELDS}, gid


@pytest.fixture(scope='module', params=['golden', 'synthetic'])
def stream(request, golden):
    return _inputs(request.param, golden)


def _jax(fields):
    return [jnp.asarray(fields[f]) for f in FIELDS]


def _torch(fields):
    return [torch.from_numpy(fields[f]) for f in FIELDS]


def _n_groups(gid):
    return int(gid.max()) + 1


def _assert_solution(t, j, grid_atol=1e-5):
    np.testing.assert_allclose(t.grid.numpy(), np.asarray(j.grid), atol=grid_atol, rtol=0)
    np.testing.assert_array_equal(t.iterations.numpy(), np.asarray(j.iterations))
    np.testing.assert_array_equal(t.converged.numpy(), np.asarray(j.converged))
    np.testing.assert_allclose(t.residual.numpy(), np.asarray(j.residual), atol=1e-6, rtol=0)


def _assert_probs(t, j):
    for k in ('p_score', 'p_shot', 'p_move', 'transition'):
        a, b = getattr(t, k), getattr(j, k)
        assert (a is None) == (b is None), k
        if a is not None:
            np.testing.assert_allclose(a.numpy(), np.asarray(b), atol=1e-6, rtol=0, err_msg=k)


# -- binning, counts, probabilities ------------------------------------------


@pytest.mark.parametrize('l, w', [(16, 12), (24, 16), (192, 125)])
def test_cells_match_bitwise(l, w):
    """Seeded coordinates plus every bin edge and the pitch corners."""
    rng = np.random.default_rng(l)
    x = np.concatenate([
        rng.uniform(-5, 110, 5000), np.arange(l + 1) * 105.0 / l, [0.0, 105.0, np.nextafter(105.0, 0)],
    ]).astype(np.float32)
    y = np.concatenate([
        rng.uniform(-5, 73, 5000), np.arange(w + 1) * 68.0 / w, [0.0, 68.0, 68.0 - 1e-5],
    ]).astype(np.float32)
    y = np.resize(y, x.shape)
    jt = jxt.flat_indexes(jnp.asarray(x), jnp.asarray(y), l, w)
    tt = txt.flat_indexes(torch.from_numpy(x), torch.from_numpy(y), l, w)
    assert tt.dtype == torch.int32
    np.testing.assert_array_equal(tt.numpy(), np.asarray(jt))


@pytest.mark.parametrize('grouped', [False, True], ids=['single', 'fleet'])
def test_counts_bitwise_and_probabilities(stream, grouped):
    fields, gid = stream
    kw = dict(group_id=gid, n_groups=_n_groups(gid)) if grouped else {}
    jc = jxt.xt_counts(*_jax(fields), l=16, w=12,
                       **{k: jnp.asarray(v) if k == 'group_id' else v for k, v in kw.items()})
    tc = txt.xt_counts(*_torch(fields), l=16, w=12,
                       **{k: torch.from_numpy(v) if k == 'group_id' else v for k, v in kw.items()})
    for k in ('shots', 'goals', 'moves', 'trans'):
        np.testing.assert_array_equal(getattr(tc, k).numpy(), np.asarray(getattr(jc, k)), err_msg=k)
    assert float(tc.shots.sum()) > 0 and float(tc.trans.sum()) > 0
    _assert_probs(
        txt.xt_probabilities(tc, l=16, w=12), jxt.xt_probabilities(jc, l=16, w=12)
    )


# -- the solver family: dense, matrix-free, single grid and fleet ------------


def _dense(fields, gid, lib, solver, eps=1e-5):
    if lib == 'jax':
        kw = dict(group_id=jnp.asarray(gid), n_groups=_n_groups(gid)) if gid is not None else {}
        probs = jxt.xt_probabilities(jxt.xt_counts(*_jax(fields), l=16, w=12, **kw), l=16, w=12)
        return jxt.solve_xt(probs, eps=eps, solver=solver), probs
    kw = dict(group_id=torch.from_numpy(gid), n_groups=_n_groups(gid)) if gid is not None else {}
    probs = txt.xt_probabilities(txt.xt_counts(*_torch(fields), l=16, w=12, **kw), l=16, w=12)
    return txt.solve_xt(probs, eps=eps, solver=solver), probs


def _matrix_free(fields, gid, lib, solver, eps=1e-5, l=24, w=16):
    if lib == 'jax':
        kw = dict(group_id=jnp.asarray(gid), n_groups=_n_groups(gid)) if gid is not None else {}
        return jxt.solve_xt_matrix_free(*_jax(fields), l=l, w=w, eps=eps, solver=solver, **kw)
    kw = dict(group_id=torch.from_numpy(gid), n_groups=_n_groups(gid)) if gid is not None else {}
    return txt.solve_xt_matrix_free(*_torch(fields), l=l, w=w, eps=eps, solver=solver, **kw)


@pytest.mark.parametrize('grouped', [False, True], ids=['single', 'fleet'])
@pytest.mark.parametrize('solver', txt.SOLVERS)
def test_dense_solve_matches_jax(stream, solver, grouped):
    fields, gid = stream
    gid = gid if grouped else None
    tsol, tprobs = _dense(fields, gid, 'torch', solver)
    jsol, jprobs = _dense(fields, gid, 'jax', solver)
    _assert_probs(tprobs, jprobs)
    _assert_solution(tsol, jsol)
    assert tsol.grid.shape == ((_n_groups(gid),) if grouped else ()) + (12, 16)


@pytest.mark.parametrize('grouped', [False, True], ids=['single', 'fleet'])
@pytest.mark.parametrize('solver', txt.SOLVERS)
def test_matrix_free_solve_matches_jax(stream, solver, grouped):
    fields, gid = stream
    gid = gid if grouped else None
    tsol, tprobs = _matrix_free(fields, gid, 'torch', solver)
    jsol, jprobs = _matrix_free(fields, gid, 'jax', solver)
    _assert_probs(tprobs, jprobs)
    _assert_solution(tsol, jsol)


@pytest.mark.parametrize('grouped', [False, True], ids=['single', 'fleet'])
def test_matrix_free_matches_jax_on_its_pallas_kernel(golden, monkeypatch, grouped):
    """The JAX package's matrix-free solve with its segment sums on the
    Pallas kernel (interpret mode): the payoff sums in another order, so
    grids within 1e-5 and the same iteration counts."""
    fields, gid = _inputs('synthetic', golden)
    gid = gid if grouped else None
    # the segment dispatch is read at trace time: drop cached traces
    jax.clear_caches()
    monkeypatch.setenv('SOCCERACTION_TPU_SEGMENT', 'pallas')
    try:
        jsol, jprobs = _matrix_free(fields, gid, 'jax', 'picard', l=16, w=12)
        kw = dict(group_id=jnp.asarray(gid), n_groups=_n_groups(gid)) if grouped else {}
        jc = jxt.xt_counts(*_jax(fields), l=16, w=12, **kw)
        jsol.grid.block_until_ready()
    finally:
        monkeypatch.delenv('SOCCERACTION_TPU_SEGMENT')
        jax.clear_caches()
    tsol, tprobs = _matrix_free(fields, gid, 'torch', 'picard', l=16, w=12)
    _assert_probs(tprobs, jprobs)
    _assert_solution(tsol, jsol)
    kw = dict(group_id=torch.from_numpy(gid), n_groups=_n_groups(gid)) if grouped else {}
    tc = txt.xt_counts(*_torch(fields), l=16, w=12, **kw)
    for k in ('shots', 'goals', 'moves', 'trans'):
        np.testing.assert_array_equal(getattr(tc, k).numpy(), np.asarray(getattr(jc, k)), err_msg=k)


@pytest.mark.parametrize('solver', txt.SOLVERS)
def test_solver_family_agrees_at_tight_eps(golden, solver):
    """Within the port: every variant, dense and matrix-free, single grid
    and fleet, lands on Picard's dense fixed point within 1e-5 at eps 1e-7."""
    fields, gid = _inputs('synthetic', golden)
    ref, _ = _dense(fields, None, 'torch', 'picard', eps=1e-7)
    ref_fleet, _ = _dense(fields, gid, 'torch', 'picard', eps=1e-7)
    for sol in (
        _dense(fields, None, 'torch', solver, eps=1e-7)[0],
        _matrix_free(fields, None, 'torch', solver, eps=1e-7, l=16, w=12)[0],
    ):
        assert bool(sol.converged)
        np.testing.assert_allclose(sol.grid.numpy(), ref.grid.numpy(), atol=1e-5)
    for sol in (
        _dense(fields, gid, 'torch', solver, eps=1e-7)[0],
        _matrix_free(fields, gid, 'torch', solver, eps=1e-7, l=16, w=12)[0],
    ):
        assert bool(sol.converged.all())
        np.testing.assert_allclose(sol.grid.numpy(), ref_fleet.grid.numpy(), atol=1e-5)


def test_max_iter_cut_certificate(golden):
    """eps = 0: every grid either runs the whole max_iter or stopped at an
    exact f32 fixed point, and ``converged`` is exactly ``residual <= 0``,
    as in the JAX package."""
    fields, gid = _inputs('synthetic', golden)
    for g in (None, gid):
        for solver in txt.SOLVERS:
            lib = {}
            for name, solve in (('torch', txt.solve_xt), ('jax', jxt.solve_xt)):
                probs = _dense(fields, g, name, 'picard')[1]
                lib[name] = solve(probs, eps=0.0, max_iter=4, solver=solver)
            its = lib['torch'].iterations.numpy()
            resid = lib['torch'].residual.numpy()
            assert ((its == 4) | (resid <= 0.0)).all() and (its == 4).any()
            np.testing.assert_array_equal(lib['torch'].converged.numpy(), resid <= 0.0)
            _assert_solution(lib['torch'], lib['jax'])


def test_solver_flags_and_group_arguments():
    probs = txt.XTProbabilities(torch.zeros(2, 2), torch.zeros(2, 2), torch.zeros(2, 2), torch.zeros(4, 4))
    with pytest.raises(ValueError, match='conflicts'):
        txt.solve_xt(probs, solver='momentum', accelerate=True)
    with pytest.raises(ValueError, match='unknown solver'):
        txt.solve_xt(probs, solver='sor')
    plain = txt.solve_xt(probs, solver='plain')
    assert int(plain.iterations) == 1 and bool(plain.converged)
    fields = [torch.zeros(4, dtype=torch.int32)] * 2 + [torch.zeros(4)] * 4 + [torch.ones(4, dtype=torch.bool)]
    with pytest.raises(ValueError, match='together'):
        txt.xt_counts(*fields, l=4, w=2, group_id=torch.zeros(4, dtype=torch.int32))
    with pytest.raises(ValueError, match='together'):
        txt.solve_xt_matrix_free(*fields, l=4, w=2, n_groups=2)
    with pytest.raises(ValueError, match='int32'):
        txt.xt_counts(*fields, l=32, w=24, group_id=torch.zeros(4, dtype=torch.int32), n_groups=4000)


# -- rating ------------------------------------------------------------------


def _assert_ratings(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    np.testing.assert_array_equal(np.isnan(a), np.isnan(b))
    np.testing.assert_allclose(a[~np.isnan(a)], b[~np.isnan(b)], atol=1e-5, rtol=0)


def test_rate_actions_and_interpolation_match_jax(stream):
    fields, gid = stream
    rng = np.random.default_rng(0)
    grid = rng.random((12, 16)).astype(np.float32)
    fleet = rng.random((_n_groups(gid), 12, 16)).astype(np.float32)
    _assert_ratings(
        txt.rate_actions(torch.from_numpy(grid), *_torch(fields), l=16, w=12),
        jxt.rate_actions(jnp.asarray(grid), *_jax(fields), l=16, w=12),
    )
    _assert_ratings(
        txt.rate_actions(torch.from_numpy(fleet), *_torch(fields), l=16, w=12,
                         group_id=torch.from_numpy(gid)),
        jxt.rate_actions(jnp.asarray(fleet), *_jax(fields), l=16, w=12, group_id=jnp.asarray(gid)),
    )
    for g in (grid, fleet):
        # the sample positions come from f32 linspaces that XLA folds at
        # compile time and PyTorch computes at run time: they differ by an
        # ulp (7.6e-6 m), which moves values by about 1e-6; the rating
        # contract is 1e-5
        np.testing.assert_allclose(
            txt.interpolate_grid(torch.from_numpy(g), 105, 68).numpy(),
            np.asarray(jxt.interpolate_grid(jnp.asarray(g), 105, 68)),
            atol=1e-5, rtol=0,
        )
    with pytest.raises(ValueError, match='group_id'):
        txt.rate_actions(torch.from_numpy(fleet), *_torch(fields), l=16, w=12)


# -- the ExpectedThreat frontend ---------------------------------------------


@pytest.mark.parametrize('solver', ['dense', 'matrix-free'])
@pytest.mark.parametrize('variant', ['picard', 'anderson'])
def test_model_fit_and_rate_match_jax(golden, solver, variant):
    jm = jxthreat.ExpectedThreat(backend='jax', solver=solver, variant=variant).fit(golden)
    tm = txthreat.ExpectedThreat(solver=solver, variant=variant, device='cpu').fit(golden)
    np.testing.assert_allclose(tm.xT, jm.xT, atol=1e-5, rtol=0)
    assert (tm.n_iter, tm.converged) == (jm.n_iter, jm.converged)
    assert tm.solve_residual == pytest.approx(jm.solve_residual, abs=1e-6)
    for k in ('scoring_prob_matrix', 'shot_prob_matrix', 'move_prob_matrix', 'transition_matrix'):
        a, b = getattr(tm, k), getattr(jm, k)
        assert (a is None) == (b is None)
        if a is not None:
            np.testing.assert_allclose(a, b, atol=1e-6, rtol=0)
    for interp in (False, True):
        _assert_ratings(tm.rate(golden, use_interpolation=interp),
                        jm.rate(golden, use_interpolation=interp))
    # a packed batch rates on the device, (G, A)
    tb, _ = tbatch.pack_actions(golden, home_team_id=782, device='cpu')
    jb, _ = jbatch.pack_actions(golden, home_team_id=782)
    _assert_ratings(tm.rate(tb), jm.rate(jb))
    _assert_ratings(tm.rate(tb, use_interpolation=True), jm.rate(jb, use_interpolation=True))


def test_model_fit_on_a_batch_equals_fit_on_the_frame(golden):
    tb, _ = tbatch.pack_actions(golden, home_team_id=782, device='cpu')
    a = txthreat.ExpectedThreat(device='cpu').fit(tb)
    b = txthreat.ExpectedThreat(device='cpu').fit(golden)
    np.testing.assert_array_equal(a.xT, b.xT)


def test_keep_heatmaps_and_interpolator_match_jax(golden):
    jm = jxthreat.ExpectedThreat(backend='jax', keep_heatmaps=True).fit(golden)
    tm = txthreat.ExpectedThreat(keep_heatmaps=True, device='cpu').fit(golden)
    assert len(tm.heatmaps) == len(jm.heatmaps) == tm.n_iter + 1
    for a, b in zip(tm.heatmaps, jm.heatmaps):
        np.testing.assert_allclose(a, b, atol=1e-6, rtol=0)
    xs, ys = np.linspace(-3, 108, 37), np.linspace(-2, 70, 23)
    for kind in ('linear', 'cubic'):
        np.testing.assert_allclose(
            tm.interpolator(kind)(xs, ys), jm.interpolator(kind)(xs, ys), atol=1e-9
        )


@pytest.fixture(scope='module')
def season():
    frames = [
        synthetic_actions_frame(game_id=3000 + g, n_actions=400, seed=200 + g)
        for g in range(3)
    ]
    return pd.concat(frames, ignore_index=True)


@pytest.mark.parametrize('solver', ['dense', 'matrix-free'])
def test_grouped_model_matches_jax(season, solver):
    jm = jxthreat.ExpectedThreat(backend='jax', solver=solver).fit(season, group_by='team_id')
    tm = txthreat.ExpectedThreat(solver=solver, device='cpu').fit(season, group_by='team_id')
    np.testing.assert_array_equal(tm.group_keys_, jm.group_keys_)
    np.testing.assert_allclose(tm.grids_, jm.grids_, atol=1e-5, rtol=0)
    np.testing.assert_array_equal(tm.n_iter_per_grid_, jm.n_iter_per_grid_)
    np.testing.assert_array_equal(tm.converged_per_grid_, jm.converged_per_grid_)
    assert (tm.n_iter, tm.converged) == (jm.n_iter, jm.converged)
    for k in ('scoring_prob_matrices_', 'shot_prob_matrices_', 'move_prob_matrices_',
              'transition_matrices_'):
        a, b = getattr(tm, k), getattr(jm, k)
        assert (a is None) == (b is None)
        if a is not None:
            np.testing.assert_allclose(a, b, atol=1e-6, rtol=0)
    assert tm.scoring_prob_matrix is None and not np.any(tm.xT)
    mutated = season.copy()
    mutated.loc[mutated.index[:40], 'team_id'] = -777  # unseen keys rate NaN
    for frame in (season, mutated):
        for interp in (False, True):
            _assert_ratings(tm.rate(frame, use_interpolation=interp),
                            jm.rate(frame, use_interpolation=interp))
    key = tm.group_keys_[-1]
    np.testing.assert_array_equal(tm.surface(key), tm.surfaces()[key])
    with pytest.raises(KeyError):
        tm.surface(-12345)


def test_grouped_model_by_array_matches_jax(season):
    phase = (np.arange(len(season)) * 3 // len(season)).astype(np.int64)
    jm = jxthreat.ExpectedThreat(backend='jax').fit(season, group_by=phase)
    tm = txthreat.ExpectedThreat(device='cpu').fit(season, group_by=phase)
    np.testing.assert_allclose(tm.grids_, jm.grids_, atol=1e-5, rtol=0)
    with pytest.raises(ValueError, match='group_by'):
        tm.rate(season)
    _assert_ratings(tm.rate(season, group_by=phase), jm.rate(season, group_by=phase))


def test_auto_solver_folds_the_fleet_in():
    m = txthreat.ExpectedThreat(device='cpu')
    assert m.solver == 'dense'
    assert m._effective_solver(456) == 'matrix-free'
    assert txthreat.ExpectedThreat(l=192, w=125, device='cpu').solver == 'matrix-free'
    assert txthreat.ExpectedThreat(solver='dense', device='cpu')._effective_solver(10_000) == 'dense'


def test_model_guards(golden, tmp_path):
    with pytest.raises(ValueError, match='variant'):
        txthreat.ExpectedThreat(variant='gauss-seidel', device='cpu')
    with pytest.raises(ValueError, match='conflicts'):
        txthreat.ExpectedThreat(variant='momentum', accelerate=True, device='cpu')
    with pytest.raises(ValueError, match='keep_heatmaps'):
        txthreat.ExpectedThreat(variant='anderson', keep_heatmaps=True, device='cpu')
    with pytest.raises(ValueError, match='unknown solver'):
        txthreat.ExpectedThreat(solver='sparse', device='cpu')
    with pytest.raises(ValueError, match='keep_heatmaps'):
        txthreat.ExpectedThreat(solver='matrix-free', keep_heatmaps=True, device='cpu').fit(golden)
    unfitted = txthreat.ExpectedThreat(device='cpu')
    with pytest.raises(txthreat.NotFittedError):
        unfitted.rate(golden)
    with pytest.raises(txthreat.NotFittedError):
        unfitted.save_model(str(tmp_path / 'x.json'))
    tb, _ = tbatch.pack_actions(golden, home_team_id=782, device='cpu')
    with pytest.raises(ValueError, match='DataFrame'):
        txthreat.ExpectedThreat(device='cpu').fit(tb, group_by='team_id')
    with pytest.raises(ValueError, match='not in actions'):
        txthreat.ExpectedThreat(device='cpu').fit(golden, group_by='no_such_col')
    grouped = txthreat.ExpectedThreat(device='cpu').fit(golden, group_by='team_id')
    with pytest.raises(ValueError, match='collection'):
        grouped.save_model(str(tmp_path / 'never.json'))
    with pytest.raises(ValueError, match='collection'):
        grouped.interpolator()
    grouped.fit(golden)  # an ungrouped refit drops the fleet
    assert grouped.grids_ is None and np.any(grouped.xT)
    with pytest.raises(ValueError, match='group_by fit'):
        grouped.rate(golden, group_by='team_id')


# -- persistence: the weights-across check -----------------------------------


def test_save_load_round_trip_and_across_packages(golden, tmp_path):
    jm = jxthreat.ExpectedThreat(backend='jax').fit(golden)
    tm = txthreat.ExpectedThreat(device='cpu').fit(golden)
    # a surface the JAX package trained, loaded into the port, rates the same
    jm.save_model(str(tmp_path / 'jax.json'))
    loaded = txthreat.load_model(str(tmp_path / 'jax.json'), device='cpu')
    np.testing.assert_array_equal(loaded.xT, jm.xT)
    assert (loaded.w, loaded.l) == jm.xT.shape
    for interp in (False, True):
        _assert_ratings(loaded.rate(golden, use_interpolation=interp),
                        jm.rate(golden, use_interpolation=interp))
    # and the port's own surface round-trips, and loads into the JAX package
    tm.save_model(str(tmp_path / 'torch.json'))
    back = txthreat.load_model(str(tmp_path / 'torch.json'), device='cpu')
    np.testing.assert_array_equal(back.xT, tm.xT)
    np.testing.assert_array_equal(jxthreat.load_model(str(tmp_path / 'torch.json')).xT, tm.xT)
    with pytest.raises(ValueError, match='overwrite'):
        tm.save_model(str(tmp_path / 'torch.json'), overwrite=False)


def test_fit_launches_no_kernel_on_the_cpu(golden):
    before = tseg.segment_sum.launches
    txthreat.ExpectedThreat(l=24, w=16, solver='matrix-free', device='cpu').fit(golden)
    assert tseg.segment_sum.launches == before
