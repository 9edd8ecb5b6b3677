"""The port's game-sharded scale-out against the JAX package's, on the CPU.

The counterpart of ``tests/test_parallel.py``. The JAX functions run on
the 8-device CPU mesh this test tier sets up; the port's run in gloo
ranks that ``socceraction_tpu_torch.utils.env.run_distributed_workers``
spawns (``tests/torch_parallel_worker.py``), once per world shape: 4 ranks
as ``(games, model) = (4, 1)`` and as ``(2, 2)``. Each spawn has its own
time limit and a file store under the test's temporary directory.

The season is ``tests/test_parallel.py``'s: 8 distinct games of distinct
lengths, so shards differ in valid actions. Held:

- counts bitwise to JAX's ``sharded_xt_counts`` and the port's unsharded
  ``xt_counts``; grids within 1e-6 of JAX's, iteration counts equal on
  every rank and to JAX's (dense, matrix-free, and a 3-group fleet);
- the train step at ``model_parallel`` 1 and 2 from JAX's ``init_fn``
  parameters (carried across by ``convert.py``): the loss after steps 1
  and 2 at rtol 1e-5 and the parameters at rtol 1e-4, atol 1e-6 to JAX's
  ``make_train_step`` on its mesh, and bitwise across ranks;
- ``train_distributed`` then ``sharded_rate``: the heads bitwise across
  ranks and within rtol 1e-4, atol 1e-6 of the same steps taken in one
  process; the sharded rating within rtol 1e-4, atol 1e-5 of the
  unsharded one (``tests/test_parallel.py:206-209``), and JAX's trained
  heads rated by the port's ``sharded_rate`` within the same bounds of
  JAX's ``sharded_rate``.
"""

import jax
import numpy as np
import pandas as pd
import pytest
import torch
import torch.nn.functional as F

from socceraction_tpu import parallel as jpar
from socceraction_tpu.core.batch import pack_actions
from socceraction_tpu.core.synthetic import synthetic_actions_frame
from socceraction_tpu.ops.features import compute_features as jax_features
from socceraction_tpu.vaep.base import VAEP as JaxVAEP
from socceraction_tpu_torch import parallel as tpar
from socceraction_tpu_torch.core.batch import ActionBatch
from socceraction_tpu_torch.ml.mlp import _INIT_STREAM, AdamState, _generator, adam_update, init_mlp
from socceraction_tpu_torch.ops import xt as txt
from socceraction_tpu_torch.ops.fused import fused_pair_logits
from socceraction_tpu_torch.ops.labels import scores_concedes
from socceraction_tpu_torch.vaep.base import VAEP

from torch_parallel_worker import WORLD, spawn

_HOME, _AWAY = 100, 200
_N_GAMES = 8
NAMES = ('actiontype_onehot', 'result_onehot', 'startlocation', 'team')
HIDDEN = (32, 32)
N_GROUPS = 3


def _season_frame(n_games=_N_GAMES):
    """``tests/test_parallel.py``'s season: 8 distinct synthetic games."""
    frames = [
        synthetic_actions_frame(
            game_id=1000 + g, home_team_id=_HOME, away_team_id=_AWAY,
            n_actions=320 + 48 * g, seed=g,
        )
        for g in range(n_games)
    ]
    return pd.concat(frames, ignore_index=True)


def _fields(jbatch):
    return {name: np.asarray(getattr(jbatch, name)) for name in ActionBatch.__dataclass_fields__}


def _to_port(jbatch):
    return ActionBatch(**{k: torch.from_numpy(v.copy()) for k, v in _fields(jbatch).items()})


def _numpy_tree(tree):
    return jax.tree.map(np.asarray, jax.device_get(tree))


@pytest.fixture(scope='module')
def season():
    df = _season_frame()
    batch, _ = pack_actions(df, home_team_ids={g: _HOME for g in df['game_id'].unique()})
    return batch


@pytest.fixture(scope='module')
def group_id(season):
    g = np.arange(_N_GAMES, dtype=np.int32)[:, None] % N_GROUPS
    return np.where(np.asarray(season.mask), g, -1).astype(np.int32)


@pytest.fixture(scope='module')
def n_features(season):
    return int(jax_features.eval_shape(season, names=NAMES, k=3).shape[-1])


@pytest.fixture(scope='module')
def jax_init(n_features):
    """JAX's ``init_fn`` parameters (the same values on either mesh)."""
    init_fn, _, _ = jpar.make_train_step(jpar.make_mesh(), NAMES, k=3, hidden=HIDDEN)
    params, _ = init_fn(jax.random.PRNGKey(0), n_features)
    return _numpy_tree(params)


@pytest.fixture(scope='module')
def jax_models(season):
    """JAX's ``train_distributed`` heads and its ``sharded_rate`` values."""
    mesh = jpar.make_mesh()
    models = jpar.train_distributed(season, mesh, NAMES, k=3, hidden=(16,), epochs=3)
    model = JaxVAEP(backend='jax', nb_prev_actions=3)
    model.xfns = [
        getattr(__import__('socceraction_tpu.vaep.features', fromlist=[n]), n) for n in NAMES
    ]
    model._models = models
    values, _ = jpar.sharded_rate(model, season, mesh)
    heads = {h: (_numpy_tree(m.params), np.asarray(m.mean_), np.asarray(m.std_)) for h, m in models.items()}
    return heads, np.asarray(values)


@pytest.fixture(scope='module', params=[1, 2], ids=['games4_model1', 'games2_model2'])
def ranks(request, tmp_path_factory, season, group_id, n_features, jax_init, jax_models):
    """Every scenario of the ``parallel`` suite in 4 ranks, per mesh shape."""
    inputs = {
        'season': _fields(season),
        'model_parallel': request.param,
        'group_id': group_id,
        'n_groups': N_GROUPS,
        'names': NAMES,
        'hidden': HIDDEN,
        'n_features': n_features,
        'init': jax_init,
        'jax_models': jax_models[0],
    }
    return request.param, spawn('parallel', inputs, tmp_path_factory.mktemp('parallel'))


@pytest.fixture(scope='module')
def jax_step(season, n_features, jax_init):
    """JAX's losses and parameters after two steps, by ``model_parallel``."""
    out = {}
    for mp in (1, 2):
        mesh = jpar.make_mesh(model_parallel=mp)
        many = jpar.shard_batch(season, mesh)
        init_fn, step_fn, _ = jpar.make_train_step(mesh, NAMES, k=3, hidden=HIDDEN)
        params, opt = init_fn(jax.random.PRNGKey(0), n_features)
        losses = []
        for _ in range(2):
            params, opt, loss = step_fn(params, opt, many)
            losses.append(float(loss))
        out[mp] = (np.asarray(losses), _numpy_tree(params))
    return out


def _by_game(results, key):
    """The per-game shards of ``key`` from the ranks at ``model`` 0, joined
    along the game axis in ``games`` order."""
    first = sorted(
        (r for r in results if r['coords']['model'] == 0), key=lambda r: r['coords']['games']
    )
    return torch.cat([r[key] for r in first]).numpy()


def _jax_flat(tree):
    """A flax ``_MLP`` pytree as ``Dense_i.weight/bias`` in ``nn.Linear`` layout."""
    out = {}
    for layer, leaves in tree['params'].items():
        out[f'{layer}.weight'] = np.asarray(leaves['kernel']).T
        out[f'{layer}.bias'] = np.asarray(leaves['bias'])
    return out


def _assert_same_on_every_rank(results, key):
    first = results[0][key]
    for r in results[1:]:
        for name in first:
            assert torch.equal(r[key][name], first[name]), (key, name)


# -- mesh and shards ---------------------------------------------------------------


def test_mesh_shapes_and_guard_rails(ranks):
    mp, results = ranks
    for r in results:
        assert r['mesh'] == {'games': WORLD // mp, 'model': mp}
        assert 'does not divide' in r['error_divide']
        assert 'differs from the world size' in r['error_world']


def test_shards_partition_the_season(ranks, season):
    _, results = ranks
    for key in ('game_id', 'n_actions'):
        joined = np.concatenate([
            r['shard'][key].numpy()
            for r in sorted(results, key=lambda r: r['coords']['games'])
            if r['coords']['model'] == 0
        ])
        np.testing.assert_array_equal(joined, np.asarray(getattr(season, key)))
    lengths = {int(r['shard']['mask'].sum()) for r in results}
    assert len(lengths) > 1, 'shards must hold different numbers of valid actions'


def test_pad_games_is_inert_and_reads_no_count(spadl_actions, home_team_id):
    from socceraction_tpu_torch.core.batch import pack_actions as tpack

    batch, _ = tpack(spadl_actions, home_team_id=home_team_id, device='cpu')
    total = batch._host_total
    padded = tpar.pad_games(batch, 8)
    assert padded.n_games == 8
    assert padded._host_total == total  # kept, not recounted
    assert not bool(padded.mask[1:].any())
    assert not bool(padded.n_actions[1:].any())
    assert bool((padded.row_index[1:] == -1).all())
    assert padded.total_actions == total
    assert tpar.pad_games(batch, 1) is batch


# -- xT -----------------------------------------------------------------------------


def test_sharded_counts_are_bitwise(ranks, season):
    _, results = ranks
    mesh = jpar.make_mesh()
    want = jpar.sharded_xt_counts(jpar.shard_batch(season, mesh), mesh, l=16, w=12)
    port = _to_port(season)
    local = txt.xt_counts(
        port.type_id, port.result_id, port.start_x, port.start_y, port.end_x, port.end_y,
        port.mask, l=16, w=12,
    )
    for r in results:
        for name in ('shots', 'goals', 'moves', 'trans'):
            got = r['counts'][name].numpy()
            np.testing.assert_array_equal(got, np.asarray(getattr(want, name)), err_msg=name)
            np.testing.assert_array_equal(got, getattr(local, name).numpy(), err_msg=name)


def test_sharded_fit_matches_jax(ranks, season):
    _, results = ranks
    mesh = jpar.make_mesh()
    grid, _, it = jpar.sharded_xt_fit(jpar.shard_batch(season, mesh), mesh, l=16, w=12)
    for r in results:
        got_grid, got_it = r['fit']
        np.testing.assert_allclose(got_grid.numpy(), np.asarray(grid), atol=1e-6, rtol=0)
        assert int(got_it) == int(it) > 0


@pytest.mark.parametrize('grouped', [False, True], ids=['one_grid', 'fleet'])
def test_sharded_matrix_free_fit_matches_jax(ranks, season, group_id, grouped):
    _, results = ranks
    mesh = jpar.make_mesh()
    kw = {'group_id': jax.numpy.asarray(group_id), 'n_groups': N_GROUPS} if grouped else {}
    grid, it = jpar.sharded_xt_fit_matrix_free(jpar.shard_batch(season, mesh), mesh, l=24, w=16, **kw)
    key = 'mf_groups' if grouped else 'mf'
    for r in results:
        got_grid, got_it = r[key]
        np.testing.assert_allclose(got_grid.numpy(), np.asarray(grid), atol=1e-6, rtol=0)
        np.testing.assert_array_equal(got_it.numpy(), np.asarray(it))
    its = {tuple(np.atleast_1d(r[key][1].numpy())) for r in results}
    assert len(its) == 1


# -- training -----------------------------------------------------------------------


def test_train_step_matches_jax(ranks, jax_step):
    mp, results = ranks
    want_losses, want_params = jax_step[mp]
    for r in results:
        np.testing.assert_allclose(r['step_losses'].numpy(), want_losses, rtol=1e-5)
        for head in ('scores', 'concedes'):
            want = _jax_flat(want_params[head])
            for name, arr in want.items():
                got = r['step_params'][f'{head}/{name}'].numpy()
                np.testing.assert_allclose(got, arr, rtol=1e-4, atol=1e-6, err_msg=f'{head}/{name}')
    assert want_losses[1] < want_losses[0]


def test_train_step_parameters_are_bitwise_across_ranks(ranks):
    mp, results = ranks
    _assert_same_on_every_rank(results, 'step_params')
    for r in results:
        assert torch.equal(r['step_losses'], results[0]['step_losses'])
        # this rank's slice of Dense_0 is its part of the whole layer
        i = r['coords']['model']
        w0 = r['step_params']['scores/Dense_0.weight']
        np.testing.assert_array_equal(
            r['step_local']['scores'][0].numpy(), w0.chunk(mp, dim=0)[i].numpy()
        )


def _plain_steps(batch, modules, steps, lr=1e-3):
    """The same full-batch steps in one process, with no process group."""
    flat = [p for h in ('scores', 'concedes') for p in modules[h].parameters()]
    for p in flat:
        p.requires_grad_(True)
    state = AdamState.zeros(flat)
    ys, yc = scores_concedes(batch)
    w = batch.mask.to(torch.float32)

    def bce(logits, y):
        losses = -y * F.logsigmoid(logits) - (1.0 - y) * F.logsigmoid(-logits)
        return torch.sum(losses * w) / torch.clamp(w.sum(), min=1.0)

    for _ in range(steps):
        ls, lc = fused_pair_logits(modules['scores'], modules['concedes'], batch, names=NAMES, k=3)
        loss = bce(ls, ys.to(torch.float32)) + bce(lc, yc.to(torch.float32))
        state, _ = adam_update(flat, torch.autograd.grad(loss, flat), state, lr)
    return {f'{h}/{n}': t.detach() for h, m in modules.items() for n, t in m.state_dict().items()}


def test_train_distributed_then_sharded_rate(ranks, season, n_features):
    _, results = ranks
    _assert_same_on_every_rank(results, 'td_params')
    port = _to_port(season)
    init = {
        h: init_mlp(n_features, (16,), _generator(0, _INIT_STREAM, i))
        for i, h in enumerate(('scores', 'concedes'))
    }
    want = _plain_steps(port, init, steps=3)
    for name, arr in want.items():
        np.testing.assert_allclose(
            results[0]['td_params'][name].numpy(), arr.numpy(), rtol=1e-4, atol=1e-6, err_msg=name
        )

    from socceraction_tpu_torch.ml.mlp import MLP, MLPClassifier

    models = {}
    for h in ('scores', 'concedes'):
        module = MLP(n_features, (16,))
        module.load_state_dict({
            n.split('/', 1)[1]: t for n, t in results[0]['td_params'].items() if n.startswith(h)
        })
        models[h] = MLPClassifier.from_module(module, torch.zeros(n_features), torch.ones(n_features))
    unsharded = VAEP(xfns=NAMES, nb_prev_actions=3, models=models, device='cpu').rate_batch(port)
    values = _by_game(results, 'td_values')
    mask = np.asarray(season.mask)
    assert values.shape == (_N_GAMES, season.max_actions, 3)
    assert np.isfinite(values[mask]).all()
    np.testing.assert_allclose(values[mask], unsharded.numpy()[mask], rtol=1e-4, atol=1e-5)


def test_sharded_rate_of_jax_heads_matches_jax(ranks, season, jax_models):
    _, results = ranks
    _, want = jax_models
    got = _by_game(results, 'jax_model_values')
    mask = np.asarray(season.mask)
    np.testing.assert_allclose(got[mask], want[:_N_GAMES][mask], rtol=1e-4, atol=1e-5)


def test_the_port_exports_every_jax_name():
    assert len(jpar.__all__) == 20
    for name in jpar.__all__:
        assert hasattr(tpar, name), name
    assert set(tpar.__all__) == set(jpar.__all__)
