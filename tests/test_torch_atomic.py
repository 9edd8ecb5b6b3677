"""The port's Atomic-VAEP against the JAX package's.

Every input is a seeded numpy draw fed to both packages, on the CPU, at a
small size: four atomic games of unequal length in a 256-wide batch. The
draw hits each edge the kernels branch on: all 33 type ids (goals 27, own
goals 28 and the second 'interception' id 24 among them), exact zero
displacements, actions on the goal line (``_polar``'s ``dx = 0``) and on
the goal itself (``0/0``), and goals in the padding rows, which no valid
row's label may see. The port runs its plain versions (kernel B1's plain
forward); the JAX package runs XLA or its Pallas kernel in interpret
mode. Each test states its tolerance.

The JAX package resolves a serving fold's column layout on an abstract
standard batch, which the atomic kernels cannot read (its ``AtomicVAEP``
cannot build a quantized or Pallas fold); the tests that need that fold
substitute an abstract atomic batch for the duration of the test.
"""

import json

import jax
import jax.numpy as jnp
import numpy as np
import pandas as pd
import pytest
import torch

from socceraction_tpu.atomic.spadl import config as jconfig
from socceraction_tpu.atomic.vaep.base import AtomicVAEP as JaxAtomicVAEP
from socceraction_tpu.core import batch as jbatch
from socceraction_tpu.ml import mlp as jmlp
from socceraction_tpu.ops import atomic as jatomic
from socceraction_tpu.ops import fused as jfused
from socceraction_tpu.ops import gather_matmul as jgm
from socceraction_tpu.vaep.base import load_model as jax_load_model
from socceraction_tpu_torch import convert
from socceraction_tpu_torch.atomic.spadl import config as tconfig
from socceraction_tpu_torch.atomic.vaep.base import XFNS_DEFAULT, AtomicVAEP
from socceraction_tpu_torch.core import batch as tbatch
from socceraction_tpu_torch.core.synthetic import synthetic_batch
from socceraction_tpu_torch.ml import mlp as tmlp
from socceraction_tpu_torch.ops import atomic as tatomic
from socceraction_tpu_torch.ops import fused as tfused
from socceraction_tpu_torch.ops import gather_matmul as tgm
from socceraction_tpu_torch.ops.features import kernel_width
from socceraction_tpu_torch.vaep.base import load_model

NAMES = XFNS_DEFAULT
K = 3
R = 128
N_FEATURES = 154
N_DENSE = 46
ATOL = 1e-5
#: Kernels whose columns are integers (ids, one-hots, flags, scores) or
#: exact f32 arithmetic on the same inputs: held bitwise.
EXACT = {
    'actiontype', 'actiontype_onehot', 'bodypart', 'bodypart_onehot', 'time', 'team',
    'time_delta', 'location', 'goalscore',
}
#: Valid actions per game: unequal, so labels and features see games of
#: several lengths in one batch.
N_ACTIONS = (256, 219, 131, 7)


@pytest.fixture(scope='module', autouse=True)
def _drain_storm_windows():
    """Retire this module's compiles from the JAX compile observatory's
    storm window (as tests/test_torch_vaep.py does)."""
    yield
    from socceraction_tpu.ops.fused import _pair_probs, _pair_probs_prepared

    for fn in (jfused._train_states_arrays, _pair_probs, _pair_probs_prepared):
        fn.drain_storm_window()


def draw_atomic_columns(n_actions, max_actions, seed):
    """A seeded numpy draw of an atomic batch's columns (see the module
    docstring for the edges it hits). Padding rows keep their draws."""
    rng = np.random.default_rng(seed)
    G, A = len(n_actions), max_actions
    L, W = jconfig.field_length, jconfig.field_width
    p = np.ones(33)
    p[[0, 21, 23]] = 8.0  # passes, dribbles, receivals
    p[[24, 27, 28]] = 3.0  # the second interception id, goals, own goals
    type_id = rng.choice(33, size=(G, A), p=p / p.sum())
    is_home = rng.integers(0, 2, size=(G, A)).astype(bool)
    x = rng.uniform(0, L, size=(G, A))
    y = rng.uniform(0, W, size=(G, A))
    on_line = rng.random((G, A)) < 0.06
    x[on_line] = np.where(is_home, L, 0.0)[on_line]  # mirrored to the goal line
    y[on_line & (rng.random((G, A)) < 0.5)] = W / 2  # and onto the goal
    dx = rng.normal(0, 10, size=(G, A))
    dy = rng.normal(0, 6, size=(G, A))
    dx[rng.random((G, A)) < 0.12] = 0.0
    dy[rng.random((G, A)) < 0.12] = 0.0
    mask = np.arange(A)[None, :] < np.asarray(n_actions)[:, None]
    row_index = np.full((G, A), -1, dtype=np.int32)
    row_index[mask] = np.arange(int(mask.sum()), dtype=np.int32)
    return {
        'type_id': type_id.astype(np.int32),
        'bodypart_id': rng.integers(0, 4, size=(G, A)).astype(np.int32),
        'period_id': np.sort(rng.integers(1, 3, size=(G, A)), axis=1).astype(np.int32),
        'is_home': is_home,
        'time_seconds': np.sort(rng.uniform(0, 2700, size=(G, A)), axis=1).astype(np.float32),
        'x': x.astype(np.float32),
        'y': y.astype(np.float32),
        'dx': dx.astype(np.float32),
        'dy': dy.astype(np.float32),
        'mask': mask,
        'n_actions': np.asarray(n_actions, dtype=np.int32),
        'game_id': np.arange(G, dtype=np.int32),
        'row_index': row_index,
    }


def atomic_batches(n_actions=N_ACTIONS, max_actions=256, seed=0):
    """(JAX batch, port batch on the CPU) of one draw."""
    cols = draw_atomic_columns(n_actions, max_actions, seed)
    return (
        jbatch.AtomicActionBatch(**{n: jnp.asarray(a) for n, a in cols.items()}),
        tbatch.AtomicActionBatch(**{n: torch.from_numpy(a) for n, a in cols.items()}),
    )


@pytest.fixture(scope='module')
def batches():
    return atomic_batches()


def _abstract_atomic_batch(G=1, A=16):
    S = jax.ShapeDtypeStruct
    f, i, b = jnp.float32, jnp.int32, jnp.bool_
    return jbatch.AtomicActionBatch(
        type_id=S((G, A), i), bodypart_id=S((G, A), i), period_id=S((G, A), i),
        is_home=S((G, A), b), time_seconds=S((G, A), f), x=S((G, A), f), y=S((G, A), f),
        dx=S((G, A), f), dy=S((G, A), f), mask=S((G, A), b), n_actions=S((G,), i),
        game_id=S((G,), i), row_index=S((G, A), i),
    )


@pytest.fixture
def jax_atomic_fold(monkeypatch):
    """Let the JAX package build an atomic serving fold (module docstring)."""
    monkeypatch.setattr(jfused, '_abstract_batch', _abstract_atomic_batch)


# -- vocabulary, features, labels, formula -------------------------------------------------


def test_vocabulary_matches_jax():
    assert tconfig.actiontypes == jconfig.actiontypes and len(tconfig.actiontypes) == 33
    assert tconfig.bodyparts == jconfig.bodyparts
    ids = ('RECEIVAL', 'INTERCEPTION', 'OUT', 'OFFSIDE', 'GOAL', 'OWNGOAL', 'YELLOW_CARD',
           'RED_CARD', 'CORNER', 'FREEKICK')
    assert [getattr(tconfig, n) for n in ids] == [getattr(jconfig, n) for n in ids]
    assert (tconfig.INTERCEPTION, tconfig.GOAL, tconfig.OWNGOAL) == (10, 27, 28)
    pd.testing.assert_frame_equal(tconfig.actiontypes_df(), jconfig.actiontypes_df())
    assert tatomic._ONEHOT_GROUPS == jatomic._ONEHOT_GROUPS and len(tatomic._ONEHOT_GROUPS) == 32


def test_the_draw_hits_every_edge(batches):
    _, tb = batches
    t = tb.type_id[tb.mask]
    assert set(t.unique().tolist()) == set(range(33))
    assert (tb.dx[tb.mask] == 0).any() and (tb.dy[tb.mask] == 0).any()
    assert ((tb.dx == 0) & (tb.dy == 0))[tb.mask].any()
    s = tatomic._AtomicStates(tb, 1)
    on_line = (s.x[0] == tconfig.field_length) & tb.mask
    assert on_line.any() and (on_line & (s.y[0] == tconfig.field_width / 2)).any()
    assert (tb.type_id[~tb.mask] == tconfig.GOAL).any()  # goals in the padding


@pytest.mark.parametrize('name', list(tatomic.ATOMIC_KERNELS))
def test_feature_kernel_matches_jax(batches, name):
    """Each kernel at k = 3: integer-valued and exact-arithmetic columns
    bitwise, the trigonometry and square roots within 1e-6 (absolute, and
    relative for distances over 1: a square root may round one ulp apart)."""
    jb, tb = batches
    want = np.asarray(jatomic.ATOMIC_KERNELS[name](jatomic._AtomicStates(jb, K)))
    got = tatomic.ATOMIC_KERNELS[name](tatomic._AtomicStates(tb, K)).numpy()
    assert got.shape == want.shape
    assert got.shape[-1] == kernel_width(name, K, tatomic.ATOMIC_WIDTHS)
    assert np.isfinite(got).all()
    if name in EXACT:
        np.testing.assert_array_equal(got, want)
    else:
        np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize('k', [1, 3, 5])
def test_compute_features_matches_jax(batches, k):
    jb, tb = batches
    want = np.asarray(jatomic.compute_features(jb, names=NAMES, k=k))
    got = tatomic.compute_features(tb, names=NAMES, k=k).numpy()
    assert got.shape == want.shape
    assert got.shape[-1] == tfused.train_layout(NAMES, k, tfused.ATOMIC_REGISTRY).n_features
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-6)


def test_labels_match_jax_bitwise(batches):
    jb, tb = batches
    for want, got in zip(jatomic.scores_concedes(jb), tatomic.scores_concedes(tb)):
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    assert tatomic.scores_concedes(tb)[0][tb.mask].any()


def test_labels_never_read_padding(batches):
    """The lookahead stops at each game's last valid row: turning every
    padding row into a goal of either team changes no valid row's label."""
    _, tb = batches
    before = tatomic.scores_concedes(tb)
    pad = ~tb.mask
    goals = tbatch.AtomicActionBatch(**{
        **tb.fields(),
        'type_id': torch.where(pad, tconfig.GOAL, tb.type_id),
        'is_home': torch.where(pad, ~tb.is_home, tb.is_home),
    })
    for a, b in zip(before, tatomic.scores_concedes(goals)):
        assert torch.equal(a[tb.mask], b[tb.mask])


def test_formula_matches_jax(batches):
    jb, tb = batches
    rng = np.random.default_rng(4)
    ps, pc = (rng.uniform(0, 0.3, size=tb.mask.shape).astype(np.float32) for _ in range(2))
    want = np.asarray(jatomic.vaep_values(jb, jnp.asarray(ps), jnp.asarray(pc)))
    got = tatomic.vaep_values(tb, torch.from_numpy(ps), torch.from_numpy(pc)).numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-6)
    # a previous goal resets, and no prior or phase cutoff applies
    prev_goal = np.zeros_like(tb.mask.numpy())
    prev_goal[:, 1:] = tb.type_id.numpy()[:, :-1] == tconfig.GOAL
    np.testing.assert_array_equal(got[..., 0][prev_goal], ps[prev_goal])


# -- packing ------------------------------------------------------------------------------------


def test_pack_atomic_actions_matches_jax(atomic_spadl_actions):
    df = atomic_spadl_actions
    home = int(df['team_id'].iloc[0])
    jb, jids = jbatch.pack_atomic_actions(df, home_team_id=home)
    tb, tids = tbatch.pack_atomic_actions(df, home_team_id=home, device='cpu')
    assert isinstance(tb, tbatch.AtomicActionBatch) and tids == jids
    for name, t in tb.fields().items():
        want = np.asarray(getattr(jb, name))
        assert t.numpy().dtype == want.dtype, name
        np.testing.assert_array_equal(t.numpy(), want, err_msg=name)
    padded = tbatch.pad_batch_games(tb, 4)
    assert isinstance(padded, tbatch.AtomicActionBatch) and padded.n_games == 4
    assert padded.row_index[1:].eq(-1).all() and padded.n_actions[1:].eq(0).all()
    assert isinstance(tb.to('cpu'), tbatch.AtomicActionBatch)
    values = torch.arange(tb.n_games * tb.max_actions, dtype=torch.float32).reshape(tb.type_id.shape)
    np.testing.assert_array_equal(
        tbatch.unpack_values(values, tb), jbatch.unpack_values(jnp.asarray(values.numpy()), jb)
    )


# -- the fused layout and kernel B1 at the atomic shape -------------------------------------


@pytest.fixture(scope='module')
def packed(batches):
    jb, tb = batches
    return (
        jfused.build_train_states(jb, names=NAMES, k=K, registry_name='atomic'),
        tfused.build_train_states(tb, names=NAMES, k=K, registry=tfused.ATOMIC_REGISTRY),
    )


def test_atomic_layout_matches_jax(packed):
    (_, jlayout), (_, tlayout) = packed
    assert tlayout.n_features == jlayout.n_features == N_FEATURES
    assert tlayout.spans == jlayout.spans and tlayout.registry_name == 'atomic'
    assert tlayout.n_dense == N_DENSE
    assert tfused.ATOMIC_REGISTRY.combo_size == jfused.ATOMIC_REGISTRY.combo_size == R


def test_build_train_states_match_jax(packed, batches):
    """ids and weights bitwise, x_dense within 1e-6 (as the features);
    both 'interception' ids fall in one type group."""
    (jstates, _), (tstates, _) = packed
    np.testing.assert_array_equal(tstates.combo_ids.numpy(), np.asarray(jstates.combo_ids))
    np.testing.assert_array_equal(tstates.weight.numpy(), np.asarray(jstates.weight))
    assert tstates.x_dense.shape == (4 * 256, N_DENSE)
    np.testing.assert_allclose(
        tstates.x_dense.numpy(), np.asarray(jstates.x_dense), rtol=1e-6, atol=1e-6
    )
    types = batches[1].type_id.reshape(-1)
    group = tstates.combo_ids[:, 0] // 4
    assert (group[types == 24] == 10).all() and (group[types == 10] == 10).all()
    assert (group[types == 25] == 24).all()  # the groups after it shift down one


def test_packed_feature_stats_match_jax(packed):
    """The statistics pass (B2's plain version here) against JAX: std within
    rtol 1e-6, mean within 1e-6 of max(|mean|, std), as
    ``tests/test_torch_train.py`` holds the standard layout."""
    (jstates, jlayout), (tstates, tlayout) = packed
    jmean, jstd = (np.asarray(a, np.float64) for a in jfused.packed_feature_stats(jstates, jlayout))
    tmean, tstd = (a.numpy().astype(np.float64) for a in tfused.packed_feature_stats(tstates, tlayout))
    assert tmean.shape == (N_FEATURES,)
    np.testing.assert_allclose(tstd, jstd, rtol=1e-6, atol=1e-7)
    assert (np.abs(tmean - jmean) <= 1e-6 * np.maximum(np.abs(jmean), jstd) + 1e-12).all()


@pytest.mark.parametrize('method', ['xla', 'pallas'])
def test_fused_first_layer_at_the_atomic_shape_matches_jax(packed, method):
    """B1's plain version and its backward at R = 128, D = 46 (real atomic
    ids and dense columns), against ``jax.vjp`` of the JAX entry: forward
    and cotangents within 1e-5 of their largest entry."""
    _, (tstates, _) = packed
    rng = np.random.default_rng(7)
    h = 16
    tables = rng.normal(size=(K, R, h)).astype(np.float32)
    w = rng.normal(0, N_DENSE ** -0.5, size=(N_DENSE, h)).astype(np.float32)
    bias = rng.normal(size=h).astype(np.float32)
    ids = tstates.combo_ids.numpy()
    x = tstates.x_dense.numpy() / 100.0
    g = rng.normal(size=(ids.shape[0], h)).astype(np.float32)
    out, vjp = jax.vjp(
        lambda t, w_, b, x_: jgm.fused_first_layer(t, w_, b, jnp.asarray(ids), x_, method),
        *(jnp.asarray(a) for a in (tables, w, bias, x)),
    )
    want = [np.asarray(out), *(np.asarray(c) for c in vjp(jnp.asarray(g)))]
    leaves = [torch.from_numpy(a).requires_grad_(True) for a in (tables, w, bias, x)]
    got_out = tgm.fused_first_layer(leaves[0], leaves[1], leaves[2], torch.from_numpy(ids), leaves[3])
    got_out.backward(torch.from_numpy(g))
    got = [got_out.detach().numpy(), *(t.grad.numpy() for t in leaves)]
    for name, a, b in zip(('out', 'd_tables', 'd_w', 'd_bias', 'd_x'), got, want):
        assert a.shape == b.shape, name
        gap = float(np.abs(a.astype(np.float64) - b).max() / np.abs(b).max())
        assert gap <= 1e-5, (name, gap)


# -- serving -------------------------------------------------------------------------------------


def _stats(jb):
    X = np.asarray(jatomic.compute_features(jb, names=NAMES, k=K)).reshape(-1, N_FEATURES)
    std = X.std(axis=0)
    return X.mean(axis=0).astype(np.float32), np.where(std > 0, std, 1.0).astype(np.float32)


def _jax_model(hidden, stats_batch):
    """A JAX AtomicVAEP with seeded numpy MLP heads."""
    mean, std = _stats(stats_batch)
    model = JaxAtomicVAEP()
    for seed, col in enumerate(('scores', 'concedes')):
        rng = np.random.default_rng(30 + seed)
        widths = (N_FEATURES, *hidden, 1)
        clf = jmlp.MLPClassifier(hidden=hidden)
        clf.params = {'params': {
            f'Dense_{i}': {
                'kernel': jnp.asarray(
                    rng.normal(0, widths[i] ** -0.5, (widths[i], widths[i + 1])).astype(np.float32)
                ),
                'bias': jnp.asarray(rng.normal(0, 0.1, widths[i + 1]).astype(np.float32)),
            }
            for i in range(len(widths) - 1)
        }}
        clf.mean_, clf.std_ = mean, std
        model._models[col] = clf
    return model


@pytest.fixture(scope='module')
def pair(batches, tmp_path_factory):
    """(JAX model, the port's model loaded from the JAX model's checkpoint)."""
    jmodel = _jax_model((16,), batches[0])
    path = str(tmp_path_factory.mktemp('atomic'))
    jmodel.save_model(path)
    with open(f'{path}/meta.json') as f:
        assert json.load(f)['class'] == 'AtomicVAEP'
    return jmodel, load_model(path, device='cpu')


def _close(got, want, mask, atol=ATOL):
    got, want = got.numpy(), np.asarray(want)
    assert got.shape == want.shape
    np.testing.assert_allclose(got[mask], want[mask], rtol=0, atol=atol)


def test_jax_checkpoint_loads_as_atomic_vaep(pair):
    _, model = pair
    assert type(model) is AtomicVAEP and model.xfns == NAMES
    assert all(isinstance(m, tmlp.MLPClassifier) for m in model._models.values())


def test_rate_batch_matches_jax(pair, batches):
    """f32 values within 1e-5 of JAX's on its default lowering; the port's
    reference path too; bucketing pads 4 games to no more."""
    jmodel, model = pair
    jb, tb = batches
    mask = tb.mask.numpy()
    want = jmodel.rate_batch(jb)
    _close(model.rate_batch(tb), want, mask)
    _close(model.rate_batch_reference(tb), want, mask)
    three_j, three_t = atomic_batches(N_ACTIONS[:3], seed=2)  # buckets to 4 games
    _close(model.rate_batch(three_t), jmodel.rate_batch(three_j), three_t.mask.numpy())


def test_rate_batch_matches_jax_pallas_kernel(pair, batches, monkeypatch, jax_atomic_fold):
    """JAX through its Pallas kernel (interpret mode) at R = 128, D = 46;
    the folded f32 tables bitwise."""
    jmodel, model = pair
    monkeypatch.setenv('SOCCERACTION_TPU_FUSED_KERNEL', 'pallas')
    jb, tb = batches
    _close(model.rate_batch(tb), jmodel.rate_batch(jb), tb.mask.numpy())
    want = np.asarray(jmodel._prepared_pair().tables.data)
    got = model._prepared_pair().tables.data.numpy()
    assert got.shape == want.shape == (K, R, 32)
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize('mode', ['bf16', 'int8'])
def test_quantized_modes_match_jax(pair, batches, mode, jax_atomic_fold):
    """The same quantized bytes in both packages, so the values agree
    within 1e-5 in each mode."""
    jmodel, model = pair
    jb, tb = batches
    try:
        jmodel.set_quantize(mode)
        model.set_quantize(mode)
        for w, g in zip(jmodel._prepared_pair().tables, model._prepared_pair().tables):
            if w is None:
                continue
            w = np.asarray(w)
            g = g.view(torch.int16).numpy() if g.dtype == torch.bfloat16 else g.numpy()
            assert g.tobytes() == (w.view(np.int16) if mode == 'bf16' else w).tobytes()
        _close(model.rate_batch(tb), jmodel.rate_batch(jb), tb.mask.numpy())
    finally:
        jmodel.set_quantize('none')
        model.set_quantize('none')


@pytest.mark.parametrize('name', ['actiontype', 'bodypart', 'time'])
def test_dense_overrides_match_jax(pair, name):
    """A dense block substituted by name: rate_batch and its reference
    within 1e-6 of the JAX package's rate_batch with the same block
    (measured about 3.3e-7), on 3 games bucketed to 4."""
    jmodel, model = pair
    jb, tb = atomic_batches(N_ACTIONS[:3], seed=5)
    width = jmodel._dense_override_widths(jb)[name]
    block = np.random.default_rng(11).normal(size=(3, 256, width)).astype(np.float32)
    want = jmodel.rate_batch(jb, dense_overrides={name: jnp.asarray(block)})
    mask = tb.mask.numpy()
    _close(model.rate_batch(tb, dense_overrides={name: torch.from_numpy(block)}), want, mask,
           atol=1e-6)
    _close(model.rate_batch_reference(tb, dense_overrides={name: block}), want, mask, atol=1e-6)


def test_rate_matches_jax_on_the_golden_game(pair, atomic_spadl_actions):
    jmodel, model = pair
    game = pd.Series({'home_team_id': int(atomic_spadl_actions['team_id'].iloc[0])})
    want = jmodel.rate(game, atomic_spadl_actions)
    got = model.rate(game, atomic_spadl_actions)
    assert list(got.columns) == list(want.columns) and got.index.equals(want.index)
    np.testing.assert_allclose(got.to_numpy(), want.to_numpy(), rtol=0, atol=ATOL)


def test_atomic_model_takes_only_atomic_batches(pair):
    _, model = pair
    with pytest.raises(TypeError, match='AtomicVAEP takes AtomicActionBatch'):
        model.rate_batch(synthetic_batch(1, 128, device='cpu'))
    with pytest.raises(TypeError, match='AtomicVAEP takes AtomicActionBatch'):
        AtomicVAEP(device='cpu').fit_packed(synthetic_batch(1, 128, device='cpu'))


# -- training -----------------------------------------------------------------------------------


def test_minibatch_training_matches_jax(packed, batches, monkeypatch):
    """An atomic MLP head (32, 16) from JAX's init, JAX's permutation
    injected, minibatches of 256 over 1024 rows for 3 epochs at lr 3e-4:
    parameters within 1e-4, the JAX package's training-parity bound."""
    jb, tb = batches
    y = np.asarray(jatomic.scores_concedes(jb)[0]).reshape(-1).astype(np.float32)

    def jax_permutation(self, epoch):
        key = jax.random.fold_in(jax.random.PRNGKey(self.seed), epoch)
        return torch.from_numpy(np.asarray(jax.random.permutation(key, self.n)).astype(np.int64))

    monkeypatch.setattr(tmlp._EpochTrainer, '_permutation', jax_permutation)
    hyper = dict(hidden=(32, 16), seed=0, batch_size=256, max_epochs=3, learning_rate=3e-4)
    jclf = jmlp.MLPClassifier(**hyper)
    jclf.fit_packed(jb, y, names=NAMES, k=K, registry='atomic')
    init = jax.tree.map(np.asarray, jmlp.MLPClassifier(**hyper)._init_params(N_FEATURES))
    tclf = tmlp.MLPClassifier(**hyper, device='cpu')
    tclf.fit_packed(tb, y, names=NAMES, k=K, registry='atomic',
                    init_params=convert.module_from_jax_params(init))
    np.testing.assert_allclose(tclf.mean_.numpy(), jclf.mean_, rtol=1e-6, atol=1e-6)
    tree = convert.jax_params_from_mlp(tclf.module)['params']
    gap = max(
        float(np.abs(tree[layer][leaf] - np.asarray(jclf.params['params'][layer][leaf])).max())
        for layer in tree for leaf in ('kernel', 'bias')
    )
    assert gap <= 1e-4, gap
    assert tclf.opt_state_.count == 3 * 4


def test_materialized_path_reads_the_atomic_features(batches):
    """The materialized training path builds the atomic feature matrix and
    agrees with the fused one (same init, full batch, one epoch)."""
    _, tb = batches
    y = tatomic.scores_concedes(tb)[0]
    fits = [
        tmlp.MLPClassifier(hidden=(16,), batch_size=2048, max_epochs=1, device='cpu').fit_packed(
            tb, y, names=NAMES, k=K, registry='atomic', path=path
        )
        for path in ('fused', 'materialized')
    ]
    for p, q in zip(fits[0].module.parameters(), fits[1].module.parameters()):
        assert float((p - q).abs().max()) <= 1e-5


@pytest.fixture(scope='module')
def fitted():
    """(JAX AtomicVAEP, the port's AtomicVAEP), fit on the same pairs."""
    tree = dict(hidden=(32, 16), batch_size=512, max_epochs=3)

    def pairs(side):
        return [
            (atomic_batches((256, 200, 256, 90), seed=3)[side], [0, 1, 2, 3]),
            (atomic_batches((256, 31), seed=11)[side], [4, 5]),
        ]

    jmodel = JaxAtomicVAEP().fit_packed(pairs(0), tree_params=tree, random_state=0)
    model = AtomicVAEP(device='cpu').fit_packed(pairs(1), tree_params=tree, random_state=0)
    return jmodel, model


def test_fit_packed_end_to_end(fitted):
    """Statistics as the JAX package's; healthy heads; the fitted model's
    rate_batch within 1e-5 of its reference."""
    jmodel, model = fitted
    for col in ('scores', 'concedes'):
        jclf, clf = jmodel._models[col], model._models[col]
        jmean, jstd = jclf.mean_.astype(np.float64), jclf.std_.astype(np.float64)
        mean, std = clf.mean_.numpy().astype(np.float64), clf.std_.numpy().astype(np.float64)
        np.testing.assert_allclose(std, jstd, rtol=1e-6, atol=0)
        assert (np.abs(mean - jmean) <= 1e-6 * np.maximum(np.abs(jmean), jstd)).all()
        health = clf.train_health_
        assert health['finite'] and health['epochs'] == 3 and health['path'] == 'fused'
    _, tb = atomic_batches(seed=5)
    values = model.rate_batch(tb)
    assert torch.isfinite(values[tb.mask]).all()
    _close(values, model.rate_batch_reference(tb).numpy(), tb.mask.numpy())


def test_port_checkpoint_loads_in_jax(fitted, tmp_path):
    """The port's save_model stamps class AtomicVAEP; the JAX package's
    load_model dispatches on it and rates within 1e-5; the port reads its
    own checkpoint back bitwise."""
    _, model = fitted
    model.save_model(str(tmp_path))
    with open(tmp_path / 'meta.json') as f:
        meta = json.load(f)
    assert meta['class'] == 'AtomicVAEP' and meta['format_version'] == 1
    assert meta['xfns'] == list(NAMES)
    jmodel = jax_load_model(str(tmp_path))
    assert type(jmodel).__name__ == 'AtomicVAEP'
    jb, tb = atomic_batches(seed=8)
    _close(model.rate_batch(tb), jmodel.rate_batch(jb), tb.mask.numpy())
    back = load_model(str(tmp_path), device='cpu')
    assert type(back) is AtomicVAEP
    assert torch.equal(back.rate_batch(tb), model.rate_batch(tb))


def test_warm_start_keeps_the_atomic_layout(fitted):
    _, model = fitted
    warm = AtomicVAEP(device='cpu').fit_packed(
        atomic_batches(seed=21)[1], tree_params={'max_epochs': 0}, random_state=1,
        warm_start=model,
    )
    for col in ('scores', 'concedes'):
        for p, q in zip(warm._models[col].module.parameters(), model._models[col].module.parameters()):
            assert torch.equal(p, q) and p is not q
