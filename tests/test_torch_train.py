"""The port's training ops and trainer against the JAX package.

Seeded numpy inputs (``synthetic_batch`` is bitwise equal in both
packages) go through the JAX function and its port, on the CPU, at a small
size: 5 games x 256 actions, heads of (32, 16), minibatches of 512. The
port runs its plain versions here (kernel B1's plain forward); the JAX
package runs XLA or its Pallas kernel in interpret mode. Each test states
its tolerance. The card's side of the same functions is in
``tests/test_torch_train_card.py``.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from socceraction_tpu.core.synthetic import synthetic_batch as jax_synthetic_batch
from socceraction_tpu.ml import mlp as jmlp
from socceraction_tpu.ops import fused as jfused
from socceraction_tpu.ops import gather_matmul as jgm
from socceraction_tpu.ops import labels as jlabels
from socceraction_tpu.ops import quant as jquant
from socceraction_tpu_torch import convert
from socceraction_tpu_torch.core.synthetic import synthetic_batch
from socceraction_tpu_torch.ml import mlp as tmlp
from socceraction_tpu_torch.ops import fused as tfused
from socceraction_tpu_torch.ops import gather_matmul as tgm
from socceraction_tpu_torch.ops import labels as tlabels
from socceraction_tpu_torch.ops import quant as tquant
from socceraction_tpu_torch.vaep.base import XFNS_DEFAULT

NAMES = XFNS_DEFAULT
K = 3
R = 552
HIDDEN = (32, 16)


@pytest.fixture(scope='module', autouse=True)
def _drain_train_states_storm_window():
    """Retire this module's packing compiles from the JAX compile
    observatory's storm window (as tests/test_torch_vaep.py does)."""
    yield
    jfused._train_states_arrays.drain_storm_window()


@pytest.fixture(scope='module')
def batches():
    """(JAX batch, port batch): 5 games x 256 actions, 20% padding."""
    args = dict(fill=0.8, seed=3)
    return jax_synthetic_batch(5, 256, **args), synthetic_batch(5, 256, device='cpu', **args)


@pytest.fixture(scope='module')
def packed(batches):
    jb, tb = batches
    return (
        jfused.build_train_states(jb, names=NAMES, k=K),
        tfused.build_train_states(tb, names=NAMES, k=K),
    )


@pytest.fixture(scope='module')
def labels(batches):
    ys, _ = jlabels.scores_concedes(batches[0])
    return np.asarray(ys).reshape(-1).astype(np.float32)


def _jax_params(seed, n_features=568, hidden=HIDDEN):
    """A flax init of the JAX head, as a numpy pytree."""
    clf = jmlp.MLPClassifier(hidden=hidden, seed=seed)
    return jax.tree.map(np.asarray, clf._init_params(n_features))


def _max_rel(got, want):
    """Largest difference over the largest magnitude of ``want``."""
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return float(np.abs(got - want).max() / max(np.abs(want).max(), 1e-30))


# -- labels, fake_quant ----------------------------------------------------------


def test_labels_match_jax_bitwise(batches):
    jb, tb = batches
    for want, got in zip(jlabels.scores_concedes(jb), tlabels.scores_concedes(tb)):
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    np.testing.assert_array_equal(
        tlabels.goal_from_shot(tb).numpy(), np.asarray(jlabels.goal_from_shot(jb))
    )
    # the windows do see goals: not a comparison of all-False tensors
    assert tlabels.scores_concedes(tb)[0].any()


@pytest.mark.parametrize('mode', ['bf16', 'int8'])
def test_fake_quant_forward_bitwise_gradient_identity(mode):
    rng = np.random.default_rng(4)
    t = rng.normal(size=(3, 40, 24)).astype(np.float32)
    want = np.asarray(jquant.fake_quant(jnp.asarray(t), mode))
    x = torch.from_numpy(t).requires_grad_(True)
    got = tquant.fake_quant(x, mode)
    assert got.numpy(force=True).tobytes() == want.tobytes()
    assert not np.array_equal(want, t)  # the round trip did round
    g = torch.from_numpy(rng.normal(size=t.shape).astype(np.float32))
    got.backward(g)
    np.testing.assert_array_equal(x.grad.numpy(), g.numpy())


def test_fake_quant_none_is_the_identity():
    t = torch.randn(4, 5)
    assert tquant.fake_quant(t, 'none') is t


# -- the differentiable first layer ------------------------------------------------


def _first_layer_operands(n=300, h=16, d=55, seed=0):
    rng = np.random.default_rng(seed)
    ids = rng.integers(0, R, size=(n, K)).astype(np.int32)
    ids[rng.random((n, K)) < 0.08] = -1  # padding rows
    ids[rng.random((n, K)) < 0.04] = R  # just past the table
    ids[rng.random((n, K)) < 0.04] = R + 77
    return (
        rng.normal(size=(K, R, h)).astype(np.float32),
        rng.normal(0, d ** -0.5, size=(d, h)).astype(np.float32),
        rng.normal(size=h).astype(np.float32),
        ids,
        rng.normal(size=(n, d)).astype(np.float32),
        rng.normal(size=(n, h)).astype(np.float32),  # the cotangent
    )


@pytest.mark.parametrize('method', ['xla', 'pallas'])
def test_fused_first_layer_forward_and_cotangents_match_jax(method):
    """Forward and the four cotangents against ``jax.vjp`` of the JAX
    entry, within 1e-5 (relative to the largest entry): the port sums the
    rows of a table cotangent with ``index_add_``, the JAX package with a
    scatter, in another order."""
    tables, w, bias, ids, x, g = _first_layer_operands()
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
        assert _max_rel(a, b) <= 1e-5, (name, _max_rel(a, b))
    # ids outside [0, R) add nothing to the table cotangent: it holds
    # exactly the cotangent rows of the valid ids
    valid = (ids >= 0) & (ids < R)
    np.testing.assert_allclose(
        got[1].sum(axis=(1, 2)), [g[valid[:, i]].sum() for i in range(K)], rtol=1e-5
    )


def test_fused_first_layer_skips_the_data_cotangent():
    """``x_dense`` is data in training: its cotangent is not computed."""
    tables, w, bias, ids, x, g = _first_layer_operands(n=40)
    t = torch.from_numpy(tables).requires_grad_(True)
    out = tgm.fused_first_layer(t, torch.from_numpy(w), torch.from_numpy(bias),
                                torch.from_numpy(ids), torch.from_numpy(x))
    out.backward(torch.from_numpy(g))
    assert t.grad is not None
    with pytest.raises(TypeError, match='f32 tables'):
        tgm.fused_first_layer(t.detach().to(torch.bfloat16), torch.from_numpy(w),
                              torch.from_numpy(bias), torch.from_numpy(ids), torch.from_numpy(x))


def test_table_lookup_backward_is_the_fused_table_cotangent():
    """The per-gather form and the fused layer give one table cotangent
    (bitwise: the same segment sum), and it matches JAX's ``table_lookup``
    within 1e-6."""
    rng = np.random.default_rng(1)
    table = rng.normal(size=(R, 8)).astype(np.float32)
    ids = rng.integers(0, R, size=400).astype(np.int32)
    g = rng.normal(size=(400, 8)).astype(np.float32)
    _, vjp = jax.vjp(lambda t: jfused.table_lookup(t, jnp.asarray(ids), R), jnp.asarray(table))
    want = np.asarray(vjp(jnp.asarray(g))[0])
    t = torch.from_numpy(table).requires_grad_(True)
    out = tfused.table_lookup(t, torch.from_numpy(ids), R)
    np.testing.assert_array_equal(out.detach().numpy(), table[ids])
    out.backward(torch.from_numpy(g))
    np.testing.assert_allclose(t.grad.numpy(), want, rtol=0, atol=1e-6)
    t2 = torch.from_numpy(table[None]).requires_grad_(True)
    tgm.fused_first_layer(
        t2, torch.zeros((0, 8)), torch.zeros(8), torch.from_numpy(ids[:, None]), torch.zeros((400, 0))
    ).backward(torch.from_numpy(g))
    np.testing.assert_array_equal(t2.grad[0].numpy(), t.grad.numpy())


# -- packed states and statistics ------------------------------------------------------


def test_build_train_states_match_jax(packed):
    """ids and weights bitwise; x_dense within 1e-6 (the feature kernels'
    f32 trigonometry and square roots round apart by an ulp)."""
    (jstates, jlayout), (tstates, tlayout) = packed
    np.testing.assert_array_equal(tstates.combo_ids.numpy(), np.asarray(jstates.combo_ids))
    np.testing.assert_array_equal(tstates.weight.numpy(), np.asarray(jstates.weight))
    np.testing.assert_allclose(
        tstates.x_dense.numpy(), np.asarray(jstates.x_dense), rtol=1e-6, atol=1e-6
    )
    assert tlayout.spans == jlayout.spans
    assert tlayout.n_features == jlayout.n_features == 568
    two = tfused.concat_train_states([tstates, tstates])
    assert two.x_dense.shape[0] == 2 * tstates.x_dense.shape[0]
    with pytest.raises(ValueError, match='zero'):
        tfused.concat_train_states([])


def test_packed_feature_stats_match_jax(packed):
    """Against the JAX package's ``packed_feature_stats``: std within rtol
    1e-6; mean within 1e-6 of max(|mean|, std), since a dense column whose
    mean sums to near zero (movement, angles) has no relative precision,
    and what reaches training is the mean over the std.

    The reference itself misses the materialized statistics
    (``tests/test_fused_train.py::test_packed_stats_match_materialized``):
    15 of 568 columns outside atol 1e-5 by up to 6.1e-4, f32 rounding on
    large-valued columns (the time features), about 2e-7 relative. The
    port accumulates the dense moments in float64, so the card and the CPU
    agree on them whatever their reduction order.
    """
    (jstates, jlayout), (tstates, tlayout) = packed
    jmean, jstd = (np.asarray(a, np.float64) for a in jfused.packed_feature_stats(jstates, jlayout))
    tmean, tstd = (a.numpy().astype(np.float64) for a in tfused.packed_feature_stats(tstates, tlayout))
    np.testing.assert_allclose(tstd, jstd, rtol=1e-6, atol=0)
    scale = np.maximum(np.abs(jmean), jstd)
    assert (np.abs(tmean - jmean) <= 1e-6 * scale).all(), np.abs(tmean - jmean).max()
    # one-hot columns are frequencies: equal
    onehot = np.zeros(568, bool)
    for _, kind, off, width in tlayout.spans:
        onehot[off : off + width] = kind == 'onehot'
    np.testing.assert_array_equal(tmean[onehot], jmean[onehot])


# -- logits and gradients ----------------------------------------------------------------


def _stats(jstates, jlayout):
    mean, raw_std = jfused.packed_feature_stats(jstates, jlayout)
    std = np.where(np.asarray(raw_std) > 0, np.asarray(raw_std), 1.0).astype(np.float32)
    return np.array(mean), std


@pytest.mark.parametrize(
    'quantize, train_dtype, kernel, tol',
    [
        # same function, reordered f32 sums
        ('none', None, 'xla', 1e-5),
        ('none', None, 'pallas', 1e-5),
        # the fake-quantized tables are bitwise equal; the sums reorder
        ('bf16', None, 'xla', 1e-5),
        ('int8', None, 'xla', 1e-5),
        # the fused branch (f32 dense product, as the port always runs it)
        # with the narrowed hidden chain: both chains round at the same
        # points, and on these inputs no f32 reorder of the first layer
        # moves an activation across a bf16 boundary (measured 1.2e-7)
        ('none', 'bfloat16', 'pallas', 1e-5),
    ],
    ids=['f32-xla', 'f32-pallas', 'qat-bf16', 'qat-int8', 'bf16-hidden'],
)
def test_fused_train_logits_match_jax(packed, quantize, train_dtype, kernel, tol):
    (jstates, jlayout), (tstates, tlayout) = packed
    params = _jax_params(0)
    mean, std = _stats(jstates, jlayout)
    want = np.asarray(jfused.fused_train_logits(
        params, jstates.x_dense, jstates.combo_ids, layout=jlayout, hidden_layers=2,
        mean=jnp.asarray(mean), std=jnp.asarray(std),
        compute_dtype=None if train_dtype is None else jnp.bfloat16,
        quantize=quantize, kernel=kernel,
    ))
    module = convert.module_from_jax_params(params)

    def port(compute_dtype):
        return tfused.fused_train_logits(
            module, tstates.x_dense, tstates.combo_ids, layout=tlayout,
            mean=torch.from_numpy(mean), std=torch.from_numpy(std),
            compute_dtype=compute_dtype, quantize=quantize,
        ).detach().numpy()

    got = port(None if train_dtype is None else torch.bfloat16)
    assert got.shape == want.shape == (5 * 256,)
    np.testing.assert_allclose(got, want, rtol=0, atol=tol)
    if train_dtype is not None:
        # narrowing moves the logits by far more than the bound: a port
        # that ignored hidden_dtype would fail it (measured 4.2e-3)
        assert np.abs(port(None) - want).max() > 100 * tol


def test_hidden_chain_bf16_rounds_as_jax():
    """The narrowed hidden chain on one first-layer output in both
    packages, with nonzero biases: logits within 1e-6 (the f32 logit head
    reorders its sum). The chain rounds to bf16 after the product and
    again after the bias add, as JAX's ``x @ kern + bias`` does; rounding
    once, after the add, misses by 4.7e-3, and the f32 chain by 5.1e-3."""
    params = _jax_params(0)
    rng = np.random.default_rng(11)
    for layer in params['params'].values():
        layer['bias'] = rng.normal(0, 0.3, size=layer['bias'].shape).astype(np.float32)
    h = rng.normal(size=(2000, HIDDEN[0])).astype(np.float32)
    want = np.asarray(jfused._hidden_chain(
        jax.tree.map(jnp.asarray, params['params']), jnp.asarray(h), 2, jnp.bfloat16
    ))
    module = convert.module_from_jax_params(params)
    got = tfused._hidden_chain(module, torch.from_numpy(h), torch.bfloat16).detach().numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-6)
    f32 = tfused._hidden_chain(module, torch.from_numpy(h)).detach().numpy()
    assert np.abs(f32 - want).max() > 1e-3


def test_loss_and_gradient_match_jax_value_and_grad(packed, labels):
    """One minibatch's loss within 1e-6 and every gradient within 1e-5 of
    ``jax.value_and_grad`` (relative to the gradient's largest entry)."""
    (jstates, jlayout), (tstates, tlayout) = packed
    params = _jax_params(1)
    mean, std = _stats(jstates, jlayout)
    rows = np.random.default_rng(2).permutation(labels.shape[0])[:512]
    w = np.ones(512, np.float32)

    def jloss(p):
        logits = jfused.fused_train_logits(
            p, jstates.x_dense[rows], jstates.combo_ids[rows], layout=jlayout,
            hidden_layers=2, mean=jnp.asarray(mean), std=jnp.asarray(std),
        )
        return jmlp._weighted_bce(logits, labels[rows], w * np.asarray(jstates.weight)[rows], 2.0)

    jl, jg = jax.value_and_grad(jloss)(jax.tree.map(jnp.asarray, params))
    module = convert.module_from_jax_params(params).requires_grad_(True)
    r = torch.from_numpy(rows)
    logits = tfused.fused_train_logits(
        module, tstates.x_dense[r], tstates.combo_ids[r], layout=tlayout,
        mean=torch.from_numpy(mean), std=torch.from_numpy(std),
    )
    tl = tmlp._weighted_bce(
        logits, torch.from_numpy(labels[rows]), torch.from_numpy(w) * tstates.weight[r], 2.0
    )
    tl.backward()
    assert abs(tl.item() - float(jl)) <= 1e-6
    for i, layer in enumerate(module.layers()):
        jg_i = jg['params'][f'Dense_{i}']
        assert _max_rel(layer.weight.grad.numpy().T, jg_i['kernel']) <= 1e-5, i
        assert _max_rel(layer.bias.grad.numpy(), jg_i['bias']) <= 1e-5, i


# -- training parity ------------------------------------------------------------------------


def _max_param_gap(jparams, module):
    tree = convert.jax_params_from_mlp(module)['params']
    return max(
        float(np.abs(tree[layer][leaf] - np.asarray(jparams['params'][layer][leaf])).max())
        for layer in tree for leaf in ('kernel', 'bias')
    )


def _train_both(batches, labels, monkeypatch=None, **hyper):
    """Train the JAX head and the port's head from the JAX init."""
    jb, tb = batches
    jclf = jmlp.MLPClassifier(hidden=HIDDEN, seed=0, **hyper)
    jclf.fit_packed(jb, labels, names=NAMES, k=K)
    tclf = tmlp.MLPClassifier(hidden=HIDDEN, seed=0, device='cpu', **hyper)
    tclf.fit_packed(
        tb, labels, names=NAMES, k=K, init_params=convert.module_from_jax_params(_jax_params(0))
    )
    return jclf, tclf


def test_full_batch_training_matches_jax(batches, labels):
    """One step per epoch (batch_size >= n), where the row order only
    reorders sums: parameters within 1e-4 after 5 epochs, the JAX
    package's own training-parity bound."""
    jclf, tclf = _train_both(batches, labels, batch_size=4096, max_epochs=5)
    np.testing.assert_allclose(tclf.mean_.numpy(), jclf.mean_, rtol=1e-6, atol=1e-6)
    gap = _max_param_gap(jclf.params, tclf.module)
    assert gap <= 1e-4, gap
    assert tclf.train_health_['finite'] and tclf.train_health_['epochs'] == 5


def test_minibatch_training_matches_jax_with_its_permutation(batches, labels, monkeypatch):
    """Minibatches of 512 over 1280 rows (three steps, the last with 256
    wrapped slots of weight 0), the JAX package's permutation injected into
    the port's trainer: parameters within 1e-4 after 4 epochs at lr 3e-4
    (Adam's 1/sqrt(v) amplifies reordered sums on rare one-hot rows at
    larger rates, as the JAX package's own parity test notes)."""
    n = labels.shape[0]

    def jax_permutation(self, epoch):
        key = jax.random.fold_in(jax.random.PRNGKey(self.seed), epoch)
        return torch.from_numpy(np.asarray(jax.random.permutation(key, self.n)).astype(np.int64))

    monkeypatch.setattr(tmlp._EpochTrainer, '_permutation', jax_permutation)
    jclf, tclf = _train_both(batches, labels, batch_size=512, max_epochs=4, learning_rate=3e-4)
    assert n == 1280
    gap = _max_param_gap(jclf.params, tclf.module)
    assert gap <= 1e-4, gap
    assert tclf.opt_state_.count == 4 * 3


# -- the port's own trainer ------------------------------------------------------------------


def test_wraparound_tail_slots_carry_zero_weight():
    """ceil-batching wraps the tail; wrapped slots must not double-count
    (mirrors the JAX package's test of its trainer)."""
    p = [torch.zeros(2, requires_grad=True)]
    trainer = tmlp._EpochTrainer(lambda mb, w: 0.0, p, n=700, batch_size=256, seed=0, learning_rate=1e-3)
    assert trainer.steps == 3
    w = trainer.slot_weight.numpy()
    assert w.shape == (3, 256)
    assert w.sum() == 700.0
    assert (w[:2] == 1.0).all()
    assert w[2].sum() == 700 - 2 * 256
    # the wrapped slots point back at the first rows of the permutation
    np.testing.assert_array_equal(trainer.slot_pos.numpy()[700:], np.arange(68))
    full = tmlp._EpochTrainer(lambda mb, w: 0.0, p, n=512, batch_size=256, seed=0, learning_rate=1e-3)
    assert full.slot_weight.sum() == 512.0
    # one permutation per epoch, from the (seed, epoch) stream
    assert not torch.equal(trainer._permutation(0), trainer._permutation(1))
    assert torch.equal(trainer._permutation(1), trainer._permutation(1))


def test_init_params_draw_flax_dense_distribution():
    """LeCun normal truncated at 2σ, zero biases; the same weights for a
    seed, other weights for another seed."""
    clf = tmlp.MLPClassifier(hidden=(256, 64), seed=3, device='cpu')
    module = clf.init_params(568)
    w = module.Dense_0.weight.detach().numpy()
    std = 568 ** -0.5 / 0.87962566103423978
    assert np.abs(w).max() <= 2 * std
    assert abs(w.std() - 568 ** -0.5) < 0.02 * 568 ** -0.5
    assert all(float(layer.bias.detach().abs().max()) == 0.0 for layer in module.layers())
    again = clf.init_params(568).Dense_0.weight
    assert torch.equal(module.Dense_0.weight, again)
    other = tmlp.MLPClassifier(hidden=(256, 64), seed=4, device='cpu').init_params(568)
    assert not torch.equal(other.Dense_0.weight, again)


def test_early_stopping_keeps_the_best_epoch(batches, labels):
    """With patience 2 at a high rate the fit stops early; the kept module
    and Adam state are the best eval epoch's."""
    _, tb = batches
    ev = synthetic_batch(2, 256, fill=0.8, seed=9, device='cpu')
    ev_y = tlabels.scores_concedes(ev)[0].reshape(-1).float()
    clf = tmlp.MLPClassifier(hidden=HIDDEN, batch_size=256, max_epochs=40, patience=2,
                             learning_rate=3e-2, device='cpu')
    clf.fit_packed(tb, labels, names=NAMES, k=K, eval_set=(ev, ev_y))
    health = clf.train_health_
    val = health['val_losses']
    best = int(np.argmin(val))
    assert len(val) < 40, 'the fit should have stopped early'
    assert len(val) == best + 1 + 2
    states, layout = tfused.build_train_states(ev, names=NAMES, k=K)
    with torch.no_grad():
        logits = tfused.fused_train_logits(
            clf.module, states.x_dense, states.combo_ids, layout=layout, mean=clf.mean_, std=clf.std_
        )
        kept = float(tmlp._weighted_bce(logits, ev_y, states.weight, 1.0))
    assert abs(kept - val[best]) <= 1e-6
    assert clf.opt_state_.count == (best + 1) * 5  # 1280 rows in steps of 256
    assert len(health['epoch_losses']) == len(val) == len(health['epoch_seconds'])


def test_fused_and_materialized_paths_agree(batches, labels):
    """The two data paths of the port train the same function from the
    same init and minibatches: parameters within 1e-4 (the JAX package's
    own fused-vs-materialized bound)."""
    _, tb = batches
    clfs = {}
    for path in ('fused', 'materialized'):
        clfs[path] = tmlp.MLPClassifier(
            hidden=HIDDEN, batch_size=512, max_epochs=3, learning_rate=3e-4, device='cpu'
        ).fit_packed(tb, labels, names=NAMES, k=K, path=path)
    a, b = (convert.jax_params_from_mlp(clfs[p].module)['params'] for p in ('fused', 'materialized'))
    gap = max(float(np.abs(a[l][n] - b[l][n]).max()) for l in a for n in ('kernel', 'bias'))
    assert gap <= 1e-4, gap
    with pytest.raises(ValueError, match='unknown training path'):
        tmlp.MLPClassifier(device='cpu').fit_packed(tb, labels, names=NAMES, k=K, path='nope')


def test_bf16_hidden_pipeline_stays_near_f32(batches, labels):
    _, tb = batches
    kw = dict(hidden=(16,), batch_size=512, max_epochs=2, device='cpu')
    f32 = tmlp.MLPClassifier(**kw).fit_packed(tb, labels, names=NAMES, k=K)
    bf16 = tmlp.MLPClassifier(train_dtype='bfloat16', **kw).fit_packed(tb, labels, names=NAMES, k=K)
    gap = max(
        float((p - q).abs().max()) for p, q in zip(f32.module.parameters(), bf16.module.parameters())
    )
    # narrowed, but master weights stay f32 over a short schedule
    assert 0.0 < gap < 0.05, gap


def test_materialized_fit_learns():
    """``fit`` on a feature matrix with an eval set (the JAX package's
    own test of its ``fit``): finite probabilities that learn the label."""
    rng = np.random.default_rng(0)
    X = rng.normal(size=(700, 12)).astype(np.float32)
    y = (X[:, 0] > 0).astype(np.float32)
    clf = tmlp.MLPClassifier(hidden=(8,), batch_size=256, max_epochs=30, patience=3,
                             learning_rate=1e-2, device='cpu')
    clf.fit(X[:600], y[:600], eval_set=(X[600:], y[600:]))
    p = clf.predict_proba(X)
    assert p.shape == (700, 2) and np.isfinite(p).all()
    np.testing.assert_allclose(p.sum(axis=1), 1.0, rtol=1e-6)
    assert clf.train_health_['path'] == 'materialized'
    # it learned the sign of the first column
    assert ((p[:, 1] > 0.5) == (y > 0.5)).mean() > 0.9


def test_warm_start_with_no_epochs_is_a_bitwise_no_op(packed, labels):
    _, (tstates, tlayout) = packed
    params = _jax_params(5)
    clf = tmlp.MLPClassifier(hidden=HIDDEN, max_epochs=0, device='cpu')
    module = convert.module_from_jax_params(params)
    clf.fit_packed((tstates, tlayout), labels, names=NAMES, k=K, init_params=module)
    tree = convert.jax_params_from_mlp(clf.module)['params']
    for layer, leaves in params['params'].items():
        for name, a in leaves.items():
            np.testing.assert_array_equal(tree[layer][name], a)
    with pytest.raises(ValueError, match='unchanged layout'):
        tmlp.MLPClassifier(hidden=(8,), device='cpu').fit_packed(
            (tstates, tlayout), labels, names=NAMES, k=K, init_params=module
        )


# -- checkpoints -----------------------------------------------------------------------------


def test_mlp_checkpoint_loads_in_jax(batches, labels, tmp_path):
    """The port's ``MLPClassifier.save`` loads in the JAX package's
    ``MLPClassifier.load``; both predict within 1e-5, and the port reads
    its own file back bitwise."""
    _, tb = batches
    clf = tmlp.MLPClassifier(hidden=HIDDEN, batch_size=512, max_epochs=1, quantize='bf16',
                             device='cpu').fit_packed(tb, labels, names=NAMES, k=K)
    path = str(tmp_path / 'head.npz')
    clf.save(path)
    jclf = jmlp.MLPClassifier.load(path)
    assert jclf.hidden == HIDDEN and jclf.quantize == 'bf16' and jclf.batch_size == 512
    X = np.random.default_rng(6).normal(size=(64, 568)).astype(np.float32)
    np.testing.assert_allclose(clf.predict_proba(X), jclf.predict_proba(X), rtol=0, atol=1e-5)
    back = tmlp.MLPClassifier.load(path, device='cpu')
    assert back.learning_rate == clf.learning_rate and back.quantize == 'bf16'
    for p, q in zip(back.module.parameters(), clf.module.parameters()):
        assert torch.equal(p, q)


def test_params_to_msgpack_is_flax_to_bytes():
    from flax import serialization

    params = _jax_params(2, n_features=10, hidden=(4, 3))
    assert convert.params_to_msgpack(params) == serialization.to_bytes(params)
    back = convert.jax_params_from_mlp(convert.module_from_jax_params(params))
    assert convert.params_to_msgpack(back) == serialization.to_bytes(params)
