"""The port's GRU sequence head against the JAX package's.

Seeded numpy inputs go through both packages on the CPU, at small widths
(embedding 8, GRU 16, readout 16): standard batches from
``synthetic_batch`` (bitwise equal in both packages) and atomic ones from
the private draw of ``tests/test_torch_atomic.py``. JAX parameters are
carried into the port through ``convert``; for training, JAX's init and
its permutation are injected. Each test states its tolerance. The card's
side is in ``tests/test_torch_train_card.py``.
"""

import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from socceraction_tpu.atomic.vaep.base import AtomicVAEP as JaxAtomicVAEP
from socceraction_tpu.core.synthetic import synthetic_batch as jax_synthetic_batch
from socceraction_tpu.ml import mlp as jmlp
from socceraction_tpu.ops import fused as jfused
from socceraction_tpu.ops import labels as jlabels
from socceraction_tpu.seq import classifier as jclassifier
from socceraction_tpu.seq import model as jseq
from socceraction_tpu.vaep.base import VAEP as JaxVAEP
from socceraction_tpu.vaep.base import load_model as jax_load_model
from socceraction_tpu_torch import convert
from socceraction_tpu_torch.atomic.vaep.base import AtomicVAEP
from socceraction_tpu_torch.core.synthetic import synthetic_batch
from socceraction_tpu_torch.ml import mlp as tmlp
from socceraction_tpu_torch.ops import fused as tfused
from socceraction_tpu_torch.seq import classifier as tclassifier
from socceraction_tpu_torch.seq import model as tseq
from socceraction_tpu_torch.vaep.base import VAEP, XFNS_DEFAULT, load_model
from tests.test_torch_atomic import atomic_batches

K = 3
SEQ = dict(embed_dim=8, hidden=16, readout=16)
ATOL = 1e-5


@pytest.fixture(scope='module', autouse=True)
def _drain_storm_windows():
    """Retire this module's compiles from the JAX compile observatory's
    storm window (as tests/test_torch_vaep.py does)."""
    yield
    from socceraction_tpu.ops.fused import _pair_probs, _pair_probs_prepared

    for fn in (jfused._train_states_arrays, jseq._seq_pair_fn, _pair_probs, _pair_probs_prepared):
        fn.drain_storm_window()


FAMILIES = {
    'standard': (XFNS_DEFAULT, tfused.STANDARD_REGISTRY),
    'atomic': (AtomicVAEP._default_xfns, tfused.ATOMIC_REGISTRY),
}


def _batches(family, seed=3):
    if family == 'atomic':
        return atomic_batches(seed=seed)
    args = dict(fill=0.8, seed=seed)
    return jax_synthetic_batch(4, 256, **args), synthetic_batch(4, 256, device='cpu', **args)


@pytest.fixture(scope='module', params=list(FAMILIES))
def family(request):
    """(family, names, registry, (JAX states, layout), (port states, layout), JAX batch, port batch)."""
    name = request.param
    names, registry = FAMILIES[name]
    jb, tb = _batches(name)
    return (
        name, names, registry,
        jfused.build_train_states(jb, names=names, k=K, registry_name=name),
        tfused.build_train_states(tb, names=names, k=K, registry=registry),
        jb, tb,
    )


def _jax_params(registry, n_dense, seed=0, bias_scale=0.3):
    """A JAX init of the seq head, as numpy, with nonzero biases (the init
    leaves them zero, which would hide a misplaced bias)."""
    params = jax.tree.map(np.asarray, jseq.init_seq_params(
        seed, combo_size=registry.combo_size, n_dense=n_dense, **SEQ
    ))
    rng = np.random.default_rng(seed + 1)
    for group in ('gru', 'readout'):
        for name, a in params[group].items():
            if name.startswith('b'):
                params[group][name] = rng.normal(0, bias_scale, size=a.shape).astype(np.float32)
    return params


def _stats(jstates, jlayout):
    mean, raw_std = jfused.packed_feature_stats(jstates, jlayout)
    std = np.where(np.asarray(raw_std) > 0, np.asarray(raw_std), 1.0).astype(np.float32)
    return np.array(mean), std


def _max_rel(got, want):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return float(np.abs(got - want).max() / max(np.abs(want).max(), 1e-30))


# -- the pieces -------------------------------------------------------------------------------


def test_param_shapes_match_jax():
    dims = dict(combo_size=128, n_dense=46, **SEQ)
    want = jax.tree.map(lambda s: tuple(s.shape), jseq.seq_param_shapes(**dims))
    assert tseq.seq_param_shapes(**dims) == want
    module = tseq.SeqModule(**dims)
    assert module.dims() == dims
    tree = convert.jax_params_from_seq_module(module)
    assert jax.tree.structure(tree) == jax.tree.structure(jseq.seq_param_shapes(**dims))


def test_init_draws_the_jax_distribution():
    """Rank-2 parameters are unit normals over sqrt(fan_in), biases zero,
    ``w2`` a draw of its own; one seed gives one init."""
    m = tseq.init_seq_params(3, combo_size=552, n_dense=55, embed_dim=32, hidden=64,
                             readout=64, device='cpu')
    again = tseq.init_seq_params(3, combo_size=552, n_dense=55, embed_dim=32, hidden=64,
                                 readout=64, device='cpu')
    for (name, p), q in zip(m.named_parameters(), again.parameters()):
        p = p.detach()
        assert torch.equal(p, q), name
        if p.dim() >= 2:
            assert abs(float(p.std()) * p.shape[0] ** 0.5 - 1.0) < 0.05, name
            assert abs(float(p.mean())) < 0.05 * p.shape[0] ** -0.5 * 10, name
        elif name != 'readout.w2':
            assert not p.any(), name
    w2 = m.readout.w2.detach()
    assert abs(float(w2.std()) * 8.0 - 1.0) < 0.3 and w2.any()
    other = tseq.init_seq_params(4, combo_size=552, n_dense=55, embed_dim=32, hidden=64,
                                 readout=64, device='cpu')
    assert not torch.equal(other.embed, m.embed)


def test_gru_pass_matches_jax(family):
    """The unrolled GRU on (N, k, E) tokens, within 1e-6."""
    _, _, registry, _, (_, tlayout), _, _ = family
    params = _jax_params(registry, tlayout.n_dense)
    emb = np.random.default_rng(2).normal(size=(500, K, SEQ['embed_dim'])).astype(np.float32)
    want = np.asarray(jseq._gru_pass(jax.tree.map(jnp.asarray, params), jnp.asarray(emb)))
    module = convert.seq_module_from_jax_params(params)
    got = tseq._gru_pass(module, torch.from_numpy(emb)).detach().numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-6)
    # the last token read is the current action's: reversing the window changes h
    flipped = tseq._gru_pass(module, torch.from_numpy(emb[:, ::-1].copy())).detach().numpy()
    assert np.abs(flipped - want).max() > 1e-3


def test_seq_logits_and_train_logits_match_jax(family):
    _, _, registry, (jstates, jlayout), (tstates, tlayout), _, _ = family
    params = _jax_params(registry, tlayout.n_dense)
    mean, std = _stats(jstates, jlayout)
    jp = jax.tree.map(jnp.asarray, params)
    want = np.asarray(jseq.seq_train_logits(
        jp, jstates.x_dense, jstates.combo_ids, layout=jlayout,
        mean=jnp.asarray(mean), std=jnp.asarray(std),
    ))
    module = convert.seq_module_from_jax_params(params)
    got = tseq.seq_train_logits(
        module, tstates.x_dense, tstates.combo_ids, layout=tlayout,
        mean=torch.from_numpy(mean), std=torch.from_numpy(std),
    ).detach().numpy()
    assert got.shape == want.shape == (tstates.weight.shape[0],)
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-6)
    dm, ds = jseq.dense_stats(jnp.asarray(mean), jnp.asarray(std), jlayout)
    tdm, tds = tseq.dense_stats(torch.from_numpy(mean), torch.from_numpy(std), tlayout)
    np.testing.assert_array_equal(tdm.numpy(), np.asarray(dm))
    np.testing.assert_array_equal(tds.numpy(), np.asarray(ds))
    plain = tseq.seq_logits(module, tstates.x_dense, tstates.combo_ids, dense_mean=tdm,
                            dense_std=tds).detach().numpy()
    np.testing.assert_array_equal(plain, got)


def test_train_logits_check_the_layout(family):
    _, _, registry, _, (tstates, tlayout), _, _ = family
    other = tfused.ATOMIC_REGISTRY if registry is tfused.STANDARD_REGISTRY else tfused.STANDARD_REGISTRY
    wrong = tseq.SeqModule(combo_size=other.combo_size, n_dense=tlayout.n_dense, **SEQ)
    mean = torch.zeros(tlayout.n_features)
    with pytest.raises(ValueError, match='embedding table has'):
        tseq.seq_train_logits(wrong, tstates.x_dense, tstates.combo_ids, layout=tlayout,
                              mean=mean, std=mean + 1)
    wrong = tseq.SeqModule(combo_size=registry.combo_size, n_dense=tlayout.n_dense + 1, **SEQ)
    with pytest.raises(ValueError, match='readout expects'):
        tseq.seq_train_logits(wrong, tstates.x_dense, tstates.combo_ids, layout=tlayout,
                              mean=mean, std=mean + 1)


def test_loss_and_gradient_match_jax_value_and_grad(family):
    """One minibatch's loss within 1e-6 and every gradient within 1e-5 of
    ``jax.value_and_grad`` (relative to the gradient's largest entry),
    the embedding's through ``table_lookup``'s row segment sum."""
    name, _, registry, (jstates, jlayout), (tstates, tlayout), jb, _ = family
    params = _jax_params(registry, tlayout.n_dense, seed=5)
    mean, std = _stats(jstates, jlayout)
    if name == 'atomic':
        from socceraction_tpu.ops import atomic as jatomic

        y = np.asarray(jatomic.scores_concedes(jb)[0]).reshape(-1).astype(np.float32)
    else:
        y = np.asarray(jlabels.scores_concedes(jb)[0]).reshape(-1).astype(np.float32)
    rows = np.random.default_rng(6).permutation(y.shape[0])[:512]
    w = np.ones(512, np.float32)

    def jloss(p):
        logits = jseq.seq_train_logits(
            p, jstates.x_dense[rows], jstates.combo_ids[rows], layout=jlayout,
            mean=jnp.asarray(mean), std=jnp.asarray(std),
        )
        return jmlp._weighted_bce(logits, y[rows], w * np.asarray(jstates.weight)[rows], 2.0)

    jl, jg = jax.value_and_grad(jloss)(jax.tree.map(jnp.asarray, params))
    module = convert.seq_module_from_jax_params(params).requires_grad_(True)
    r = torch.from_numpy(rows)
    logits = tseq.seq_train_logits(
        module, tstates.x_dense[r], tstates.combo_ids[r], layout=tlayout,
        mean=torch.from_numpy(mean), std=torch.from_numpy(std),
    )
    tl = tmlp._weighted_bce(logits, torch.from_numpy(y[rows]), torch.from_numpy(w) * tstates.weight[r], 2.0)
    tl.backward()
    assert abs(tl.item() - float(jl)) <= 1e-6
    for pname, p in module.named_parameters():
        group, leaf = (pname.split('.') + [None])[:2]
        want = jg[group] if leaf is None else jg[group][leaf]
        assert _max_rel(p.grad.numpy(), want) <= 1e-5, pname


@pytest.mark.parametrize('overrides', [False, True], ids=['plain', 'goalscore-override'])
def test_seq_pair_probs_match_jax(family, overrides):
    """Both heads over one packing, within 1e-6, with and without a dense
    override."""
    name, names, registry, (jstates, jlayout), (_, tlayout), jb, tb = family
    mean, std = _stats(jstates, jlayout)
    jheads, theads = [], []
    for seed in (0, 9):
        params = _jax_params(registry, tlayout.n_dense, seed=seed)
        jclf = jclassifier.SeqClassifier(**SEQ)
        jclf.params = jax.tree.map(jnp.asarray, params)
        jclf.mean_, jclf.std_ = mean, std
        jheads.append(jclf)
        tclf = tclassifier.SeqClassifier(**SEQ, device='cpu')
        tclf.module = convert.seq_module_from_jax_params(params)
        tclf.mean_, tclf.std_ = torch.from_numpy(mean), torch.from_numpy(std)
        theads.append(tclf)
    block = None
    if overrides:
        block = np.random.default_rng(1).integers(0, 3, size=(*tb.mask.shape, 3)).astype(np.float32)
    want = jseq.seq_pair_probs(
        *jheads, jb, names=names, k=K, registry_name=name,
        dense_overrides=None if block is None else {'goalscore': jnp.asarray(block)},
    )
    got = tseq.seq_pair_probs(
        *theads, tb, names=names, k=K, registry=registry,
        dense_overrides=None if block is None else {'goalscore': torch.from_numpy(block)},
    )
    for g, w in zip(got, want):
        assert g.shape == tb.mask.shape
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=0, atol=1e-6)


# -- training ---------------------------------------------------------------------------------------


def _jax_permutation(self, epoch):
    key = jax.random.fold_in(jax.random.PRNGKey(self.seed), epoch)
    return torch.from_numpy(np.asarray(jax.random.permutation(key, self.n)).astype(np.int64))


@pytest.mark.parametrize('batch_size, epochs', [(4096, 4), (256, 3)], ids=['full-batch', 'minibatch'])
def test_fit_packed_matches_jax(family, monkeypatch, batch_size, epochs):
    """``SeqClassifier.fit_packed`` from JAX's init, JAX's permutation
    injected (minibatches of 256 over 1024 rows, or one step per epoch)
    at lr 3e-4: every parameter within 1e-4 after the fit, the JAX
    package's training-parity bound."""
    name, names, registry, _, (_, tlayout), jb, tb = family
    if name == 'atomic':
        from socceraction_tpu.ops import atomic as jatomic

        y = np.asarray(jatomic.scores_concedes(jb)[0]).reshape(-1).astype(np.float32)
    else:
        y = np.asarray(jlabels.scores_concedes(jb)[0]).reshape(-1).astype(np.float32)
    monkeypatch.setattr(tmlp._EpochTrainer, '_permutation', _jax_permutation)
    hyper = dict(**SEQ, seed=0, batch_size=batch_size, max_epochs=epochs, learning_rate=3e-4)
    jclf = jclassifier.SeqClassifier(**hyper)
    jclf.fit_packed(jb, y, names=names, k=K, registry=name)
    init = jax.tree.map(np.asarray, jclassifier.SeqClassifier(**hyper)._init_params(
        jfused.build_train_states(jb, names=names, k=K, registry_name=name)[1]
    ))
    tclf = tclassifier.SeqClassifier(**hyper, device='cpu')
    tclf.fit_packed(tb, y, names=names, k=K, registry=name,
                    init_params=convert.seq_module_from_jax_params(init))
    np.testing.assert_allclose(tclf.mean_.numpy(), jclf.mean_, rtol=1e-6, atol=1e-6)
    got = convert.jax_params_from_seq_module(tclf.module)
    gap = max(
        float(np.abs(a - np.asarray(b)).max())
        for a, b in zip(jax.tree.leaves(got), jax.tree.leaves(jclf.params))
    )
    assert gap <= 1e-4, gap
    steps = -(-tb.mask.numel() // min(batch_size, tb.mask.numel()))
    assert tclf.opt_state_.count == epochs * steps
    health = tclf.train_health_
    assert health['finite'] and health['path'] == 'seq' and health['epochs'] == epochs


@pytest.fixture(scope='module')
def fitted():
    """(JAX VAEP, the port's VAEP) fit with learner='seq' on the same batches."""
    tree = dict(**SEQ, batch_size=512, max_epochs=3)
    jmodel = JaxVAEP().fit_packed(
        jax_synthetic_batch(6, 256, fill=0.8, seed=3), learner='seq', tree_params=tree,
        random_state=0,
    )
    model = VAEP(device='cpu').fit_packed(
        synthetic_batch(6, 256, fill=0.8, seed=3, device='cpu'), learner='seq',
        tree_params=tree, random_state=0,
    )
    return jmodel, model


def test_vaep_fit_packed_seq_end_to_end(fitted):
    """Split statistics as the JAX package's; healthy seq heads; the fitted
    model's rate_batch within 1e-5 of its reference."""
    jmodel, model = fitted
    for col in ('scores', 'concedes'):
        jclf, clf = jmodel._models[col], model._models[col]
        assert isinstance(clf, tclassifier.SeqClassifier)
        jmean, jstd = np.asarray(jclf.mean_, np.float64), np.asarray(jclf.std_, np.float64)
        mean, std = clf.mean_.numpy().astype(np.float64), clf.std_.numpy().astype(np.float64)
        np.testing.assert_allclose(std, jstd, rtol=1e-6, atol=0)
        assert (np.abs(mean - jmean) <= 1e-6 * np.maximum(np.abs(jmean), jstd)).all()
        health = clf.train_health_
        assert health['finite'] and health['epochs'] == 3 and health['path'] == 'seq'
        assert len(health['val_losses']) == 3
    tb = synthetic_batch(3, 256, fill=0.8, seed=5, device='cpu')
    values = model.rate_batch(tb)
    assert values.shape == (3, 256, 3) and torch.isfinite(values[tb.mask]).all()
    np.testing.assert_allclose(
        values[tb.mask].numpy(), model.rate_batch_reference(tb)[tb.mask].numpy(), rtol=0, atol=ATOL
    )
    assert model.quantize == 'none'


def test_seq_checkpoint_moves_both_ways(fitted, tmp_path):
    """The port's save_model stamps format 3 with 'seq' heads; the JAX
    package's load_model reads it and rates within 1e-5; a JAX checkpoint
    loads in the port and rates within 1e-5 of JAX."""
    jmodel, model = fitted
    model.save_model(str(tmp_path / 'port'))
    with open(tmp_path / 'port' / 'meta.json') as f:
        meta = json.load(f)
    assert meta['format_version'] == 3 and meta['class'] == 'VAEP'
    assert meta['heads'] == {'scores': 'seq', 'concedes': 'seq'}
    jb = jax_synthetic_batch(3, 256, fill=0.8, seed=8)
    tb = synthetic_batch(3, 256, fill=0.8, seed=8, device='cpu')
    mask = tb.mask.numpy()
    back_j = jax_load_model(str(tmp_path / 'port'))
    np.testing.assert_allclose(
        model.rate_batch(tb).numpy()[mask], np.asarray(back_j.rate_batch(jb))[mask], rtol=0, atol=ATOL
    )
    back = load_model(str(tmp_path / 'port'), device='cpu')
    assert torch.equal(back.rate_batch(tb), model.rate_batch(tb))
    jmodel.save_model(str(tmp_path / 'jax'))
    from_jax = load_model(str(tmp_path / 'jax'), device='cpu')
    assert all(isinstance(m, tclassifier.SeqClassifier) for m in from_jax._models.values())
    np.testing.assert_allclose(
        from_jax.rate_batch(tb).numpy()[mask], np.asarray(jmodel.rate_batch(jb))[mask], rtol=0, atol=ATOL
    )
    # the heads' bytes are the JAX package's own
    for col in ('scores', 'concedes'):
        with np.load(tmp_path / 'jax' / 'models' / f'{col}.npz') as data:
            want = data['seq_params_msgpack'].tobytes()
        assert convert.params_to_msgpack(
            convert.jax_params_from_seq_module(from_jax._models[col].module)
        ) == want


def test_corrupt_seq_artifacts_raise(fitted, tmp_path):
    _, model = fitted
    model.save_model(str(tmp_path))
    head = str(tmp_path / 'models' / 'scores.npz')
    with open(head, 'rb') as f:
        data = bytearray(f.read())
    truncated = str(tmp_path / 'truncated.npz')
    with open(truncated, 'wb') as f:
        f.write(bytes(data[: len(data) // 2]))
    with pytest.raises(ValueError, match='checkpoint artifact corrupt'):
        tclassifier.SeqClassifier.load(truncated, device='cpu')
    mlp_head = str(tmp_path / 'mlp.npz')
    clf = tmlp.MLPClassifier(hidden=(4,), device='cpu')
    clf.module = tmlp.MLP(3, (4,))
    clf.mean_, clf.std_ = torch.zeros(3), torch.ones(3)
    clf.save(mlp_head)
    with pytest.raises(ValueError, match='failed to parse as a seq checkpoint'):
        tclassifier.SeqClassifier.load(mlp_head, device='cpu')
    data[len(data) // 2] ^= 0xFF
    with open(head, 'wb') as f:
        f.write(bytes(data))
    with pytest.raises(ValueError, match='corrupt'):
        load_model(str(tmp_path), device='cpu')
    future = str(tmp_path / 'future.npz')
    model._models['concedes'].save(future)
    with np.load(future) as d:
        arrays = {k: d[k] for k in d.files}
    arrays['format_version'] = np.array(tclassifier.SEQ_FORMAT_VERSION + 1)
    with open(future, 'wb') as f:
        np.savez(f, **arrays)
    with pytest.raises(ValueError, match='format_version'):
        tclassifier.SeqClassifier.load(future, device='cpu')


def test_seq_heads_refuse_quantized_serving_and_mixed_pairs(fitted):
    _, model = fitted
    with pytest.raises(ValueError, match='needs MLP heads'):
        model.set_quantize('int8')
    assert model.set_quantize('none').quantize == 'none'
    mlp = tmlp.MLPClassifier(hidden=(4,), device='cpu')
    mlp.module = tmlp.MLP(568, (4,))
    mlp.mean_, mlp.std_ = torch.zeros(568), torch.ones(568)
    with pytest.raises(ValueError, match='mixed MLP/seq pairs'):
        VAEP(models={'scores': mlp, 'concedes': model._models['concedes']}, device='cpu')


def test_warm_start_seq_from_seq_copies_the_heads(fitted):
    """With no epochs to run, a seq warm start keeps the seed heads'
    weights and statistics bitwise, copied; the seed is not changed."""
    _, model = fitted
    before = [p.clone() for p in model._models['scores'].module.parameters()]
    warm = VAEP(device='cpu').fit_packed(
        synthetic_batch(2, 256, seed=21, device='cpu'), learner='seq',
        tree_params={'max_epochs': 0}, random_state=1, warm_start=model,
    )
    for col in ('scores', 'concedes'):
        old, new = model._models[col], warm._models[col]
        assert torch.equal(new.mean_, old.mean_) and torch.equal(new.std_, old.std_)
        assert new._hyperparameters() == old._hyperparameters() | {'max_epochs': 0}
        for p, q in zip(new.module.parameters(), old.module.parameters()):
            assert torch.equal(p, q) and p is not q
    for p, q in zip(before, model._models['scores'].module.parameters()):
        assert torch.equal(p, q)


def test_warm_start_mlp_into_seq_copies_no_weights(fitted):
    """An MLP model seeding learner='seq' is a cold fit: the heads start
    from the seed's fresh init and the statistics are recomputed."""
    batch = synthetic_batch(2, 256, seed=21, device='cpu')
    mlp_model = VAEP(device='cpu').fit_packed(
        batch, tree_params={'hidden': (8,), 'max_epochs': 1}, random_state=1
    )
    tree = dict(**SEQ, max_epochs=0)
    warm = VAEP(device='cpu').fit_packed(
        batch, learner='seq', tree_params=tree, random_state=1, warm_start=mlp_model
    )
    cold = VAEP(device='cpu').fit_packed(batch, learner='seq', tree_params=tree, random_state=1)
    for col in ('scores', 'concedes'):
        w, c = warm._models[col], cold._models[col]
        assert isinstance(w, tclassifier.SeqClassifier)
        assert torch.equal(w.mean_, c.mean_) and torch.equal(w.std_, c.std_)
        for p, q in zip(w.module.parameters(), c.module.parameters()):
            assert torch.equal(p, q)
    # and the reverse: a seq model seeding an MLP fit copies nothing either
    back = VAEP(device='cpu').fit_packed(
        batch, tree_params={'hidden': (8,), 'max_epochs': 0}, random_state=1, warm_start=warm
    )
    assert all(isinstance(m, tmlp.MLPClassifier) for m in back._models.values())


def _seq_batches(family, seed):
    """Three games of a family (bucketed to four), ragged."""
    if family == 'atomic':
        return atomic_batches((256, 200, 90), seed=seed)
    args = dict(fill=0.7, seed=seed)
    return jax_synthetic_batch(3, 256, **args), synthetic_batch(3, 256, device='cpu', **args)


@pytest.mark.parametrize('overrides', [False, True], ids=['plain', 'goalscore-override'])
def test_seq_rate_batch_matches_jax_padded(family, tmp_path, overrides):
    """``VAEP.rate_batch`` and ``rate_batch_reference`` with seq heads on 3
    games padded to a bucket of 4, with and without a goalscore override:
    within 1e-6 of the JAX package's rate_batch (measured about 3.3e-7)."""
    name, names, registry, (jstates, jlayout), (_, tlayout), _, _ = family
    mean, std = _stats(jstates, jlayout)
    jmodel = (JaxAtomicVAEP if name == 'atomic' else JaxVAEP)()
    for seed, col in ((0, 'scores'), (9, 'concedes')):
        jclf = jclassifier.SeqClassifier(**SEQ)
        jclf.params = jax.tree.map(jnp.asarray, _jax_params(registry, tlayout.n_dense, seed=seed))
        jclf.mean_, jclf.std_ = mean, std
        jmodel._models[col] = jclf
    jmodel.save_model(str(tmp_path))
    model = load_model(str(tmp_path), device='cpu')
    jb, tb = _seq_batches(name, seed=12)
    kw_j, kw_t = {}, {}
    if overrides:
        block = np.random.default_rng(2).integers(0, 3, size=(3, 256, 3)).astype(np.float32)
        kw_j = {'dense_overrides': {'goalscore': jnp.asarray(block)}}
        kw_t = {'dense_overrides': {'goalscore': torch.from_numpy(block)}}
    want = np.asarray(jmodel.rate_batch(jb, **kw_j))
    mask = tb.mask.numpy()
    for got in (model.rate_batch(tb, **kw_t), model.rate_batch_reference(tb, **kw_t)):
        assert got.shape == want.shape == (3, 256, 3)
        np.testing.assert_allclose(got.numpy()[mask], want[mask], rtol=0, atol=1e-6)


def test_atomic_vaep_with_seq_heads_matches_jax(tmp_path):
    """Atomic-VAEP trained with learner='seq': its rate_batch within 1e-5
    of its reference, and of the JAX package's after the checkpoint moves."""
    jb, tb = atomic_batches((256, 200, 256, 90), seed=3)
    model = AtomicVAEP(device='cpu').fit_packed(
        tb, learner='seq', tree_params=dict(**SEQ, batch_size=256, max_epochs=2), random_state=0
    )
    assert all(isinstance(m, tclassifier.SeqClassifier) for m in model._models.values())
    _, rb = atomic_batches(seed=6)
    mask = rb.mask.numpy()
    values = model.rate_batch(rb)
    np.testing.assert_allclose(
        values.numpy()[mask], model.rate_batch_reference(rb).numpy()[mask], rtol=0, atol=ATOL
    )
    model.save_model(str(tmp_path))
    jmodel = jax_load_model(str(tmp_path))
    assert type(jmodel) is JaxAtomicVAEP
    jrb, _ = atomic_batches(seed=6)
    np.testing.assert_allclose(
        values.numpy()[mask], np.asarray(jmodel.rate_batch(jrb))[mask], rtol=0, atol=ATOL
    )
    assert os.path.isfile(tmp_path / 'models' / 'scores.npz')
