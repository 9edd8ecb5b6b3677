"""The port's VAEP rating dispatch against the JAX package's.

Both families (standard and atomic), on the CPU, with heads whose
parameters come from seeded numpy arrays: a JAX model is written with the
JAX package's ``save_model`` and read into the port with its
``load_model``, and both rate the same batch (3 games, padded to a bucket
of 4). Tolerances, stated per test:

- every path under the same forced ``SOCCERACTION_TPU_RATING_PATH``
  within 1e-5 of the JAX package's ``rate_batch``; ``fused_bf16`` within
  1e-2 of JAX's bf16 values and 0.05 of the port's f32 ones;
- mixed MLP/seq pairs and dense overrides on the materialized and mixed
  paths within 1e-5;
- ``compute_features_batch`` as ``tests/test_torch_features.py`` holds the
  features (rtol 1e-5, atol 1e-6), labels bitwise;
- both ``predict_proba_device_batch`` entries, ``fused_mlp_logits`` and
  ``fused_pair_logits`` within 1e-6;
- the ``path`` labels, the serving hooks, ``bucket_window`` and
  ``window_ladder`` equal;
- no host read (``aten::_local_scalar_dense``) in ``rate_batch`` on the
  fused, fused_bf16 and materialized paths.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from socceraction_tpu.atomic.vaep.base import AtomicVAEP as JaxAtomicVAEP
from socceraction_tpu.core import batch as jbatch
from socceraction_tpu.core.synthetic import synthetic_batch as jax_synthetic_batch
from socceraction_tpu.ml.mlp import MLPClassifier as JaxMLP
from socceraction_tpu.obs import metrics as jmetrics
from socceraction_tpu.ops import fused as jfused
from socceraction_tpu.seq import classifier as jclassifier
from socceraction_tpu.vaep.base import VAEP as JaxVAEP
from socceraction_tpu_torch.atomic.vaep.base import AtomicVAEP
from socceraction_tpu_torch.core import batch as tbatch
from socceraction_tpu_torch.core.synthetic import synthetic_batch
from socceraction_tpu_torch.ml.mlp import MLPClassifier
from socceraction_tpu_torch.obs import metrics as tmetrics
from socceraction_tpu_torch.ops import fused as tfused
from socceraction_tpu_torch.ops import profile as tprofile
from socceraction_tpu_torch.seq.classifier import SeqClassifier
from socceraction_tpu_torch.vaep.base import VAEP, load_model
from tests.test_torch_atomic import _abstract_atomic_batch, atomic_batches
from tests.test_torch_seq import SEQ, _jax_params

K = 3
ATOL = 1e-5
HIDDEN = (16, 8)
ENV = 'SOCCERACTION_TPU_RATING_PATH'


@pytest.fixture(scope='module', autouse=True)
def _drain_storm_windows():
    """Retire this module's compiles from the JAX compile observatory's
    storm window (as tests/test_torch_vaep.py does)."""
    yield
    from socceraction_tpu.seq import model as jseq

    for fn in (jfused._train_states_arrays, jseq._seq_pair_fn, jfused._pair_probs,
               jfused._pair_probs_prepared):
        fn.drain_storm_window()


FAMILIES = {
    'standard': (JaxVAEP, VAEP, tfused.STANDARD_REGISTRY),
    'atomic': (JaxAtomicVAEP, AtomicVAEP, tfused.ATOMIC_REGISTRY),
}


def _batches(family, seed=12):
    """(JAX batch, port batch on the CPU): 3 games of 256 actions."""
    if family == 'atomic':
        jb, tb = atomic_batches((256, 200, 180), seed=seed)
        return jb, tb
    args = dict(fill=0.8, seed=seed)
    return jax_synthetic_batch(3, 256, **args), synthetic_batch(3, 256, device='cpu', **args)


def _mlp_head(jcls, registry, seed):
    """A JAX MLP head of seeded numpy parameters, with the feature
    statistics of a seeded batch of the family."""
    jb, _ = _batches(registry.name, seed=40)
    names = jcls()._kernel_names()
    X = np.asarray(jcls._compute_features_kernel(jb, names=names, k=K))
    X = X.reshape(-1, X.shape[-1])[np.asarray(jb.mask).reshape(-1)]
    std = X.std(axis=0)
    rng = np.random.default_rng(seed)
    widths = (X.shape[1], *HIDDEN, 1)
    clf = JaxMLP(hidden=HIDDEN)
    clf.params = {'params': {
        f'Dense_{i}': {
            'kernel': jnp.asarray(rng.normal(0, widths[i] ** -0.5, (widths[i], widths[i + 1])),
                                  jnp.float32),
            'bias': jnp.asarray(rng.normal(0, 0.1, widths[i + 1]), jnp.float32),
        }
        for i in range(len(widths) - 1)
    }}
    clf.mean_ = X.mean(axis=0).astype(np.float32)
    clf.std_ = np.where(std > 0, std, 1.0).astype(np.float32)
    return clf


def _seq_head(jcls, registry, seed):
    jb, _ = _batches(registry.name, seed=40)
    names = jcls()._kernel_names()
    states, layout = jfused.build_train_states(jb, names=names, k=K, registry_name=registry.name)
    mean, raw_std = jfused.packed_feature_stats(states, layout)
    clf = jclassifier.SeqClassifier(**SEQ)
    n_dense = tfused.train_layout(names, K, registry).n_dense
    clf.params = jax.tree.map(jnp.asarray, _jax_params(registry, n_dense, seed=seed))
    clf.mean_ = np.array(mean)
    clf.std_ = np.where(np.asarray(raw_std) > 0, np.asarray(raw_std), 1.0).astype(np.float32)
    return clf


HEADS = {'mlp': (_mlp_head, _mlp_head), 'seq': (_seq_head, _seq_head), 'mixed': (_mlp_head, _seq_head)}


@pytest.fixture(scope='module', params=list(FAMILIES))
def family(request):
    return request.param


@pytest.fixture(scope='module')
def pairs(family, tmp_path_factory):
    """{kind: (JAX model, port model)} for MLP, seq and mixed head pairs."""
    jcls, _, registry = FAMILIES[family]
    out = {}
    for kind, (make_a, make_b) in HEADS.items():
        jmodel = jcls()
        jmodel._models['scores'] = make_a(jcls, registry, 1)
        jmodel._models['concedes'] = make_b(jcls, registry, 2)
        path = str(tmp_path_factory.mktemp(f'{family}-{kind}'))
        jmodel.save_model(path)
        out[kind] = (jmodel, load_model(path, device='cpu'))
    return out


def _close(got, want, mask, atol):
    got = got.numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    want = np.asarray(want)
    assert got.shape == want.shape
    gap = float(np.abs(got[mask] - want[mask]).max())
    assert gap <= atol, gap
    return gap


# -- the path matrix ----------------------------------------------------------------------------


@pytest.mark.parametrize('path', ['fused', 'materialized', 'fused_bf16'])
def test_rate_batch_paths_match_jax(pairs, family, path, monkeypatch):
    """Each forced path: the port against JAX's rate_batch under the same
    path (f32 within 1e-5; bf16 within 1e-2 of JAX's bf16, measured
    1.2e-7 in both families, and 0.05 of the port's f32, measured 1.8e-3
    standard and 3.3e-3 atomic), and the f32 paths against
    rate_batch_reference within 1e-5."""
    jmodel, model = pairs['mlp']
    jb, tb = _batches(family)
    mask = tb.mask.numpy()
    monkeypatch.setenv(ENV, path)
    want = jmodel.rate_batch(jb)
    got = model.rate_batch(tb)
    assert model._rating_path() == path
    if path == 'fused_bf16':
        _close(got, want, mask, 1e-2)
        monkeypatch.setenv(ENV, 'fused')
        _close(got, model.rate_batch(tb), mask, 0.05)
        return
    _close(got, want, mask, ATOL)
    _close(got, model.rate_batch_reference(tb), mask, ATOL)


def test_seq_heads_take_the_seq_path_whatever_is_forced(pairs, family, monkeypatch):
    jmodel, model = pairs['seq']
    jb, tb = _batches(family)
    for path in ('fused', 'materialized', 'fused_bf16'):
        monkeypatch.setenv(ENV, path)
        assert model._rating_path() == 'seq'
        _close(model.rate_batch(tb), jmodel.rate_batch(jb), tb.mask.numpy(), ATOL)


@pytest.mark.parametrize('overrides', [False, True], ids=['plain', 'goalscore'])
def test_mixed_pair_matches_jax(pairs, family, overrides):
    """An MLP scores head and a seq concedes head rate on the materialized
    path, with and without a goalscore override: rate_batch and the
    reference within 1e-5 of the JAX package's."""
    jmodel, model = pairs['mixed']
    assert isinstance(model._models['scores'], MLPClassifier)
    assert isinstance(model._models['concedes'], SeqClassifier)
    jb, tb = _batches(family)
    kw_j, kw_t = {}, {}
    if overrides:
        block = np.random.default_rng(2).integers(0, 3, size=(3, 256, 3)).astype(np.float32)
        kw_j = {'dense_overrides': {'goalscore': jnp.asarray(block)}}
        kw_t = {'dense_overrides': {'goalscore': torch.from_numpy(block)}}
    assert model._rating_path() == 'materialized'
    want = jmodel.rate_batch(jb, **kw_j)
    mask = tb.mask.numpy()
    _close(model.rate_batch(tb, **kw_t), want, mask, ATOL)
    _close(model.rate_batch_reference(tb, **kw_t), want, mask, ATOL)


def test_dense_overrides_on_the_materialized_path(pairs, family, monkeypatch):
    """A goalscore block on the forced materialized path, within 1e-5 of
    JAX's under the same path and of the port's fused path."""
    jmodel, model = pairs['mlp']
    jb, tb = _batches(family)
    block = np.random.default_rng(5).integers(0, 4, size=(3, 256, 3)).astype(np.float32)
    monkeypatch.setenv(ENV, 'materialized')
    want = jmodel.rate_batch(jb, dense_overrides={'goalscore': jnp.asarray(block)})
    got = model.rate_batch(tb, dense_overrides={'goalscore': torch.from_numpy(block)})
    mask = tb.mask.numpy()
    _close(got, want, mask, ATOL)
    monkeypatch.setenv(ENV, 'fused')
    _close(model.rate_batch(tb, dense_overrides={'goalscore': torch.from_numpy(block)}),
           want, mask, ATOL)


def _path_label(registry):
    """The ``path`` label of the one ``vaep/rated_actions`` series with
    samples."""
    labels = [
        dict(s.labels)['path']
        for s in registry.snapshot().get('vaep/rated_actions').series if s.count
    ]
    assert len(labels) == 1, labels
    return labels[0]


@pytest.mark.parametrize('env', ['auto', 'fused', 'materialized', 'fused_bf16'])
def test_path_labels_match_jax(pairs, family, env, monkeypatch):
    """The telemetry's path label equals the JAX package's, for every head
    kind under every forced path (an unmeasured 'cpu' entry in neither
    profile here, so 'auto' rates fused in both)."""
    jb, tb = _batches(family)
    monkeypatch.setenv(ENV, env)
    for kind, (jmodel, model) in pairs.items():
        jmetrics.REGISTRY.reset()
        tmetrics.REGISTRY.reset()
        jmodel.rate_batch(jb)
        model.rate_batch(tb)
        assert _path_label(tmetrics.REGISTRY) == _path_label(jmetrics.REGISTRY), (kind, env)


def test_invalid_path_raises(pairs, family, monkeypatch):
    _, model = pairs['mlp']
    _, tb = _batches(family)
    monkeypatch.setenv(ENV, 'pallas')
    with pytest.raises(ValueError, match=ENV):
        model.rate_batch(tb)


# -- the entries on packed data -----------------------------------------------------------------


def test_compute_features_and_labels_batch(pairs, family):
    jmodel, model = pairs['mlp']
    jb, tb = _batches(family)
    np.testing.assert_allclose(
        model.compute_features_batch(tb).numpy(), np.asarray(jmodel.compute_features_batch(jb)),
        rtol=1e-5, atol=1e-6,
    )
    for got, want in zip(model.compute_labels_batch(tb), jmodel.compute_labels_batch(jb)):
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_mlp_predict_proba_device_batch(pairs, family):
    """The fused entry within 1e-6 of JAX's and of the port's own
    predict_proba_device over the feature tensor."""
    jmodel, model = pairs['mlp']
    jb, tb = _batches(family)
    mask = tb.mask.numpy()
    names = model.xfns
    for col in ('scores', 'concedes'):
        got = model._models[col].predict_proba_device_batch(tb, names=names, k=K, registry=family)
        want = jmodel._models[col].predict_proba_device_batch(
            jb, names=names, k=K, registry=family
        )
        _close(got, want, mask, 1e-6)
        plain = model._models[col].predict_proba_device(model.compute_features_batch(tb))
        _close(got, plain, mask, 1e-6)


def test_seq_predict_proba_device_batch(pairs, family):
    jmodel, model = pairs['seq']
    jb, tb = _batches(family)
    for col in ('scores', 'concedes'):
        got = model._models[col].predict_proba_device_batch(tb, names=model.xfns, k=K,
                                                            registry=family)
        want = jmodel._models[col].predict_proba_device_batch(jb, names=model.xfns, k=K,
                                                             registry=family)
        assert got.shape == (3, 256)
        _close(got, want, tb.mask.numpy(), 1e-6)


def test_fused_logit_entries_match_jax(pairs, family):
    """fused_mlp_logits (plain and bf16 hidden chain, with a goalscore
    override) and fused_pair_logits within 1e-6 of the JAX package's;
    onehot_blocks equal."""
    jmodel, model = pairs['mlp']
    _, _, registry = FAMILIES[family]
    jreg = jfused.REGISTRIES[family]
    jb, tb = _batches(family)
    mask = tb.mask.numpy()
    names = model.xfns
    assert tfused.onehot_blocks(names, registry) == jfused.onehot_blocks(names, jreg)
    block = np.random.default_rng(8).integers(0, 3, size=(3, 256, 3)).astype(np.float32)
    ja, jb_ = (jmodel._models[c] for c in ('scores', 'concedes'))
    ta, tb_ = (model._models[c] for c in ('scores', 'concedes'))
    for over in (None, 'goalscore'):
        kw_j = {'dense_overrides': {over: jnp.asarray(block)}} if over else {}
        kw_t = {'dense_overrides': {over: torch.from_numpy(block)}} if over else {}
        for dt_j, dt_t, tol in ((None, None, 1e-6), (jnp.bfloat16, torch.bfloat16, 1e-2)):
            want = jfused.fused_mlp_logits(
                ja.params, jb, names=names, k=K, hidden_layers=len(HIDDEN), mean=ja.mean_,
                std=ja.std_, registry=jreg, hidden_dtype=dt_j, **kw_j,
            )
            got = tfused.fused_mlp_logits(
                ta.module, tb, names=names, k=K, mean=ta.mean_, std=ta.std_, registry=registry,
                hidden_dtype=dt_t, **kw_t,
            )
            _close(got, want, mask, tol)
        want = jfused.fused_pair_logits(
            ja.params, jb_.params, jb, names=names, k=K, hidden_layers_a=len(HIDDEN),
            hidden_layers_b=len(HIDDEN), mean_a=ja.mean_, std_a=ja.std_, mean_b=jb_.mean_,
            std_b=jb_.std_, registry=jreg, **kw_j,
        )
        got = tfused.fused_pair_logits(
            ta.module, tb_.module, tb, names=names, k=K, mean_a=ta.mean_, std_a=ta.std_,
            mean_b=tb_.mean_, std_b=tb_.std_, registry=registry, **kw_t,
        )
        for g, w in zip(got, want):
            _close(g, w, mask, 1e-6)


def test_fused_bf16_casts_where_jax_does(pairs, family):
    """pair_probs_prepared with hidden_dtype=bf16 against the same fold
    and the JAX package's hidden chain on the port's f32 first layer
    (1e-6: the same roundings)."""
    _, model = pairs['mlp']
    _, tb = _batches(family)
    ta, tb_ = (model._models[c] for c in ('scores', 'concedes'))
    got = tfused.pair_probs_prepared(
        model._prepared_pair(), ta, tb_, tb, names=model.xfns, k=K,
        registry=FAMILIES[family][2], hidden_dtype=torch.bfloat16,
    )
    for clf, g in zip((ta, tb_), got):
        logits = tfused.fused_mlp_logits(
            clf.module, tb, names=model.xfns, k=K, mean=clf.mean_, std=clf.std_,
            registry=FAMILIES[family][2], hidden_dtype=torch.bfloat16,
        )
        _close(g, torch.sigmoid(logits), tb.mask.numpy(), 1e-6)


# -- serving hooks -------------------------------------------------------------------------------


def test_serving_hooks(pairs, family):
    """time_rungs, warm_serving, serving_arrays and _bucketable as the JAX
    package's rules give them."""
    for kind, (jmodel, model) in pairs.items():
        assert model.time_rungs == jmodel.time_rungs == (kind == 'seq'), kind
        assert model._can_fuse() == jmodel._can_fuse()
        assert model._can_seq() == jmodel._can_seq()
    _, seq = pairs['seq']
    assert seq.warm_serving() is None and seq.serving_arrays() == []
    assert seq.serving_table_bytes() is None
    _, mlp = pairs['mlp']
    mlp._pair_prep = None
    assert mlp.serving_table_bytes() is None
    prep = mlp.warm_serving()
    assert prep is mlp._prepared_pair()
    arrays = mlp.serving_arrays()
    assert arrays[0] is prep.tables.data and arrays[-1] is prep.bias
    assert mlp.serving_table_bytes() == prep.tables.data.numel() * 4
    _, tb = _batches(family)
    assert VAEP._bucketable(tb)


@pytest.mark.parametrize('mode', ['none', 'bf16', 'int8'])
def test_serving_table_bytes_match_jax(pairs, family, mode, monkeypatch, tmp_path):
    """Where the JAX package builds a fold (a narrow mode, or the Pallas
    kernel in f32), the port's serving_table_bytes equals its. The JAX
    package cannot build an atomic fold (ROADMAP §C), so there the bytes
    are reckoned from the table shapes (k, combo rows, H_a + H_b) and
    checked also against a JAX fold built on an abstract atomic batch."""
    jmodel, model = pairs['mlp']
    if mode == 'none':
        monkeypatch.setenv('SOCCERACTION_TPU_FUSED_KERNEL', 'pallas')
    model.set_quantize(mode)
    jmodel.set_quantize(mode)
    try:
        model.warm_serving()
        got = model.serving_table_bytes()
        h = 2 * HIDDEN[0]
        r = FAMILIES[family][2].combo_size
        # per row: H f32 or bf16 values; int8 codes, their packed 2-bit
        # refinements and one f32 scale
        row = {'none': 4 * h, 'bf16': 2 * h, 'int8': h + -(-h // 4) + 4}[mode]
        assert got == K * r * row
        if family == 'atomic':
            monkeypatch.setattr(jfused, '_abstract_batch', _abstract_atomic_batch)
        jmodel.warm_serving()
        assert got == jmodel.serving_table_bytes()
    finally:
        model.set_quantize('none')
        jmodel.set_quantize('none')


N_SWEEP = list(range(0, 300)) + [383, 384, 385, 511, 512, 513, 1023, 1024, 1025, 1663, 1664,
                                  1665, 2047, 2048, 2049, 4095, 4096]


@pytest.mark.parametrize('max_actions', [1, 127, 128, 1664, 4096])
def test_bucket_window_and_window_ladder(max_actions):
    for n in N_SWEEP + list(range(300, 4097, 97)):
        assert tbatch.bucket_window(n, max_actions) == jbatch.bucket_window(n, max_actions), n
    assert tbatch.window_ladder(max_actions) == jbatch.window_ladder(max_actions)
    for bad in ((-1, max_actions), (3, 0)):
        with pytest.raises(ValueError):
            tbatch.bucket_window(*bad)


# -- host reads ---------------------------------------------------------------------------------


def _reads(fn):
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU]) as prof:
        fn()
    counts = {'aten::_local_scalar_dense': 0, 'cudaStreamSynchronize': 0}
    for e in prof.key_averages():
        if e.key in counts:
            counts[e.key] += e.count
    return counts


@pytest.mark.parametrize('path', ['fused', 'fused_bf16', 'materialized'])
def test_rate_batch_reads_nothing_back(pairs, family, path, monkeypatch):
    """No host read and no stream sync in one rate_batch on each MLP path
    (3 games bucketed to 4, a goalscore override); a mixed pair reads no
    more than a seq pair."""
    _, model = pairs['mlp']
    _, tb = _batches(family)
    block = {'goalscore': torch.zeros((3, 256, 3))}
    monkeypatch.setenv(ENV, path)
    model.rate_batch(tb)  # first call: the fold, the profile's parse
    assert _reads(lambda: model.rate_batch(tb, dense_overrides=block)) == {
        'aten::_local_scalar_dense': 0, 'cudaStreamSynchronize': 0,
    }
    seq = _reads(lambda: pairs['seq'][1].rate_batch(tb, dense_overrides=block))
    mixed = _reads(lambda: pairs['mixed'][1].rate_batch(tb, dense_overrides=block))
    assert mixed['aten::_local_scalar_dense'] <= seq['aten::_local_scalar_dense']


def test_profile_read_once_per_process(pairs, family, monkeypatch):
    """rate_batch asks the profile on every call but opens the file once."""
    _, model = pairs['mlp']
    _, tb = _batches(family)
    monkeypatch.delenv(ENV, raising=False)
    model.rate_batch(tb)
    opened = []
    real_open = open

    def spy(path, *a, **kw):
        opened.append(path)
        return real_open(path, *a, **kw)

    monkeypatch.setattr('builtins.open', spy)
    model.rate_batch(tb)
    assert tprofile._PROFILE_FILE not in opened


def test_mixed_pair_checkpoint_moves_to_jax(pairs, family, tmp_path):
    """The port's save_model of a mixed pair stamps each head's kind and
    format 3; the JAX package's load_model reads it and rates within 1e-5."""
    import json

    from socceraction_tpu.vaep.base import load_model as jax_load_model

    _, model = pairs['mixed']
    model.save_model(str(tmp_path))
    with open(tmp_path / 'meta.json') as f:
        meta = json.load(f)
    assert meta['heads'] == {'scores': 'mlp', 'concedes': 'seq'} and meta['format_version'] == 3
    jb, tb = _batches(family)
    back = jax_load_model(str(tmp_path))
    _close(model.rate_batch(tb), back.rate_batch(jb), tb.mask.numpy(), ATOL)
