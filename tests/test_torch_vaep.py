"""The port's VAEP serving slice, end to end, against the JAX package.

A JAX ``VAEP`` gets two MLP heads whose parameters come from seeded numpy
arrays (no fit, so the test stays fast), is written with the JAX
package's ``save_model`` and loaded into the port with its ``load_model``
(the flax-msgpack reader, the checksum and the format gates). Both
packages then rate the same batch:

- f32 values agree within 1e-5 with JAX's ``rate_batch`` on its default
  (xla) lowering and under ``SOCCERACTION_TPU_FUSED_KERNEL=pallas``, and
  with the port's materialized ``rate_batch_reference``;
- the port's folded f32 tables equal JAX's ``prepare_pair_fold`` bitwise;
- bf16 and int8 storage then holds the same bytes, so those values agree
  with JAX's output in the same mode within 1e-5 too.
"""

import json
import os

import jax.numpy as jnp
import numpy as np
import pandas as pd
import pytest
import torch

from socceraction_tpu.core.synthetic import synthetic_batch as jax_synthetic_batch
from socceraction_tpu.ml.mlp import MLPClassifier as JaxMLP
from socceraction_tpu.ops import features as jfeat
from socceraction_tpu.ops import fused as jfused
from socceraction_tpu.vaep.base import VAEP as JaxVAEP
from socceraction_tpu_torch import convert
from socceraction_tpu_torch.core.synthetic import synthetic_batch
from socceraction_tpu_torch.ml.mlp import MLPClassifier
from socceraction_tpu_torch.vaep.base import VAEP, NotFittedError, load_model

ATOL = 1e-5


@pytest.fixture(scope='module', autouse=True)
def _drain_pair_probs_storm_window():
    """Retire this module's serving compiles from the JAX compile
    observatory's storm window (as tests/test_quant.py does)."""
    yield
    from socceraction_tpu.ops.fused import _pair_probs, _pair_probs_prepared

    for fn in (_pair_probs, _pair_probs_prepared):
        fn.drain_storm_window()


def _feature_stats():
    """Standardization statistics of a seeded batch's features."""
    b = jax_synthetic_batch(4, 512, seed=21)
    names = JaxVAEP()._kernel_names()
    X = np.asarray(jfeat.compute_features(b, names=names, k=3)).reshape(-1, 568)
    std = X.std(axis=0)
    return X.mean(axis=0).astype(np.float32), np.where(std > 0, std, 1.0).astype(np.float32)


def _numpy_params(seed, hidden, n_features=568):
    rng = np.random.default_rng(seed)
    widths = (n_features, *hidden, 1)
    return {'params': {
        f'Dense_{i}': {
            'kernel': rng.normal(0, widths[i] ** -0.5, (widths[i], widths[i + 1])).astype(np.float32),
            'bias': rng.normal(0, 0.1, widths[i + 1]).astype(np.float32),
        }
        for i in range(len(widths) - 1)
    }}


def _jax_model(hidden):
    mean, std = _feature_stats()
    model = JaxVAEP()
    for seed, col in enumerate(('scores', 'concedes')):
        clf = JaxMLP(hidden=hidden)
        params = _numpy_params(seed + 7 * len(hidden), hidden)
        clf.params = {'params': {
            layer: {n: jnp.asarray(a) for n, a in leaves.items()}
            for layer, leaves in params['params'].items()
        }}
        clf.mean_, clf.std_ = mean, std
        model._models[col] = clf
    return model


def _saved_pair(hidden, tmp_path_factory):
    """(JAX model, port model loaded from the JAX model's checkpoint)."""
    jmodel = _jax_model(hidden)
    path = str(tmp_path_factory.mktemp('ckpt'))
    jmodel.save_model(path)
    return jmodel, load_model(path, device='cpu')


@pytest.fixture(scope='module')
def pair(tmp_path_factory):
    """Narrow (8,) heads: most tests run here."""
    return _saved_pair((8,), tmp_path_factory)


def _batches(n_games=3, n_actions=256, seed=3):
    return (
        jax_synthetic_batch(n_games, n_actions, fill=0.8, seed=seed),
        synthetic_batch(n_games, n_actions, fill=0.8, seed=seed, device='cpu'),
    )


def _assert_values_close(got, want, mask):
    got = got.numpy() if isinstance(got, torch.Tensor) else got
    want = np.asarray(want)
    assert got.shape == want.shape
    np.testing.assert_allclose(got[mask], want[mask], rtol=0, atol=ATOL)


def test_rate_batch_matches_jax(pair):
    jmodel, model = pair
    jb, tb = _batches()
    mask = tb.mask.numpy()
    want = jmodel.rate_batch(jb)
    _assert_values_close(model.rate_batch(tb), want, mask)
    _assert_values_close(model.rate_batch_reference(tb), want, mask)


def test_default_width_heads_match_jax(tmp_path_factory):
    """Once at the repo's default (128, 128) heads, on a small batch:
    rate_batch, the reference path and the bitwise fold."""
    jmodel, model = _saved_pair((128, 128), tmp_path_factory)
    jb, tb = _batches(2, 128, seed=12)
    mask = tb.mask.numpy()
    want = jmodel.rate_batch(jb)
    _assert_values_close(model.rate_batch(tb), want, mask)
    _assert_values_close(model.rate_batch_reference(tb), want, mask)
    got = model._prepared_pair().tables.data.numpy()
    fold = np.asarray(_jax_fold(jmodel, 'none').tables.data)
    assert got.shape == fold.shape == (3, 552, 256)
    assert np.array_equal(got, fold), f'fold differs by up to {_ulp_gap(got, fold)} ulp'


def test_rate_batch_matches_jax_pallas_kernel(pair, monkeypatch):
    """JAX through its Pallas kernel (interpret mode on the CPU)."""
    jmodel, model = pair
    monkeypatch.setenv('SOCCERACTION_TPU_FUSED_KERNEL', 'pallas')
    jb, tb = _batches(2, 128, seed=4)
    _assert_values_close(model.rate_batch(tb), jmodel.rate_batch(jb), tb.mask.numpy())


def _ulp_gap(a, b):
    ia = a.view(np.int32).astype(np.int64)
    ib = b.view(np.int32).astype(np.int64)
    return int(np.abs(ia - ib).max())


def _jax_fold(jmodel, quantize):
    return jfused.prepare_pair_fold(
        jmodel._models['scores'], jmodel._models['concedes'],
        names=jmodel._kernel_names(), k=3, quantize=quantize,
    )


def test_folded_tables_bitwise(pair):
    jmodel, model = pair
    want = np.asarray(_jax_fold(jmodel, 'none').tables.data)
    got = model._prepared_pair().tables.data.numpy()
    assert got.shape == want.shape == (3, 552, 16)
    assert np.array_equal(got, want), f'fold differs by up to {_ulp_gap(got, want)} ulp'


@pytest.mark.parametrize('mode', ['bf16', 'int8'])
def test_quantized_modes_match_jax(pair, mode):
    jmodel, model = pair
    jb, tb = _batches(seed=6)
    try:
        jmodel.set_quantize(mode)
        model.set_quantize(mode)
        want_fold = _jax_fold(jmodel, mode)
        got_fold = model._prepared_pair()
        for w, g in zip(want_fold.tables, got_fold.tables):
            if w is not None:
                w = np.asarray(w)
                g = g.view(torch.int16).numpy() if g.dtype == torch.bfloat16 else g.numpy()
                assert g.tobytes() == (w.view(np.int16) if mode == 'bf16' else w).tobytes()
        _assert_values_close(model.rate_batch(tb), jmodel.rate_batch(jb), tb.mask.numpy())
    finally:
        jmodel.set_quantize('none')
        model.set_quantize('none')


def test_int8_checkpoint_restores_its_scales(tmp_path):
    jmodel = _jax_model((8,))
    jmodel.set_quantize('int8')
    jmodel.save_model(str(tmp_path))
    model = load_model(str(tmp_path), device='cpu')
    assert model.quantize == 'int8'
    want = jmodel._prepared_pair()
    got = model._prepared_pair()
    np.testing.assert_array_equal(got.tables.scale.numpy(), np.asarray(want.tables.scale))
    np.testing.assert_array_equal(got.tables.data.numpy(), np.asarray(want.tables.data))
    jb, tb = _batches(seed=8)
    _assert_values_close(model.rate_batch(tb), jmodel.rate_batch(jb), tb.mask.numpy())


def test_rate_matches_jax_on_golden_game(pair, spadl_actions):
    jmodel, model = pair
    game = pd.Series({'home_team_id': 782})
    want = jmodel.rate(game, spadl_actions)
    got = model.rate(game, spadl_actions)
    assert list(got.columns) == list(want.columns)
    assert got.index.equals(want.index)
    np.testing.assert_allclose(got.to_numpy(), want.to_numpy(), rtol=0, atol=ATOL)


def test_dense_overrides_and_bucketing_match_jax(pair):
    """Three games bucket to four; a goalscore override rides along."""
    jmodel, model = pair
    jb, tb = _batches(3, 128, seed=9)
    block = np.random.default_rng(0).integers(0, 3, size=(3, 128, 3)).astype(np.float32)
    want = jmodel.rate_batch(jb, dense_overrides={'goalscore': jnp.asarray(block)})
    got = model.rate_batch(tb, dense_overrides={'goalscore': torch.from_numpy(block)})
    _assert_values_close(got, want, tb.mask.numpy())
    ref = model.rate_batch_reference(tb, dense_overrides={'goalscore': block})
    _assert_values_close(ref, want, tb.mask.numpy())


def test_dense_override_validation(pair):
    _, model = pair
    _, tb = _batches(2, 128)
    with pytest.raises(ValueError, match='not a dense feature block'):
        model.rate_batch(tb, dense_overrides={'actiontype_onehot': np.zeros((2, 128, 69))})
    with pytest.raises(ValueError, match='expected'):
        model.rate_batch(tb, dense_overrides={'goalscore': np.zeros((2, 128, 2))})


def test_model_without_heads_refuses_to_rate():
    with pytest.raises(NotFittedError):
        VAEP(device='cpu').rate_batch(synthetic_batch(1, 128, device='cpu'))


def _saved(tmp_path):
    _jax_model((8,)).save_model(str(tmp_path))
    return str(tmp_path)


def test_load_model_rejects_newer_format(tmp_path):
    path = _saved(tmp_path)
    meta_path = os.path.join(path, 'meta.json')
    with open(meta_path) as f:
        meta = json.load(f)
    meta['format_version'] = 99
    with open(meta_path, 'w') as f:
        json.dump(meta, f)
    with pytest.raises(ValueError, match='newer than this library'):
        load_model(path, device='cpu')


def test_load_model_names_a_corrupt_artifact(tmp_path):
    path = _saved(tmp_path)
    artifact = os.path.join(path, 'models', 'scores.npz')
    data = bytearray(open(artifact, 'rb').read())
    data[len(data) // 2] ^= 0xFF
    with open(artifact, 'wb') as f:
        f.write(bytes(data))
    with pytest.raises(ValueError, match='scores.npz'):
        load_model(path, device='cpu')


def test_params_from_msgpack_matches_flax():
    from flax import serialization

    params = _numpy_params(3, (4, 5), n_features=6)
    raw = serialization.to_bytes(params)
    got = convert.params_from_msgpack(raw)
    for layer, leaves in params['params'].items():
        for name, a in leaves.items():
            np.testing.assert_array_equal(got['params'][layer][name], a)


def test_converter_transposes_square_kernels():
    """A square (128 x 128) kernel is the case where a missing transpose
    would keep every shape right and every value wrong."""
    params = _numpy_params(5, (128, 128), n_features=128)
    clf = JaxMLP(hidden=(128, 128))
    clf.params = params
    clf.mean_ = np.zeros(128, np.float32)
    clf.std_ = np.ones(128, np.float32)
    x = np.random.default_rng(1).normal(size=(64, 128)).astype(np.float32)
    want = np.asarray(clf.predict_proba_device(jnp.asarray(x)))
    port = convert.mlp_from_jax_params(params, clf.mean_, clf.std_, device='cpu')
    got = port.predict_proba_device(torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-6)


def test_converter_rejects_broken_chains():
    params = _numpy_params(5, (8,), n_features=6)
    params['params']['Dense_1']['kernel'] = np.zeros((7, 1), np.float32)
    with pytest.raises(ValueError, match='takes 7 inputs'):
        convert.mlp_from_jax_params(params, np.zeros(6), np.ones(6), device='cpu')


def test_mlp_checkpoint_loads_directly(tmp_path):
    jclf = _jax_model((8,))._models['scores']
    jclf.save(str(tmp_path / 'head.npz'))
    clf = MLPClassifier.load(str(tmp_path / 'head.npz'), device='cpu')
    assert clf.hidden == (8,)
    x = np.random.default_rng(2).normal(size=(16, 568)).astype(np.float32)
    want = np.asarray(jclf.predict_proba_device(jnp.asarray(x)))
    np.testing.assert_allclose(
        clf.predict_proba_device(torch.from_numpy(x)).numpy(), want, rtol=0, atol=ATOL
    )



def test_vaep_exports_match_jax_less_the_dataframe_layer():
    """The two packages' ``vaep`` and ``atomic.vaep`` modules export the
    same names: the DataFrame layer (``features``, ``labels``, ``formula``,
    ``xfns_default``) is ported now, so nothing is left out. Each name the
    port exports is the object its modules define."""
    import socceraction_tpu.atomic.vaep as jax_atomic_vaep
    import socceraction_tpu.vaep as jax_vaep
    import socceraction_tpu_torch.atomic.vaep as port_atomic_vaep
    import socceraction_tpu_torch.vaep as port_vaep
    from socceraction_tpu_torch.vaep import base, features, formula, labels

    assert set(port_vaep.__all__) == set(jax_vaep.__all__)
    assert set(port_atomic_vaep.__all__) == set(jax_atomic_vaep.__all__)
    assert (port_vaep.features, port_vaep.labels, port_vaep.formula) == (features, labels, formula)
    assert port_vaep.xfns_default is base.xfns_default
    assert port_vaep.NotFittedError is NotFittedError
    assert issubclass(port_vaep.NotFittedError, ValueError)
    assert (port_vaep.VAEP, port_vaep.load_model) == (VAEP, load_model)
