"""The port's checkpoint codec against msgpack and flax.

``socceraction_tpu_torch.convert`` writes and reads the msgpack subset that
flax's ``serialization.to_bytes`` writes for the port's two head kinds,
without the ``msgpack`` package. Held here, bytes for bytes, to
``msgpack.packb`` (the encoder the port used before) and to flax, for MLP
and seq parameter trees at the widths the port serves (f32, bf16 leaves,
0-d and empty shapes, every length class of the format); checkpoints
written by the JAX package read in the port and the other way round;
anything outside the subset raises ``CheckpointFormatError``.
"""

import json
import os

import jax
import ml_dtypes
import msgpack
import numpy as np
import pytest
import torch
from flax import serialization

from socceraction_tpu.core.synthetic import synthetic_batch as jax_synthetic_batch
from socceraction_tpu.ml import mlp as jmlp
from socceraction_tpu.seq import model as jseq
from socceraction_tpu.vaep.base import load_model as jax_load_model
from socceraction_tpu_torch import convert
from socceraction_tpu_torch.core.synthetic import synthetic_batch
from socceraction_tpu_torch.obs import drain_guards
from socceraction_tpu_torch.ml.mlp import MLPClassifier
from socceraction_tpu_torch.seq.classifier import SeqClassifier
from socceraction_tpu_torch.vaep.base import VAEP, load_model

#: values a checkpoint round trip moves, between the packages' ratings of
#: the same weights (f32 sums in another order)
ATOL = 1e-5


@pytest.fixture(scope='module', autouse=True)
def _drain_guards():
    """Leave the process-wide guard ring empty for the next module: this
    one's ratings note guards no test here drains."""
    yield
    drain_guards()


def _msgpack_reference(tree):
    """The encoder the port used before its own: msgpack's."""

    def encode(node):
        if isinstance(node, dict):
            return {str(k): encode(v) for k, v in node.items()}
        arr = np.asarray(node)
        payload = msgpack.packb((arr.shape, arr.dtype.name, arr.tobytes('C')), use_bin_type=True)
        return msgpack.ExtType(1, payload)

    return msgpack.packb(encode(tree), strict_types=True)


def _mlp_tree(hidden, n_features=568, seed=0):
    clf = jmlp.MLPClassifier(hidden=hidden, seed=seed)
    return jax.tree.map(np.asarray, clf._init_params(n_features))


def _seq_tree(seed=0):
    params = jseq.init_seq_params(seed, combo_size=552, n_dense=55, embed_dim=32, hidden=64, readout=64)
    return jax.tree.map(lambda a: np.asarray(a, dtype=np.float32), params)


def _odd_tree():
    """Every length class: fixmap/map16 (20 keys), fixstr/str8/str16 keys,
    bin8/16/32 leaves (0-d, empty, 1 MB), fixext and ext8/16/32, shapes as
    fixarray and array16 (17 dims), dims as fixint, uint8, uint16, uint32."""
    rng = np.random.default_rng(1)
    tree = {f'k{i:02d}': np.full((i,), i, np.float32) for i in range(20)}
    tree['s' * 40] = np.array(2.5, np.float32)
    tree['t' * 300] = np.zeros((0, 7), np.float32)
    tree['bf16'] = rng.normal(size=(3, 5)).astype(ml_dtypes.bfloat16)
    tree['wide'] = rng.normal(size=(300, 1000)).astype(np.float32)
    tree['long'] = np.zeros((70000,), np.uint8)
    tree['deep'] = np.zeros((1,) * 17, np.int32)
    tree['ints'] = {'i8': np.arange(-3, 3, dtype=np.int8), 'i64': np.arange(4, dtype=np.int64),
                    'b': np.array([True, False])}
    return tree


TREES = {
    'mlp (128, 128)': lambda: _mlp_tree((128, 128)),
    'mlp (16,)': lambda: _mlp_tree((16,), n_features=154, seed=3),
    'seq 32/64/64': _seq_tree,
    'every length class': _odd_tree,
}


@pytest.mark.parametrize('name', list(TREES))
def test_encoder_writes_msgpack_and_flax_bytes(name):
    tree = TREES[name]()
    got = convert.params_to_msgpack(tree)
    assert got == _msgpack_reference(tree)
    assert got == serialization.to_bytes(tree)


@pytest.mark.parametrize('name', list(TREES))
def test_decoder_reads_flax_bytes(name):
    tree = TREES[name]()
    back = convert.params_from_msgpack(serialization.to_bytes(tree))
    flat = jax.tree_util.tree_flatten_with_path(tree)[0]
    got = dict(jax.tree_util.tree_flatten_with_path(back)[0])
    assert len(got) == len(flat)
    for path, want in flat:
        want = np.asarray(want)
        leaf = got[path]
        # bf16 widens exactly to f32 (the card's machine has no bf16 numpy dtype)
        assert leaf.dtype == (np.float32 if want.dtype == ml_dtypes.bfloat16 else want.dtype)
        assert leaf.shape == want.shape
        np.testing.assert_array_equal(leaf, want.astype(leaf.dtype))
    # flax's own decoder agrees on the bytes the port writes
    again = serialization.msgpack_restore(convert.params_to_msgpack(tree))
    for path, want in flat:
        np.testing.assert_array_equal(np.asarray(dict(
            jax.tree_util.tree_flatten_with_path(again)[0])[path]), np.asarray(want))


@pytest.mark.parametrize('value', [
    0, 1, 127, 128, 255, 256, 65535, 65536, 2**32 - 1, 2**32, 2**63,
    -1, -32, -33, -128, -129, -32768, -32769, -2**31, -2**31 - 1, -2**63,
])
def test_ints_take_msgpack_forms(value):
    out = bytearray()
    convert._pack_int(out, value)
    assert bytes(out) == msgpack.packb(value)
    assert convert._Reader(msgpack.packb([value, value])).value('ints') == [value, value]


def test_str_and_bin_widths_decode():
    for n in (0, 31, 32, 255, 256, 65535, 65536):
        raw = msgpack.packb(['x' * n, b'y' * n], use_bin_type=True)
        assert convert._Reader(raw).value('widths') == ['x' * n, b'y' * n]


_LEAF = msgpack.ExtType(1, msgpack.packb(((2,), 'float32', np.zeros(2, np.float32).tobytes()),
                                         use_bin_type=True))
BAD = {
    'a float leaf': msgpack.packb({'a': 1.5}),
    'a nil leaf': msgpack.packb({'a': None}),
    'a bool leaf': msgpack.packb({'a': True}),
    'a list tree': msgpack.packb([1, 2]),
    'an int key': msgpack.packb({1: _LEAF}),
    'another ext type': msgpack.packb({'a': msgpack.ExtType(3, b'\x00')}),
    'a complex leaf': msgpack.packb({'a': msgpack.ExtType(1, msgpack.packb(
        ((1,), 'complex64', np.zeros(1, np.complex64).tobytes()), use_bin_type=True))}),
    'a short buffer': msgpack.packb({'a': msgpack.ExtType(1, msgpack.packb(
        ((3,), 'float32', np.zeros(2, np.float32).tobytes()), use_bin_type=True))}),
    'a negative dim': msgpack.packb({'a': msgpack.ExtType(1, msgpack.packb(
        ((-1,), 'float32', b''), use_bin_type=True))}),
    'the chunked form': msgpack.packb({'w': {
        '__msgpack_chunked_array__': True, 'shape': [2], 'chunks': {'0': _LEAF}}}),
    'a truncated tree': msgpack.packb({'a': _LEAF})[:-3],
    'trailing bytes': msgpack.packb({'a': _LEAF}) + b'\x00',
}


@pytest.mark.parametrize('case', list(BAD))
def test_decoder_refuses_what_it_does_not_read(case):
    with pytest.raises(convert.CheckpointFormatError):
        convert.params_from_msgpack(BAD[case])


def test_chunked_form_is_named():
    with pytest.raises(convert.CheckpointFormatError, match='chunked'):
        convert.params_from_msgpack(BAD['the chunked form'])


def test_encoder_refuses_unsupported_leaves():
    with pytest.raises(convert.CheckpointFormatError, match='complex64'):
        convert.params_to_msgpack({'a': np.zeros(2, np.complex64)})
    with pytest.raises(convert.CheckpointFormatError, match='not a map'):
        convert.params_to_msgpack(np.zeros(2, np.float32))


def test_codec_error_is_a_value_error():
    """Registries retry transient errors and raise corrupt ones at once:
    a codec error must read as corrupt (ValueError)."""
    assert issubclass(convert.CheckpointFormatError, ValueError)


# -- whole checkpoints across the packages ---------------------------------------------


def _jax_mlp_head(tmp_path, hidden=(16,)):
    rng = np.random.default_rng(2)
    X = rng.normal(size=(512, 20)).astype(np.float32)
    y = (rng.random(512) < 0.3).astype(np.float32)
    clf = jmlp.MLPClassifier(hidden=hidden, max_epochs=2, batch_size=128, seed=0)
    clf.fit(X, y)
    path = str(tmp_path / 'head.npz')
    clf.save(path)
    return clf, path, X


def test_port_reads_jax_written_mlp_head(tmp_path):
    jclf, path, X = _jax_mlp_head(tmp_path)
    clf = MLPClassifier.load(path, device='cpu')
    np.testing.assert_allclose(clf.predict_proba(X), jclf.predict_proba(X), rtol=0, atol=ATOL)
    # and writes the very bytes the JAX package wrote
    with np.load(path) as data:
        want = data['params_msgpack'].tobytes()
    assert convert.params_to_msgpack(convert.jax_params_from_mlp(clf.module)) == want


def _port_model(kind):
    if kind == 'mlp':
        return VAEP(device='cpu').fit_packed(
            synthetic_batch(2, 256, seed=3, device='cpu'),
            tree_params={'hidden': (16,), 'batch_size': 256, 'max_epochs': 1}, random_state=0,
        )
    return VAEP(device='cpu').fit_packed(
        synthetic_batch(2, 256, seed=3, device='cpu'), learner='seq',
        tree_params={'embed_dim': 8, 'hidden': 16, 'readout': 16, 'batch_size': 256,
                     'max_epochs': 1},
        random_state=0,
    )


@pytest.mark.parametrize('kind', ['mlp', 'seq'])
def test_jax_package_reads_port_written_checkpoints(tmp_path, kind):
    model = _port_model(kind)
    model.save_model(str(tmp_path))
    with open(os.path.join(tmp_path, 'meta.json')) as f:
        assert set(json.load(f)['heads'].values()) == {kind}
    jmodel = jax_load_model(str(tmp_path))
    tb = synthetic_batch(2, 256, fill=0.8, seed=8, device='cpu')
    jb = jax_synthetic_batch(2, 256, fill=0.8, seed=8)
    mask = tb.mask.numpy()
    np.testing.assert_allclose(
        model.rate_batch(tb).numpy()[mask], np.asarray(jmodel.rate_batch(jb))[mask],
        rtol=0, atol=ATOL,
    )
    # and the port reads its own bytes back bitwise
    back = load_model(str(tmp_path), device='cpu')
    assert torch.equal(back.rate_batch(tb), model.rate_batch(tb))
    for col, head in back._models.items():
        assert type(head) is (SeqClassifier if kind == 'seq' else MLPClassifier)
        for p, q in zip(head.module.parameters(), model._models[col].module.parameters()):
            assert torch.equal(p, q)
