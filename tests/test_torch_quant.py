"""The PyTorch port's table quantization against the JAX package's.

From the same f32 tables both packages must produce the same bytes: the
int8 data plane, the packed 2-bit refinement plane and the f32 scales,
and the bf16 plane; dequantizing must give the same f32 values.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from socceraction_tpu.ops import quant as jq
from socceraction_tpu_torch.ops import quant as tq

SHAPES = [(3, 50, 48), (2, 552, 256), (1, 7, 5)]


def _tables(shape, seed=0):
    """Rows whose magnitudes span orders of magnitude, plus an all-zero row
    (the folded tables look like this: W/σ with σ varying per row)."""
    rng = np.random.default_rng(seed)
    t = rng.normal(size=shape) * np.exp(rng.uniform(-6, 3, size=shape[:-1] + (1,)))
    t[..., 0, :] = 0.0
    return t.astype(np.float32)


@pytest.mark.parametrize('mode', ['none', 'bf16', 'int8'])
@pytest.mark.parametrize('shape', SHAPES)
def test_quantize_columns_byte_identical(shape, mode):
    t = _tables(shape)
    want = jq.quantize_columns(jnp.asarray(t), mode)
    got = tq.quantize_columns(torch.from_numpy(t), mode)
    for name, w, g in zip(('data', 'resid', 'scale'), want, got):
        if w is None:
            assert g is None, name
            continue
        w = np.asarray(w)
        if mode == 'bf16':  # compare the raw 16-bit patterns
            w = w.view(np.int16)
            g = g.view(torch.int16)
        g = g.numpy()
        assert g.dtype == w.dtype, name
        assert g.shape == w.shape, name
        assert g.tobytes() == w.tobytes(), name


@pytest.mark.parametrize('mode', ['none', 'bf16', 'int8'])
@pytest.mark.parametrize('shape', SHAPES)
def test_dequantize_equal(shape, mode):
    t = _tables(shape, seed=1)
    want = np.asarray(jq.dequantize(*jq.quantize_columns(jnp.asarray(t), mode)))
    got = tq.dequantize(*tq.quantize_columns(torch.from_numpy(t), mode)).numpy()
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize('shape', SHAPES)
def test_pinned_scales_byte_identical(shape):
    """Re-quantizing under fixed (checkpoint) scales gives the same planes."""
    t = _tables(shape, seed=2)
    scale = np.array(jq.quantize_columns(jnp.asarray(t * 1.01), 'int8').scale)
    w_data, w_resid = jq.quantize_with_scale(jnp.asarray(t), jnp.asarray(scale))
    g_data, g_resid = tq.quantize_with_scale(torch.from_numpy(t), torch.from_numpy(scale))
    assert g_data.numpy().tobytes() == np.asarray(w_data).tobytes()
    assert g_resid.numpy().tobytes() == np.asarray(w_resid).tobytes()


@pytest.mark.parametrize('h', [1, 3, 4, 5, 8, 130, 256])
def test_pack_unpack_codes_match(h):
    codes = np.random.default_rng(h).integers(0, 4, size=(3, 7, h)).astype(np.float32)
    want = np.asarray(jq._pack_codes(jnp.asarray(codes)))
    got = tq._pack_codes(torch.from_numpy(codes)).numpy()
    assert got.dtype == want.dtype == np.uint8
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(tq._unpack_codes(torch.from_numpy(got), h).numpy(), codes)


@pytest.mark.parametrize('mode', ['none', 'bf16', 'int8'])
def test_quantized_nbytes_match(mode):
    t = _tables((3, 552, 256))
    want = jq.quantized_nbytes(jq.quantize_columns(jnp.asarray(t), mode))
    got = tq.quantized_nbytes(tq.quantize_columns(torch.from_numpy(t), mode))
    assert got == want


def test_zero_rows_reconstruct_exactly():
    t = _tables((2, 9, 16))
    q = tq.quantize_columns(torch.from_numpy(t), 'int8')
    assert float(q.scale[:, 0].abs().max()) == 0.0
    assert float(tq.dequantize(*q)[:, 0].abs().max()) == 0.0


def test_unknown_mode_rejected():
    with pytest.raises(ValueError, match='unknown quantize mode'):
        tq.check_quantize_mode('int4')
