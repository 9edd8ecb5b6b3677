"""The fused gather + matmul first layer (kernel B1) of the PyTorch port.

On the CPU the port's plain version is held against the JAX package's
``gather_matmul._forward`` under both of its lowerings: ``pallas`` (the
TPU kernel, run in interpret mode off the TPU, as tests/test_quant.py
runs it) and ``xla``. With no dense block the result must be exact (one
gathered row per state, added in the same order); otherwise within 1e-5
relative (the dense product sums in another order).

The CUDA kernel itself runs only on the card: the ``gpu`` tests hold it
against the plain version there and skip here. The machine with the card
has no JAX, so this module imports the JAX package only inside the tests
that compare with it, and the card runs it without the suite's conftest:

    python -m pytest tests/test_torch_gather_matmul.py -m gpu --noconftest -q
"""

import numpy as np
import pytest
import torch

from socceraction_tpu_torch.ops import gather_matmul as tgm

R = 552  # combined-table rows of the standard SPADL vocabulary


def _operands(n, k, r, h, d, seed=0, p_missing=0.1):
    """numpy operands; about ``p_missing`` of the ids are -1 (padding rows)."""
    rng = np.random.default_rng(seed)
    ids = rng.integers(0, r, size=(n, k)).astype(np.int32)
    ids[rng.random((n, k)) < p_missing] = -1
    return (
        rng.normal(size=(k, r, h)).astype(np.float32),
        rng.normal(0, d ** -0.5 if d else 1.0, size=(d, h)).astype(np.float32),
        rng.normal(size=h).astype(np.float32),
        ids,
        rng.normal(size=(n, d)).astype(np.float32),
    )


def _torch(ops, dtype, device='cpu'):
    tables, w, bias, ids, x = (torch.from_numpy(a).to(device) for a in ops)
    return tables.to(dtype), w.to(dtype), bias, ids, x


@pytest.mark.parametrize('method', ['pallas', 'xla'])
@pytest.mark.parametrize('dtype', ['float32', 'bfloat16'])
@pytest.mark.parametrize('d', [0, 55])
@pytest.mark.parametrize('h', [8, 256])
def test_plain_version_matches_jax(h, d, dtype, method):
    import jax.numpy as jnp

    from socceraction_tpu.ops import gather_matmul as jgm

    ops = _operands(300, 3, R, h, d, seed=h + d)
    jdt = jnp.dtype(dtype)
    tables, w, bias, ids, x = (jnp.asarray(a) for a in ops)
    want = np.asarray(
        jgm._forward(tables.astype(jdt), w.astype(jdt), bias, ids, x, method=method)
    )
    targs = _torch(ops, getattr(torch, dtype))
    got = tgm.fused_first_layer_reference(*targs).numpy()
    assert got.shape == want.shape == (300, h)
    if d == 0:
        np.testing.assert_array_equal(got, want)
    else:
        np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-6)
    # on CPU tensors the wrapper IS the plain version, and launches nothing
    launches = tgm.fused_first_layer_quant.launches
    np.testing.assert_array_equal(tgm.fused_first_layer_quant(*targs).numpy(), got)
    assert tgm.fused_first_layer_quant.launches == launches


def test_ids_outside_the_table_add_nothing():
    """-1 (padding), R and beyond, and other negatives all add nothing;
    ``table[-1]`` would have read the last real row."""
    tables, w, bias, _, x = _operands(6, 2, 5, 4, 3)
    ids = np.array([[-1, 0], [5, 4], [-7, 9], [4, 4], [0, -1], [2, 3]], np.int32)
    got = tgm.fused_first_layer_reference(
        *_torch((tables, w, bias, ids, x), torch.float32)
    ).numpy()
    want = np.tile(bias, (6, 1))
    for n in range(6):
        for i in range(2):
            if 0 <= ids[n, i] < 5:
                want[n] += tables[i, ids[n, i]]
    want += x @ w
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize(
    'change, error',
    [
        (lambda a: a.__setitem__(0, a[0].to(torch.float64)), TypeError),
        (lambda a: a.__setitem__(1, a[1].to(torch.bfloat16)), TypeError),
        (lambda a: a.__setitem__(2, a[2][:-1]), ValueError),
        (lambda a: a.__setitem__(3, a[3].long()), TypeError),
        (lambda a: a.__setitem__(3, a[3][:, :2]), ValueError),
        (lambda a: a.__setitem__(4, a[4][:-1]), ValueError),
        (lambda a: a.__setitem__(0, a[0][0]), ValueError),
    ],
    ids=['tables-f64', 'w-dtype-mismatch', 'bias-shape', 'ids-int64', 'ids-k',
         'x-rows', 'tables-2d'],
)
def test_wrapper_rejects_bad_operands(change, error):
    args = list(_torch(_operands(10, 3, 20, 8, 4), torch.float32))
    change(args)
    with pytest.raises(error):
        tgm.fused_first_layer_quant(*args)


@pytest.fixture
def cuda():
    """The card, or a skip where there is none (decided per test, not at
    import, so every worker collects the same tests)."""
    if not torch.cuda.is_available():
        pytest.skip('needs a CUDA card')
    return torch.device('cuda')


@pytest.mark.gpu
@pytest.mark.parametrize('dtype', [torch.float32, torch.bfloat16])
@pytest.mark.parametrize('n, h, d', [(851968 // 64, 256, 55), (1000, 8, 55), (77, 256, 0)])
def test_kernel_matches_plain_version_on_the_card(cuda, dtype, n, h, d):
    args = _torch(_operands(n, 3, R, h, d, seed=n), dtype, cuda)
    before = tgm.fused_first_layer_quant.launches
    got = tgm.fused_first_layer_quant(*args)
    torch.cuda.synchronize()
    assert tgm.fused_first_layer_quant.launches == before + 1
    want = tgm.fused_first_layer_reference(*args)
    # the kernel runs the dense dot as one FMA chain, the plain version as
    # a separate product: atol 1e-4, rtol 1e-5
    torch.testing.assert_close(got, want, atol=1e-4, rtol=1e-5)
