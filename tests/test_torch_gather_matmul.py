"""The fused gather + matmul first layer (kernel B1) of the PyTorch port.

On the CPU the port's plain version is held against the JAX package's
``gather_matmul._forward`` under both of its lowerings: ``pallas`` (the
TPU kernel, run in interpret mode off the TPU, as tests/test_quant.py
runs it) and ``xla``. With no dense block the result must be exact (one
gathered row per state, added in the same order); otherwise within 1e-5
relative (the dense product sums in another order).

The CUDA kernel runs its dense product on the tensor cores in 3xTF32
(``cvt.rna.tf32`` splits each operand into a TF32 high part and a TF32
remainder; three products, the lo*lo term dropped). The CPU tests emulate
that split in numpy and hold it to the card test's tolerance against a
float64 product. The kernel itself runs only on the card: the ``gpu`` tests
hold it against the plain version there and skip here. The machine with the card
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


def _tf32(a):
    """``cvt.rna.tf32.f32``: round to nearest, ties away from zero, keeping
    10 explicit mantissa bits (the low 13 bits of the f32 pattern cleared)."""
    bits = np.ascontiguousarray(a, dtype=np.float32).view(np.uint32)
    return ((bits + np.uint32(0x1000)) & np.uint32(0xFFFFE000)).view(np.float32)


def _dense_3xtf32(acc, x, w, w_is_bf16):
    """The kernel's dense product in numpy: per 8-deep k-step, one
    tensor-core product per term, ``a_lo*w_hi + a_hi*w_lo + a_hi*w_hi`` in
    that order (``w_lo`` is 0 for a bf16 W), each product exact and added
    to the f32 accumulator with one rounding."""
    x_hi = _tf32(x)
    x_lo = _tf32(x - x_hi)
    w_hi = _tf32(w)
    w_lo = _tf32(w - w_hi)
    if w_is_bf16:
        np.testing.assert_array_equal(w_hi, w)  # bf16 is exact in TF32
        terms = [(x_lo, w_hi), (x_hi, w_hi)]
    else:
        terms = [(x_lo, w_hi), (x_hi, w_lo), (x_hi, w_hi)]
    acc = acc.astype(np.float32)
    for k0 in range(0, x.shape[1], 8):
        ks = slice(k0, k0 + 8)
        for a, b in terms:
            prod = a[:, ks].astype(np.float64) @ b[ks].astype(np.float64)
            acc = (acc.astype(np.float64) + prod).astype(np.float32)
    return acc


def test_tf32_rounding_is_nearest_ties_away():
    one = np.float32(1.0)
    ulp = np.float32(2.0 ** -10)  # TF32's step at 1.0
    cases = np.array([one, one + ulp / 4, one + ulp / 2, one + 3 * ulp / 4, -(one + ulp / 2)],
                     np.float32)
    np.testing.assert_array_equal(_tf32(cases), [one, one, one + ulp, one + ulp, -(one + ulp)])


@pytest.mark.parametrize('start', ['zero', 'gathers'])
@pytest.mark.parametrize('dtype', ['float32', 'bfloat16'])
def test_3xtf32_dense_product_holds_the_kernel_tolerance(dtype, start):
    """Serving-like operands (D = 55, H = 256, x standardized, W ~ N(0, 1/D)):
    the emulated 3xTF32 product, alone or on top of the bias and three
    gathered rows, stays within atol 1e-4 and rtol 1e-5 of float64; one
    plain TF32 product does not."""
    rng = np.random.default_rng(55)
    n, d, h = 2048, 55, 256
    x = rng.normal(size=(n, d)).astype(np.float32)
    w = rng.normal(0, d ** -0.5, size=(d, h)).astype(np.float32)
    if dtype == 'bfloat16':
        w = torch.from_numpy(w).to(torch.bfloat16).to(torch.float32).numpy()
    if start == 'zero':
        acc = np.zeros((n, h), np.float32)
    else:
        acc = rng.normal(size=h).astype(np.float32)[None, :]
        for _ in range(3):
            acc = acc + rng.normal(size=(n, h)).astype(np.float32)
    exact = acc.astype(np.float64) + x.astype(np.float64) @ w.astype(np.float64)
    got = _dense_3xtf32(acc, x, w, dtype == 'bfloat16')
    np.testing.assert_allclose(got, exact, atol=1e-4, rtol=1e-5)
    # the split is what buys the accuracy: a single TF32 product misses
    single = acc.astype(np.float64) + _tf32(x).astype(np.float64) @ _tf32(w).astype(np.float64)
    assert np.abs(single - exact).max() > 1e-3


@pytest.fixture
def cuda():
    """The card, or a skip where there is none (decided per test, not at
    import, so every worker collects the same tests)."""
    if not torch.cuda.is_available():
        pytest.skip('needs a CUDA card')
    return torch.device('cuda')


@pytest.mark.gpu
@pytest.mark.parametrize('dtype', [torch.float32, torch.bfloat16])
@pytest.mark.parametrize(
    'n, h, d, offset',
    [
        (851968 // 64, 256, 55, 0),  # whole 64-row tiles, bulk copies only
        (4097, 256, 55, 0),          # a ragged last tile
        (4097, 256, 55, 1),          # bases one row past the allocation's start
        (1, 256, 55, 0),
        (1000, 8, 55, 0),
        (1000, 100, 55, 0),          # H not a multiple of 8
        (777, 256, 0, 0),            # no dense block
        (300, 7, 13, 1),             # odd H and D, unaligned bases
        (200, 520, 55, 0),           # more than one 256-column window
        (1000, 256, 93, 0),          # the dense width of nb_prev_actions = 5
    ],
    ids=['tiles', 'ragged', 'offset', 'n1', 'h8', 'h100', 'd0', 'odd', 'h520', 'd93'],
)
def test_kernel_matches_plain_version_on_the_card(cuda, dtype, n, h, d, offset):
    ops = _operands(n + offset, 3, R, h, d, seed=n + h)
    ids = ops[3]
    rng = np.random.default_rng(n)
    # ids past the table (R and beyond) and other negatives add nothing
    ids[rng.random(ids.shape) < 0.05] = R
    ids[rng.random(ids.shape) < 0.02] = R + 7
    ids[rng.random(ids.shape) < 0.02] = -3
    tables, w, bias, ids, x = _torch(ops, dtype, cuda)
    # a contiguous view at a storage offset of ``offset`` rows
    ids, x = ids[offset:], x[offset:]
    assert ids.is_contiguous() and x.is_contiguous()
    args = (tables, w, bias, ids, x)
    before = tgm.fused_first_layer_quant.launches
    got = tgm.fused_first_layer_quant(*args)
    torch.cuda.synchronize()
    assert tgm.fused_first_layer_quant.launches == before + 1
    want = tgm.fused_first_layer_reference(*args)
    # the kernel adds the dense product in 3xTF32 on the tensor cores on
    # top of the gathers, the plain version as a separate f32 product:
    # atol 1e-4, rtol 1e-5
    torch.testing.assert_close(got, want, atol=1e-4, rtol=1e-5)


@pytest.mark.gpu
@pytest.mark.parametrize('dtype', [torch.float32, torch.bfloat16])
@pytest.mark.parametrize(
    'n, k, h, d',
    [
        (1000, 3, 256, 112),          # nb_prev_actions >= 6: two passes over D
        (851968 // 8, 3, 256, 112),   # two passes, many tiles per row group
        (4097, 3, 256, 188),          # two passes, a ragged last tile
        (1000, 3, 8, 600),            # narrow H, seven passes
        (300, 3, 100, 1001),          # H not a multiple of 8, D not of 4 (x by plain loads)
        (1000, 20, 256, 55),          # more tables than are staged: ids from global
        (777, 40, 7, 189),            # both, with odd H and odd D
    ],
    ids=['d112', 'd112-tiles', 'd188', 'h8-d600', 'h100-d1001', 'k20', 'k40-d189'],
)
def test_kernel_takes_wide_dense_blocks_and_many_tables_on_the_card(cuda, dtype, n, k, h, d):
    """Shared memory does not grow with D or k: a D whose W window does not
    fit beside the x tiles runs in passes over D, and many tables read
    their ids from global memory; each is one launch, held to the plain
    version as the serving shape is."""
    ops = _operands(n, k, R, h, d, seed=n + k + d)
    args = _torch(ops, dtype, cuda)
    before = tgm.fused_first_layer_quant.launches
    got = tgm.fused_first_layer_quant(*args)
    torch.cuda.synchronize()
    assert tgm.fused_first_layer_quant.launches == before + 1
    torch.testing.assert_close(got, tgm.fused_first_layer_reference(*args), atol=1e-4, rtol=1e-5)


@pytest.mark.gpu
@pytest.mark.parametrize('dtype', [torch.float32, torch.bfloat16])
@pytest.mark.parametrize('n', [851968, 4097], ids=['serving', 'ragged'])
def test_kernel_at_the_atomic_serving_shape_on_the_card(cuda, dtype, n):
    """Atomic-VAEP serving: 128 combined-table rows, D = 46 dense columns
    (184 bytes a row of x, so a tile's x is a 16-byte multiple only at
    whole 64-row tiles) and H = 256; one launch, held to the plain version
    as the standard shape is."""
    args = _torch(_operands(n, 3, 128, 256, 46, seed=46), dtype, cuda)
    before = tgm.fused_first_layer_quant.launches
    plans = dict(tgm.fused_first_layer_quant.plans)
    got = tgm.fused_first_layer_quant(*args)
    torch.cuda.synchronize()
    assert tgm.fused_first_layer_quant.launches == before + 1
    # one pass over D, so x takes bulk copies though 46 is not a multiple of 4
    plan = tgm.plan_name(1 | 4)
    assert tgm.fused_first_layer_quant.plans.get(plan, 0) == plans.get(plan, 0) + 1
    torch.testing.assert_close(got, tgm.fused_first_layer_reference(*args), atol=1e-4, rtol=1e-5)
