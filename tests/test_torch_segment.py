"""The segment sum (kernel B2) of the PyTorch port.

On the CPU the port's ``segment_sum`` (its plain version, ``index_add_``),
``segment_sum_2d`` and ``segment_sum_rows`` are held against the JAX
package's ``segment_sum_pallas`` (the TPU kernel, in interpret mode off the
TPU) and ``segment_sum_xla`` on the same seeded numpy inputs: integer
counts bitwise, real values within rtol 1e-6 (the Pallas kernel sums in
512-item chunks, another order).

The CUDA kernel itself runs only on the card: the ``gpu`` tests hold it
against the plain version there, in both of its regimes (shared-memory
histograms up to the source's ``SHARED_MAX_SEGMENTS``, per warp or per
block, global atomics above), over aligned and unaligned streams, and skip
here. The card runs them without the suite's conftest:

    python -m pytest tests/test_torch_segment.py -m gpu --noconftest -q
"""

import re
from pathlib import Path

import numpy as np
import pytest
import torch

from socceraction_tpu_torch.ops import segment as tseg


def _stream(n, s, seed, counts, p_out=0.1):
    """Seeded ``(values, ids)``: ids in ``[0, s)`` with about ``p_out`` of
    them out of range (negatives, ``s`` and beyond); 0/1 values for
    counts, else normals."""
    rng = np.random.default_rng(seed)
    ids = rng.integers(0, s, size=n).astype(np.int32)
    out = rng.random(n) < p_out
    ids[out] = rng.choice(np.array([-1, -7, s, s + 3], np.int32), size=int(out.sum()))
    if counts:
        vals = (rng.random(n) < 0.4).astype(np.float32)
    else:
        vals = rng.normal(size=n).astype(np.float32)
    return vals, ids


def _jax(fn, vals, ids, s, **kw):
    import jax.numpy as jnp

    return np.asarray(fn(jnp.asarray(vals), jnp.asarray(ids), s, **kw))


@pytest.mark.parametrize('counts', [True, False], ids=['counts', 'real'])
@pytest.mark.parametrize('n, s', [(5, 6), (700, 192), (3000, 2500), (4096, 24000)])
def test_segment_sum_matches_jax(n, s, counts):
    from socceraction_tpu.ops import segment as jseg

    vals, ids = _stream(n, s, seed=n + s, counts=counts)
    got = tseg.segment_sum(torch.from_numpy(vals), torch.from_numpy(ids), s).numpy()
    xla = _jax(jseg.segment_sum_xla, vals, ids, s)
    pallas = _jax(jseg.segment_sum_pallas, vals, ids, s, interpret=True)
    assert got.shape == (s,) and got.dtype == np.float32
    # both add in stream order: bitwise
    np.testing.assert_array_equal(got, xla)
    if counts:
        np.testing.assert_array_equal(got, pallas)
    else:
        np.testing.assert_allclose(got, pallas, rtol=1e-6, atol=1e-6)


def test_out_of_range_ids_add_nothing():
    """-1, other negatives, S and beyond all add nothing; ``out[-1]`` would
    have landed on the last segment."""
    from socceraction_tpu.ops import segment as jseg

    vals = np.array([10.0, 1.0, 2.0, 5.0, 7.0, 3.0], np.float32)
    ids = np.array([-1, 0, 2, 4, -9, 3], np.int32)
    got = tseg.segment_sum(torch.from_numpy(vals), torch.from_numpy(ids), 4).numpy()
    np.testing.assert_array_equal(got, [1.0, 0.0, 2.0, 3.0])
    np.testing.assert_array_equal(got, _jax(jseg.segment_sum_pallas, vals, ids, 4, interpret=True))
    # int64 ids, and 2-D inputs (flattened)
    got64 = tseg.segment_sum(
        torch.from_numpy(vals).reshape(2, 3), torch.from_numpy(ids).long().reshape(2, 3), 4
    )
    np.testing.assert_array_equal(got64.numpy(), got)


def test_wrapper_on_the_cpu_is_the_plain_version():
    vals, ids = _stream(500, 64, seed=1, counts=False)
    v, i = torch.from_numpy(vals), torch.from_numpy(ids)
    before = tseg.segment_sum.launches
    np.testing.assert_array_equal(
        tseg.segment_sum(v, i, 64).numpy(), tseg.segment_sum_reference(v, i, 64).numpy()
    )
    assert tseg.segment_sum.launches == before
    assert tseg.segment_sum(v[:0], i[:0], 3).tolist() == [0.0, 0.0, 0.0]
    assert tseg.segment_sum(v, i, 0).shape == (0,)


def test_plain_version_in_f64_gives_the_exact_sums():
    """The f64 plain version (what the card check holds real sums to)
    equals numpy's f64 sums by bucket, out-of-range ids dropped."""
    vals, ids = _stream(5000, 7, seed=4, counts=False)
    got = tseg.segment_sum_reference(
        torch.from_numpy(vals), torch.from_numpy(ids), 7, dtype=torch.float64
    )
    assert got.dtype == torch.float64
    v64 = vals.astype(np.float64)
    want = [v64[ids == s].sum() for s in range(7)]
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-12, atol=1e-12)


@pytest.mark.parametrize(
    'values, ids, error',
    [
        (torch.ones(4), torch.zeros(5, dtype=torch.int32), ValueError),
        (torch.ones(4), torch.zeros(4), TypeError),
        (torch.ones(4), torch.zeros(4, dtype=torch.bool), TypeError),
    ],
    ids=['length', 'float-ids', 'bool-ids'],
)
def test_wrapper_rejects_bad_operands(values, ids, error):
    with pytest.raises(error):
        tseg.segment_sum(values, ids, 3)


@pytest.mark.parametrize('counts', [True, False], ids=['counts', 'real'])
def test_segment_sum_2d_matches_jax(counts):
    """Per-axis drop: a pair out of range on either axis adds nothing
    (``row=2, col=-1`` must not land on the last cell of row 1)."""
    from socceraction_tpu.ops import segment as jseg
    import jax.numpy as jnp

    rng = np.random.default_rng(7)
    n, R, C = 2000, 5, 37
    rows = rng.integers(-1, R + 1, size=n).astype(np.int32)
    cols = rng.integers(-2, C + 2, size=n).astype(np.int32)
    vals = (rng.random(n) < 0.5).astype(np.float32) if counts else rng.normal(size=n).astype(np.float32)
    got = tseg.segment_sum_2d(
        torch.from_numpy(vals), torch.from_numpy(rows), torch.from_numpy(cols), R, C
    ).numpy()
    assert got.shape == (R, C)
    for method in ('xla', 'pallas'):
        want = np.asarray(
            jseg.segment_sum_2d(
                jnp.asarray(vals), jnp.asarray(rows), jnp.asarray(cols), R, C, method=method
            )
        )
        if counts or method == 'xla':
            np.testing.assert_array_equal(got, want)
        else:
            np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-6)
    # the pair (2, -1) and (1, C) add nothing
    edge = tseg.segment_sum_2d(
        torch.ones(3), torch.tensor([2, 1, R]), torch.tensor([-1, C, 0]), R, C
    )
    assert float(edge.sum()) == 0.0


def test_segment_sum_2d_int32_overflow_guard():
    with pytest.raises(ValueError, match='int32'):
        tseg.segment_sum_2d(
            torch.ones(3), torch.zeros(3, dtype=torch.int32),
            torch.zeros(3, dtype=torch.int32), 4000, 576 * 576 * 2,
        )


@pytest.mark.parametrize('h', [1, 8])
def test_segment_sum_rows_matches_jax(h):
    from socceraction_tpu.ops import segment as jseg
    import jax.numpy as jnp

    rng = np.random.default_rng(h)
    n, s = 600, 552
    vals = rng.normal(size=(n, h)).astype(np.float32)
    ids = rng.integers(-2, s + 2, size=n).astype(np.int32)
    got = tseg.segment_sum_rows(torch.from_numpy(vals), torch.from_numpy(ids), s).numpy()
    want = np.asarray(jseg.segment_sum_rows(jnp.asarray(vals), jnp.asarray(ids), s, method='xla'))
    np.testing.assert_array_equal(got, want)
    onehot = np.asarray(
        jseg.segment_sum_rows(jnp.asarray(vals), jnp.asarray(ids), s, method='onehot')
    )
    np.testing.assert_allclose(got, onehot, rtol=1e-6, atol=1e-6)


@pytest.fixture
def cuda():
    """The card, or a skip where there is none (decided per test, not at
    import, so every worker collects the same tests)."""
    if not torch.cuda.is_available():
        pytest.skip('needs a CUDA card')
    return torch.device('cuda')


@pytest.mark.gpu
@pytest.mark.parametrize('counts', [True, False], ids=['counts', 'real'])
@pytest.mark.parametrize('s', [192, 12289, 24000, 58112, 58113, 480000])
def test_kernel_matches_plain_version_on_the_card(cuda, s, counts):
    vals, ids = _stream(1_000_003, s, seed=s, counts=counts)
    v, i = torch.from_numpy(vals).to(cuda), torch.from_numpy(ids).to(cuda)
    before = tseg.segment_sum.launches
    got = tseg.segment_sum(v, i, s)
    torch.cuda.synchronize()
    assert tseg.segment_sum.launches == before + 1
    assert tseg.launch_plan(v.numel(), s)['regime'] == _regime(s)
    _check_on_card(got, tseg.segment_sum_reference(v, i, s), v, i, s, counts)


def _regime(s):
    """The kernel's regime at ``s`` segments, from the thresholds in its source."""
    src = (Path(tseg.__file__).resolve().parent.parent / 'csrc' / 'segment_sum.cu').read_text()

    shared_max = int(re.search(r'constexpr int SHARED_MAX_SEGMENTS = (\d+);', src).group(1))
    return 'shared' if s <= shared_max else 'global'


def _check_on_card(got, want, v, i, s, counts):
    if counts:
        # integer-valued f32 sums are exact in any order
        assert torch.equal(got, want)
    else:
        # atomics add in another order than the plain version; with signs
        # that cancel, the reorder error scales with each bin's sum of
        # |values| (at 192 bins about 5,000 normals each), not with its sum:
        # 1e-5 of that, plus 1e-5
        scale = tseg.segment_sum_reference(v.abs(), i, s)
        err = (got - want).abs()
        assert bool((err <= 1e-5 + 1e-5 * scale).all()), float((err / (1 + scale)).max())


@pytest.mark.gpu
@pytest.mark.parametrize('counts', [True, False], ids=['counts', 'real'])
@pytest.mark.parametrize('s', [192, 5000, 24000, 480000])
@pytest.mark.parametrize(
    'val_off, id_off', [(1, 1), (2, 2), (0, 1), (3, 0)],
    ids=['both+1', 'both+2', 'ids+1', 'vals+3'],
)
def test_kernel_unaligned_streams_on_the_card(cuda, s, counts, val_off, id_off):
    """Bases off a 16-byte boundary (the scalar head), N % 4 != 0 (the
    tail), and vals and ids at different offsets (no common vector body),
    in every regime, out-of-range ids included."""
    n = 300_001
    vals, ids = _stream(n + 3, s, seed=s + val_off, counts=counts)
    v = torch.from_numpy(vals).to(cuda)[val_off : val_off + n]
    i = torch.from_numpy(ids).to(cuda)[id_off : id_off + n]
    assert v.data_ptr() % 16 == 4 * val_off % 16 and i.data_ptr() % 16 == 4 * id_off % 16
    before = tseg.segment_sum.launches
    got = tseg.segment_sum(v, i, s)
    torch.cuda.synchronize()
    assert tseg.segment_sum.launches == before + 1
    _check_on_card(got, tseg.segment_sum_reference(v, i, s), v, i, s, counts)


@pytest.mark.gpu
def test_kernel_edge_cases_on_the_card(cuda):
    """Empty streams, a single segment, int64 ids beyond int32 and
    non-contiguous inputs; an empty stream launches nothing."""
    before = tseg.segment_sum.launches
    empty = tseg.segment_sum(torch.ones(0, device=cuda), torch.zeros(0, dtype=torch.int32, device=cuda), 5)
    assert empty.tolist() == [0.0] * 5
    ones = tseg.segment_sum(torch.ones(1000, device=cuda), torch.zeros(1000, dtype=torch.int32, device=cuda), 1)
    assert ones.item() == 1000.0
    big = torch.tensor([0, 2**32, -(2**32) + 1, 1], device=cuda)
    got = tseg.segment_sum(torch.ones(4, device=cuda), big, 2)
    assert got.tolist() == [1.0, 1.0]
    strided = torch.arange(20.0, device=cuda)[::2]
    ids = torch.arange(10, dtype=torch.int32, device=cuda) % 3
    assert torch.equal(tseg.segment_sum(strided, ids, 3), tseg.segment_sum_reference(strided, ids, 3))
    assert tseg.segment_sum.launches == before + 3


@pytest.mark.gpu
def test_kernel_plans_in_any_order_on_the_card(cuda):
    """Launch plans are cached per segment count, and the kernel's
    shared-memory limit is one value per card: a plan made later for fewer
    segments must not leave a cached plan for more over that limit (the
    16 x 12 transition counts, then the 192 x 125 payoff, then the counts
    again, on one stream)."""
    n = 1_000_003
    for s in (36864, 24000, 36864, 12289, 58112, 24000):
        vals, ids = _stream(n, s, seed=s, counts=False)
        v, i = torch.from_numpy(vals).to(cuda), torch.from_numpy(ids).to(cuda)
        before = tseg.segment_sum.launches
        got = tseg.segment_sum(v, i, s)
        torch.cuda.synchronize()
        assert tseg.segment_sum.launches == before + 1
        assert tseg.launch_plan(n, s)['regime'] == 'shared'
        _check_on_card(got, tseg.segment_sum_reference(v, i, s), v, i, s, False)
