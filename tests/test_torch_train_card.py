"""The training path on the card, held against the same calls on the CPU.

Every test here needs a CUDA card and skips without one; the machine with
the card has no JAX, so this file imports none, and runs without the
suite's conftest:

    python -m pytest tests/test_torch_train_card.py -m gpu --noconftest -q
"""

import numpy as np
import pytest
import torch

from socceraction_tpu_torch.core.synthetic import synthetic_batch
from socceraction_tpu_torch.ml.mlp import MLPClassifier
from socceraction_tpu_torch.ops import gather_matmul as tgm
from socceraction_tpu_torch.ops import segment as tseg
from socceraction_tpu_torch.ops.labels import scores_concedes
from socceraction_tpu_torch.vaep.base import VAEP, XFNS_DEFAULT

R = 552


@pytest.fixture
def cuda():
    """The card, or a skip where there is none (decided per test, not at
    import, so every worker collects the same tests)."""
    if not torch.cuda.is_available():
        pytest.skip('needs a CUDA card')
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device('cuda')


def _max_rel(got, want):
    got, want = got.double().cpu(), want.double().cpu()
    return float((got - want).abs().max() / want.abs().max().clamp(min=1e-30))


@pytest.mark.gpu
def test_fused_first_layer_forward_and_backward_on_the_card(cuda):
    """At the training shape (8192 rows, k = 3, R = 552, one 128-wide head,
    D = 55): the forward is one launch of B1 within atol 1e-4, rtol 1e-5 of
    the CPU (3xTF32 against f32), and each cotangent within 1e-5 of its
    largest entry (the card sums the table cotangent as a one-hot product,
    the CPU with ``index_add_``)."""
    rng = np.random.default_rng(0)
    n, k, h, d = 8192, 3, 128, 55
    ids = rng.integers(0, R, size=(n, k)).astype(np.int32)
    ids[rng.random((n, k)) < 0.05] = -1
    ids[rng.random((n, k)) < 0.02] = R + 3
    arrays = [
        rng.normal(size=(k, R, h)).astype(np.float32),
        rng.normal(0, d ** -0.5, size=(d, h)).astype(np.float32),
        rng.normal(size=h).astype(np.float32),
        rng.normal(size=(n, d)).astype(np.float32),
    ]
    g = torch.from_numpy(rng.normal(size=(n, h)).astype(np.float32))
    results = {}
    for device in ('cpu', cuda):
        leaves = [torch.from_numpy(a).to(device).requires_grad_(True) for a in arrays]
        before = tgm.fused_first_layer_quant.launches
        out = tgm.fused_first_layer(
            leaves[0], leaves[1], leaves[2], torch.from_numpy(ids).to(device), leaves[3]
        )
        out.backward(g.to(device))
        launched = tgm.fused_first_layer_quant.launches - before
        results[str(device)] = (out.detach(), *(t.grad for t in leaves), launched)
    cpu, card = results['cpu'], results[str(cuda)]
    assert cpu[-1] == 0 and card[-1] == 1
    torch.testing.assert_close(card[0].cpu(), cpu[0], atol=1e-4, rtol=1e-5)
    for name, a, b in zip(('d_tables', 'd_w', 'd_bias', 'd_x'), card[1:5], cpu[1:5]):
        assert _max_rel(a, b) <= 1e-5, name


@pytest.mark.gpu
def test_one_fit_packed_step_on_the_card(cuda):
    """A head trained one step (the whole batch in one minibatch, no eval)
    launches B1 once and B2 fifteen times (the statistics pass), and lands
    within 1e-4 of the same step on the CPU."""
    names, k = XFNS_DEFAULT, 3
    fitted = {}
    for device in ('cpu', cuda):
        batch = synthetic_batch(4, 256, seed=7, device=device)
        y = scores_concedes(batch)[0]
        clf = MLPClassifier(hidden=(32, 16), batch_size=4096, max_epochs=1, device=device)
        b1, b2 = tgm.fused_first_layer_quant.launches, tseg.segment_sum.launches
        clf.fit_packed(batch, y, names=names, k=k)
        fitted[str(device)] = (
            clf,
            tgm.fused_first_layer_quant.launches - b1,
            tseg.segment_sum.launches - b2,
        )
    card, b1, b2 = fitted[str(cuda)]
    assert (b1, b2) == (1, 15)
    assert card.train_health_['finite']
    cpu = fitted['cpu'][0]
    for p, q in zip(card.module.parameters(), cpu.module.parameters()):
        assert float((p.cpu() - q).abs().max()) <= 1e-4


@pytest.mark.gpu
def test_training_is_reproducible_on_the_card(cuda):
    """The table cotangent's row scatter, and so a whole fit, give the same
    bits on every run on the card (8192 rows into 552 buckets, then two
    epochs of a small head)."""
    rng = np.random.default_rng(1)
    g = torch.from_numpy(rng.normal(size=(8192, 128)).astype(np.float32)).to(cuda)
    ids = torch.from_numpy(rng.integers(-1, R + 1, size=8192).astype(np.int32)).to(cuda)
    first = tseg.segment_sum_rows(g, ids, R)
    for _ in range(3):
        assert torch.equal(tseg.segment_sum_rows(g, ids, R), first)
    cpu = tseg.segment_sum_rows(g.cpu(), ids.cpu(), R)
    assert _max_rel(first, cpu) <= 1e-6
    batch = synthetic_batch(4, 256, seed=7, device=cuda)
    y = scores_concedes(batch)[0]
    fits = [
        MLPClassifier(hidden=(32, 16), batch_size=256, max_epochs=2, device=cuda).fit_packed(
            batch, y, names=XFNS_DEFAULT, k=3
        )
        for _ in range(2)
    ]
    for p, q in zip(fits[0].module.parameters(), fits[1].module.parameters()):
        assert torch.equal(p, q)


@pytest.mark.gpu
def test_seq_fit_is_reproducible_on_the_card(cuda):
    """A 64-game fit of the GRU sequence head (default widths, minibatches
    of 8192, 2 epochs) gives the same bits twice on the card: the
    embedding's backward is the fixed-order one-hot row sum; it launches B2
    for the statistics and B1 never."""
    batch = synthetic_batch(64, 1664, seed=5, device=cuda)
    params = {'batch_size': 8192, 'max_epochs': 2, 'learning_rate': 3e-4}
    b1, b2 = tgm.fused_first_layer_quant.launches, tseg.segment_sum.launches
    fits = [
        VAEP(device=cuda).fit_packed(batch, learner='seq', tree_params=params, random_state=0)
        for _ in range(2)
    ]
    assert tgm.fused_first_layer_quant.launches == b1
    assert tseg.segment_sum.launches - b2 == 2 * 15
    for col in ('scores', 'concedes'):
        assert fits[0]._models[col].train_health_['finite']
        for p, q in zip(fits[0]._models[col].module.parameters(), fits[1]._models[col].module.parameters()):
            assert torch.equal(p, q)
