"""The rating dispatch's entries and the learning statistics on the card.

Every test here needs a CUDA card and skips without one; the machine with
the card has no JAX, so this file imports none, and runs without the
suite's conftest:

    python -m pytest tests/test_torch_rating_card.py -m gpu --noconftest -q
"""

import numpy as np
import pytest
import torch

from socceraction_tpu_torch.core.synthetic import synthetic_batch
from socceraction_tpu_torch.learn import DriftConfig, DriftWatch, calibration_summary, reliability_curve
from socceraction_tpu_torch.ml.mlp import MLP, MLPClassifier
from socceraction_tpu_torch.ops import fused as tfused
from socceraction_tpu_torch.ops import gather_matmul as tgm
from socceraction_tpu_torch.ops import segment as tseg
from socceraction_tpu_torch.vaep.base import VAEP, XFNS_DEFAULT

K = 3


@pytest.fixture
def cuda():
    """The card, or a skip where there is none (decided per test, not at
    import, so every worker collects the same tests)."""
    if not torch.cuda.is_available():
        pytest.skip('needs a CUDA card')
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device('cuda')


def _launches(device):
    """One kernel launch on the card; none where a wrapper runs its plain
    version (a rehearsal of these tests on the CPU)."""
    return 1 if device.type == 'cuda' else 0


def _head(seed, feats, mask, hidden=(128, 64)):
    """An MLP head of seeded weights on the device of ``feats``, with the
    statistics of the valid rows of ``feats``."""
    x = feats[mask].double()
    mean, std = x.mean(0).float(), x.std(0, unbiased=False).float()
    std = torch.where(std > 0, std, 1.0)
    gen = torch.Generator().manual_seed(seed)
    module = MLP(feats.shape[-1], hidden)
    with torch.no_grad():
        for layer in module.layers():
            layer.weight.copy_(torch.randn(layer.weight.shape, generator=gen) * layer.in_features ** -0.5)
            layer.bias.copy_(torch.randn(layer.bias.shape, generator=gen) * 0.1)
    return MLPClassifier.from_module(module.to(feats.device), mean, std)


@pytest.mark.gpu
def test_fused_logit_entries_on_the_card(cuda):
    """fused_mlp_logits and fused_pair_logits at 64 games x 1664 actions:
    one launch of B1 each, and the logits within 1e-4 of the plain
    composition on the card (the head on standardized features; B1 sums
    the dense product in 3xTF32)."""
    batch = synthetic_batch(64, 1664, seed=4, device=cuda)
    feats = VAEP(device=cuda).compute_features_batch(batch)
    mask = batch.mask
    heads = [_head(seed, feats, mask) for seed in (1, 2)]
    plain = [clf.module((feats - clf.mean_) / clf.std_) for clf in heads]
    tgm.fused_first_layer_quant.launches = 0
    got = tfused.fused_mlp_logits(heads[0].module, batch, names=XFNS_DEFAULT, k=K,
                                  mean=heads[0].mean_, std=heads[0].std_)
    assert tgm.fused_first_layer_quant.launches == _launches(cuda)
    torch.testing.assert_close(got[mask], plain[0][mask], atol=1e-4, rtol=0)
    tgm.fused_first_layer_quant.launches = 0
    pair = tfused.fused_pair_logits(
        heads[0].module, heads[1].module, batch, names=XFNS_DEFAULT, k=K,
        mean_a=heads[0].mean_, std_a=heads[0].std_, mean_b=heads[1].mean_, std_b=heads[1].std_,
    )
    assert tgm.fused_first_layer_quant.launches == _launches(cuda)
    for g, p in zip(pair, plain):
        torch.testing.assert_close(g[mask], p[mask], atol=1e-4, rtol=0)
    tgm.fused_first_layer_quant.launches = 0
    probs = heads[0].predict_proba_device_batch(batch, names=XFNS_DEFAULT, k=K)
    assert tgm.fused_first_layer_quant.launches == _launches(cuda)
    torch.testing.assert_close(probs[mask], torch.sigmoid(plain[0])[mask], atol=1e-5, rtol=0)


@pytest.mark.gpu
def test_calibration_and_drift_counts_on_the_card(cuda):
    """Bin counts of the card's B2 launches equal the CPU's bitwise (0/1
    weights), the binned means within 1e-5 relative; ECE, Brier and the
    bootstrap's intervals (drawn on the CPU) within 1e-6 of the CPU's run;
    drift edges and proportions bitwise."""
    rng = np.random.default_rng(0)
    n = 200_000
    p = rng.uniform(0, 1, n).astype(np.float32)
    y = (rng.uniform(0, 1, n) < p).astype(np.float32)
    w = (rng.uniform(0, 1, n) < 0.9).astype(np.float32)
    tseg.segment_sum.launches = 0
    card = reliability_curve(*(torch.from_numpy(a).to(cuda) for a in (p, y, w)))
    assert tseg.segment_sum.launches == _launches(cuda)
    cpu = reliability_curve(p, y, w, device='cpu')
    np.testing.assert_array_equal(card[2], cpu[2])
    # confidence and accuracy are sums of about 18,000 f32 values a bin,
    # which the CPU adds in sequence and the card with atomics in another
    # order: measured 2.7e-6 relative apart (NVIDIA H100 80GB HBM3)
    for g, c in zip(card[:2], cpu[:2]):
        np.testing.assert_allclose(g, c, rtol=1e-5, atol=0)
    s_card = calibration_summary(*(torch.from_numpy(a).to(cuda) for a in (p, y, w)), n_boot=50)
    s_cpu = calibration_summary(p, y, w, n_boot=50, device='cpu')
    assert s_card.n == s_cpu.n
    for key in ('ece', 'brier', 'brier_reliability', 'brier_resolution', 'brier_uncertainty'):
        assert abs(getattr(s_card, key) - getattr(s_cpu, key)) <= 1e-6, key
    np.testing.assert_allclose(s_card.ece_ci + s_card.brier_ci, s_cpu.ece_ci + s_cpu.brier_ci,
                               rtol=0, atol=1e-6)
    batch = synthetic_batch(32, 1664, seed=7, device=cuda)
    cfg = DriftConfig(include_predictions=False)
    tseg.segment_sum.launches = 0
    on_card = DriftWatch.from_batch(None, batch, cfg).reference
    assert tseg.segment_sum.launches == _launches(cuda)
    on_cpu = DriftWatch.from_batch(None, batch.to('cpu'), cfg).reference
    for name in ('lo', 'hi', 'props'):
        np.testing.assert_array_equal(getattr(on_card, name), getattr(on_cpu, name))
