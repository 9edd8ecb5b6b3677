"""The GRU sequence head in one launch (``ops/seq_head.py``, ``csrc/seq_head.cu``).

On the CPU: the dispatch (:func:`~socceraction_tpu_torch.seq.model.seq_train_logits`)
runs the eager head, its three stage spans and its values as before, for
CPU rows and for any call that wants gradients; ``seq/fused_rows`` stays 0
while ``seq/gru_rows`` counts; the wrapper's argument check, which needs no
card, takes every width the repository builds and refuses, naming it, a
width beyond the kernel. The ``gpu`` tests hold the kernel to the eager
head on the card and skip here. The machine with the card has no JAX, and
this module imports none, so it runs there without the suite's conftest:

    python -m pytest tests/test_torch_seq_head.py -m gpu --noconftest -q
"""

import types

import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from socceraction_tpu_torch.core.synthetic import synthetic_batch
from socceraction_tpu_torch.obs import REGISTRY
from socceraction_tpu_torch.ops import fused as tfused
from socceraction_tpu_torch.ops import seq_head as sh
from socceraction_tpu_torch.ops.cuda_build import KernelRefused
from socceraction_tpu_torch.ops.fused import table_lookup
from socceraction_tpu_torch.seq import model as tseq
from socceraction_tpu_torch.seq.classifier import SeqClassifier
from socceraction_tpu_torch.vaep.base import VAEP

K = 3
#: (embed_dim, hidden, readout) of the heads the repository builds: the
#: defaults (the GRU cell, the smoke) and the small test heads; then wider
#: heads the public constructor takes: weights that leave room for three
#: pairs of warps a block, or one, and hidden widths above the tensor-core
#: kernel's 64, which run the general kernel.
WIDTHS = {'default': (32, 64, 64), 'small': (8, 16, 16), 'narrow readout': (8, 16, 8),
          'embed 64': (64, 64, 64), 'readout 256': (32, 64, 256), 'hidden 96': (32, 96, 64),
          'hidden 128': (48, 128, 300)}
#: The most floats one row of the general kernel's tile may take.
ROW_FLOATS = 58104
#: Each family's combined-id table rows and dense columns at k = 3.
FAMILIES = {'standard': (552, 55), 'atomic': (128, 46)}
SEQ_STAGES = ('seq/embed', 'seq/gru', 'seq/readout')


def _head(combo, n_dense, embed_dim, hidden, readout, seed=0, device='cpu'):
    """A seq head with its seeded init and small random biases (the init's
    are zero, which would leave the bias terms untested)."""
    module = tseq.init_seq_params(seed, combo_size=combo, n_dense=n_dense, embed_dim=embed_dim,
                                  hidden=hidden, readout=readout, device='cpu')
    gen = torch.Generator().manual_seed(seed + 100)
    with torch.no_grad():
        for p in module.parameters():
            if p.dim() < 2:
                p.copy_(0.1 * torch.randn(p.shape, generator=gen))
    return module.to(device)


def _rows(n, k, combo, n_dense, seed=0, device='cpu'):
    """Seeded rows ``(x_dense, ids)`` and the dense ``(mean, std)`` they are
    standardized by: columns on their own scales, ids over the whole table."""
    gen = torch.Generator().manual_seed(seed)
    mean = 100 * torch.randn(n_dense, generator=gen)
    std = 0.5 + 20 * torch.rand(n_dense, generator=gen)
    x = mean + std * torch.randn(n, n_dense, generator=gen)
    ids = torch.randint(0, combo, (n, k), generator=gen, dtype=torch.int32)
    return tuple(t.to(device) for t in (x, ids, mean, std))


def _eager(module, x, ids, mean, std):
    """The eager head, step by step, as ``seq_train_logits`` ran it before
    the kernel."""
    emb = table_lookup(module.embed, ids, int(module.embed.shape[0]))
    return tseq._readout(module, tseq._gru_pass(module, emb), x, mean, std)


# -- the dispatch on the CPU ---------------------------------------------------------------


def _seq_model(widths=WIDTHS['small']):
    """A VAEP of two seq heads, seeded, with the statistics of 4 seeded games."""
    batch = synthetic_batch(4, 128, fill=0.8, seed=5, device='cpu')
    states, layout = tfused.build_train_states(batch, names=VAEP._default_xfns, k=K)
    mean, std = tfused.packed_feature_stats(states, layout)
    heads = {}
    embed_dim, hidden, readout = widths
    for seed, col in enumerate(('scores', 'concedes')):
        clf = SeqClassifier(embed_dim=embed_dim, hidden=hidden, readout=readout, seed=seed,
                            device='cpu')
        clf.module = clf.init_params(layout)
        clf.mean_, clf.std_ = mean, torch.where(std > 0, std, 1.0)
        heads[col] = clf
    return VAEP(models=heads, device='cpu'), states, layout


@pytest.mark.parametrize('family', sorted(FAMILIES))
def test_a_cpu_call_runs_the_eager_head_in_its_three_spans(family):
    """``seq_train_logits`` on CPU rows: the embedding, the recurrence and
    the readout each in its span, in order, values bitwise the eager
    steps', and no launch."""
    combo, n_dense = FAMILIES[family]
    module = _head(combo, n_dense, *WIDTHS['default'])
    x, ids, mean, std = _rows(300, K, combo, n_dense, seed=1)
    layout = types.SimpleNamespace(registry=types.SimpleNamespace(combo_size=combo),
                                   n_dense=n_dense, spans=(('dense', 'dense', 0, n_dense),))
    launches = sh.seq_head.launches
    with torch.no_grad(), profile(activities=[ProfilerActivity.CPU]) as prof:
        got = tseq.seq_train_logits(module, x, ids, layout=layout, mean=mean, std=std)
    names = [e.name for e in prof.events() if e.name in SEQ_STAGES]
    assert names == list(SEQ_STAGES)
    with torch.no_grad():
        want = _eager(module, x, ids, mean, std)
    assert torch.equal(got, want)
    assert sh.seq_head.launches == launches


def _card_rows(requires_grad=False):
    """A stand-in for card rows: the dispatch reads only their device and
    whether they require a gradient, so no card is needed."""
    return types.SimpleNamespace(device=torch.device('cuda', 0), requires_grad=requires_grad)


@pytest.mark.parametrize('grad_mode, frozen, rows_grad, want', [
    (False, False, False, True),   # rating: no_grad
    (True, False, False, False),   # training: the parameters want gradients
    (True, True, True, False),     # the rows want one
    (True, True, False, True),     # grad mode on, but nothing requires one
])
def test_a_call_that_needs_gradients_never_reaches_the_kernel(grad_mode, frozen, rows_grad, want):
    module = _head(40, 5, *WIDTHS['small'])
    if frozen:
        module.requires_grad_(False)
    with torch.set_grad_enabled(grad_mode):
        assert tseq.on_kernel(module, _card_rows(rows_grad)) is want
        # CPU rows never do
        assert tseq.on_kernel(module, torch.zeros(2, 5)) is False


def test_training_runs_the_eager_head(monkeypatch):
    """A seq fit's loss is ``seq_logits``, which has no kernel branch: a
    kernel that raises is never called."""
    def refuse(*args, **kwargs):
        raise AssertionError('the kernel ran under a fit')

    monkeypatch.setattr(tseq, 'seq_head', refuse)
    batch = synthetic_batch(4, 128, fill=0.8, seed=3, device='cpu')
    model = VAEP(device='cpu').fit_packed(
        batch, learner='seq', random_state=0,
        tree_params={'embed_dim': 8, 'hidden': 16, 'readout': 16, 'batch_size': 256,
                     'max_epochs': 1},
    )
    assert model._rating_path() == 'seq'


def test_fused_rows_stay_zero_on_the_cpu_while_gru_rows_count():
    model, _, _ = _seq_model()
    batch = synthetic_batch(3, 128, fill=0.8, seed=13, device='cpu')

    def counts():
        snap = REGISTRY.snapshot()
        return (snap.value('seq/gru_rows', platform='cpu'),
                snap.value('seq/fused_rows', platform='cpu'),
                snap.value('seq/fused_rows', stat='count', platform='cpu'))

    before = counts()
    model.rate_batch(batch)
    rows, fused, calls = (a - b for a, b in zip(counts(), before))
    assert rows == 4 * 128  # 3 games padded to their bucket of 4
    assert fused == 0 and calls == 1  # the series is there, and reads 0


def test_predict_proba_states_on_the_cpu_is_the_eager_head():
    model, states, layout = _seq_model()
    clf = model._models['scores']
    launches = sh.seq_head.launches
    got = clf.predict_proba_states(states, layout)
    with torch.no_grad():
        dm, ds = tseq.dense_stats(clf.mean_, clf.std_, layout)
        want = torch.sigmoid(_eager(clf.module, states.x_dense, states.combo_ids, dm, ds))
    assert torch.equal(got, want)
    assert sh.seq_head.launches == launches


# -- the wrapper's argument check (no card needed) --------------------------------------------


@pytest.mark.parametrize('family', sorted(FAMILIES))
@pytest.mark.parametrize('widths', sorted(WIDTHS))
@pytest.mark.parametrize('k', [1, 3, 4])
def test_the_check_takes_every_width_the_repository_builds(family, widths, k):
    _, n_dense = FAMILIES[family]
    embed_dim, hidden, readout = WIDTHS[widths]
    assert sh.check_widths(embed_dim=embed_dim, hidden=hidden, n_dense=n_dense,
                           readout=readout, k=k) is None


@pytest.mark.parametrize('part, more', [('embed_dim', 4), ('hidden', 12), ('n_dense', 4), ('k', 1)])
def test_the_limit_is_one_row_of_the_general_kernels_tile(part, more):
    """``embed_dim``, ``3·hidden`` and ``n_dense``, each rounded up to 4
    floats, and ``k`` a row: at the limit the head runs; one more of any
    width, which adds its rounded floats, is refused."""
    widths = dict(embed_dim=ROW_FLOATS - (3 * 19000 + 56 + 4), hidden=19000, n_dense=56,
                  readout=64, k=4)
    assert sh.check_widths(**widths) is None
    widths[part] += 1
    with pytest.raises(KernelRefused, match=f'takes {ROW_FLOATS + more} floats'):
        sh.check_widths(**widths)


def _stand_in(**widths):
    """A stand-in head whose widths are read before any parameter: a head
    this wide would not fit this machine's memory."""
    dims = dict(combo_size=552, embed_dim=32, hidden=64, n_dense=55, readout=64)
    dims.update(widths)
    return types.SimpleNamespace(dims=lambda: dims)


@pytest.mark.parametrize('widths, match', [
    (dict(hidden=19400), r'hidden = 19400.*takes 58291 floats'),
    (dict(embed_dim=60000), r'embed_dim = 60000.*takes 60251 floats'),
    (dict(hidden=0), r'hidden >= 1, got 0'),
    (dict(readout=0), r'readout >= 1, got 0'),
])
def test_a_width_beyond_the_kernel_is_refused_naming_it(widths, match):
    """Through the wrapper itself, on CPU rows: the widths are checked
    before the rows and the device."""
    combo, n_dense = FAMILIES['standard']
    x, ids, mean, std = _rows(10, K, combo, n_dense)
    with pytest.raises(KernelRefused, match=match):
        sh.seq_head(_stand_in(**widths), x, ids, mean, std)


def test_k_and_the_rows_shape_are_checked_before_the_device():
    combo, n_dense = FAMILIES['standard']
    module = _head(combo, n_dense, *WIDTHS['small'])
    x, ids, mean, std = _rows(10, K, combo, n_dense)
    with pytest.raises(KernelRefused, match='k >= 1'):
        sh.seq_head(module, x, ids[:, :0], mean, std)
    with pytest.raises(KernelRefused, match=r'x_dense as \(10, 55\)'):
        sh.seq_head(module, x[:, 1:], ids, mean, std)
    with pytest.raises(KernelRefused, match='no kernel for device cpu'):
        sh.seq_head(module, x, ids, mean, std)


# -- the kernel on the card ----------------------------------------------------------------


@pytest.fixture
def cuda():
    """The card, or a skip where there is none (decided per test, not at
    import, so every worker collects the same tests). Products in full
    float32, as the cells run them."""
    if not torch.cuda.is_available():
        pytest.skip('needs a CUDA card')
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device('cuda', 0)


def _card_cases():
    cases = []
    for family in sorted(FAMILIES):
        cases += [
            (family, 'default', 3, 1024 * 1664),  # a season chunk, as the GRU cell rates it
            (family, 'default', 3, 1000),         # ragged: not a multiple of the 128-row tile
            (family, 'default', 1, 333),
            (family, 'default', 4, 129),
            (family, 'small', 3, 4 * 256),        # the small test heads
            (family, 'narrow readout', 4, 1),
            (family, 'embed 64', 3, 5000),        # three pairs of warps a block
            (family, 'readout 256', 3, 1000),     # one pair
            (family, 'hidden 96', 3, 1003),       # the general kernel, 16-row tiles
            (family, 'hidden 128', 4, 77),
        ]
    return cases


@pytest.mark.gpu
@pytest.mark.parametrize('family, widths, k, n', _card_cases())
def test_kernel_matches_the_eager_head(cuda, family, widths, k, n):
    """The kernel against the eager head on the card, both in float32, and
    each against the eager head in float64.

    Tolerance: the kernel sums its products in another order than cuBLAS
    and contracts them into FMAs, so its logits are not the eager bits.
    Its largest error against float64 stays within twice the eager float32
    head's own, plus 1e-6 (logits of magnitude up to about 10, float32
    rounding about 1e-6 there), and the two float32 heads within 1e-5 of
    each other; a wrong gate, order or bias would be off by 1e-2 or more.
    """
    combo, n_dense = FAMILIES[family]
    module = _head(combo, n_dense, *WIDTHS[widths], seed=n % 97, device=cuda)
    x, ids, mean, std = _rows(n, k, combo, n_dense, seed=n + k, device=cuda)
    before = sh.seq_head.launches
    with torch.no_grad():
        got = sh.seq_head(module, x, ids, mean, std)
        want = _eager(module, x, ids, mean, std)
        exact = _eager(module.double(), x.double(), ids, mean.double(), std.double())
    torch.cuda.synchronize()
    assert sh.seq_head.launches == before + 1
    assert got.shape == (n,) and bool(torch.isfinite(got).all())
    kernel_err = (got.double() - exact).abs().max().item()
    eager_err = (want.double() - exact).abs().max().item()
    assert kernel_err <= 2 * eager_err + 1e-6, (kernel_err, eager_err)
    assert (got - want).abs().max().item() <= 1e-5


@pytest.mark.gpu
@pytest.mark.parametrize('embed_dim, hidden, readout, k, n', [
    (16, 2000, 16, 2, 9),   # 4-row tiles
    (15000, 8, 8, 1, 5),    # 1-row tiles
])
def test_the_general_kernel_at_widths_far_beyond_the_cells(cuda, embed_dim, hidden, readout, k, n):
    """Widths whose tiles hold 4 rows or 1, as ``test_kernel_matches_the_eager_head``
    holds the others: within twice the eager float32 head's error against
    float64, plus 1e-6, and 1e-5 of the eager head."""
    combo, n_dense = FAMILIES['standard']
    module = _head(combo, n_dense, embed_dim, hidden, readout, seed=k, device=cuda)
    x, ids, mean, std = _rows(n, k, combo, n_dense, seed=n, device=cuda)
    with torch.no_grad():
        got = sh.seq_head(module, x, ids, mean, std)
        want = _eager(module, x, ids, mean, std)
        exact = _eager(module.double(), x.double(), ids, mean.double(), std.double())
    kernel_err = (got.double() - exact).abs().max().item()
    eager_err = (want.double() - exact).abs().max().item()
    assert kernel_err <= 2 * eager_err + 1e-6, (kernel_err, eager_err)
    assert (got - want).abs().max().item() <= 1e-5


@pytest.mark.gpu
def test_a_fit_on_the_card_refuses_a_head_the_kernel_cannot_run(cuda):
    """Before it builds the head or trains: the card would rate it through
    the kernel."""
    batch = synthetic_batch(2, 64, fill=0.8, seed=3, device=cuda)
    states, _ = tfused.build_train_states(batch, names=VAEP._default_xfns, k=K)
    clf = SeqClassifier(hidden=19400, device=cuda)
    with pytest.raises(KernelRefused, match='hidden = 19400'):
        clf.fit_packed(batch, torch.zeros(states.weight.shape[0], device=cuda),
                       names=VAEP._default_xfns, k=K)
    assert clf.module is None


@pytest.mark.gpu
def test_an_id_outside_the_table_reads_nan_in_its_row_alone(cuda):
    combo, n_dense = FAMILIES['standard']
    module = _head(combo, n_dense, *WIDTHS['default'], device=cuda)
    x, ids, mean, std = _rows(300, K, combo, n_dense, seed=3, device=cuda)
    with torch.no_grad():
        want = sh.seq_head(module, x, ids, mean, std)
        ids[7, 1] = combo
        got = sh.seq_head(module, x, ids, mean, std)
    assert bool(torch.isnan(got[7]))
    keep = torch.arange(300, device=cuda) != 7
    assert torch.equal(got[keep], want[keep])


@pytest.mark.gpu
def test_a_nonfinite_input_or_weight_reads_nan(cuda):
    """A NaN or infinite dense value makes its row's logit NaN, and no
    other's; a weight that is not finite makes every logit NaN (the eager
    head's are not finite either)."""
    combo, n_dense = FAMILIES['standard']
    module = _head(combo, n_dense, *WIDTHS['default'], device=cuda)
    x, ids, mean, std = _rows(300, K, combo, n_dense, seed=4, device=cuda)
    with torch.no_grad():
        want = sh.seq_head(module, x, ids, mean, std)
        x[11, 3], x[200, 0] = float('nan'), float('inf')
        got = sh.seq_head(module, x, ids, mean, std)
        bad = torch.zeros(300, dtype=torch.bool, device=cuda)
        bad[[11, 200]] = True
        assert bool(torch.isnan(got[bad]).all()) and torch.equal(got[~bad], want[~bad])
        module.gru.uh[5, 7] = float('nan')
        assert bool(torch.isnan(sh.seq_head(module, x, ids, mean, std)).all())


@pytest.mark.gpu
def test_refused_operands_on_the_card(cuda):
    combo, n_dense = FAMILIES['standard']
    module = _head(combo, n_dense, *WIDTHS['small'], device=cuda)
    x, ids, mean, std = _rows(64, K, combo, n_dense, device=cuda)
    with pytest.raises(KernelRefused, match='int32 ids'):
        sh.seq_head(module, x, ids.long(), mean, std)
    with pytest.raises(KernelRefused, match='float32 rows'):
        sh.seq_head(module, x.double(), ids, mean, std)
    with pytest.raises(KernelRefused, match='every operand on cuda'):
        sh.seq_head(module, x, ids, mean.cpu(), std)


def _card_model(device):
    batch = synthetic_batch(4, 256, fill=0.8, seed=5, device=device)
    states, layout = tfused.build_train_states(batch, names=VAEP._default_xfns, k=K)
    mean, std = tfused.packed_feature_stats(states, layout)
    heads = {}
    for seed, col in enumerate(('scores', 'concedes')):
        clf = SeqClassifier(seed=seed, device=device)
        clf.module = clf.init_params(layout)
        clf.mean_, clf.std_ = mean, torch.where(std > 0, std, 1.0)
        heads[col] = clf
    return VAEP(models=heads, device=device), states, layout


@pytest.mark.gpu
def test_launches_a_seq_pair_rate_batch_and_a_predict_proba_states(cuda):
    """Two launches a seq pair's ``rate_batch`` (one a head), every row of
    the recurrence through the kernel, one a ``predict_proba_states``;
    the rated values within 1e-6 of the eager heads' (probabilities)."""
    model, states, layout = _card_model(cuda)
    batch = synthetic_batch(6, 256, fill=0.8, seed=8, device=cuda)

    def counts():
        snap = REGISTRY.snapshot()
        return (snap.value('seq/gru_rows', platform='cuda'),
                snap.value('seq/fused_rows', platform='cuda'))

    before, launches = counts(), sh.seq_head.launches
    values = model.rate_batch(batch)
    torch.cuda.synchronize()
    rows, fused = (a - b for a, b in zip(counts(), before))
    assert sh.seq_head.launches == launches + 2
    assert rows == fused == 8 * 256  # 6 games padded to their bucket of 8
    clf = model._models['scores']
    got = clf.predict_proba_states(states, layout)
    assert sh.seq_head.launches == launches + 3
    with torch.no_grad():
        dm, ds = tseq.dense_stats(clf.mean_, clf.std_, layout)
        want = torch.sigmoid(_eager(clf.module, states.x_dense, states.combo_ids, dm, ds))
    assert (got - want).abs().max().item() <= 1e-6
    assert values.shape == (6, 256, 3) and bool(torch.isfinite(values[batch.mask]).all())


@pytest.mark.gpu
def test_training_on_the_card_stays_eager(cuda):
    """A loss under autograd runs the eager steps (gradients flow into
    every parameter) and launches nothing."""
    combo, n_dense = FAMILIES['standard']
    module = _head(combo, n_dense, *WIDTHS['small'], device=cuda)
    x, ids, mean, std = _rows(512, K, combo, n_dense, device=cuda)
    launches = sh.seq_head.launches
    tseq.seq_logits(module, x, ids, dense_mean=mean, dense_std=std).square().mean().backward()
    assert sh.seq_head.launches == launches
    assert all(p.grad is not None for p in module.parameters())
