"""The port's numeric guards against the JAX package's.

A JAX model of each family (standard and atomic MLP heads, standard seq
heads) gets seeded numpy weights, clean or with a planted fault: a NaN in
one first-layer weight (seq: in the readout), or an output layer scaled
so that logits pass 88. It moves into the port through the JAX package's
checkpoint. Both packages rate the same three games (bucketed to four,
the padding counted as the JAX package counts it) and drain their guards
once the values are on the host: the drained events must be equal,
exactly. The guarded values must be bitwise those of
``SOCCERACTION_TPU_NUM_GUARDS=0``. The pending ring's drops and the
host-side ``record_nonfinite`` of xT and training are held to the JAX
package's on the same inputs.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from socceraction_tpu.atomic.vaep.base import AtomicVAEP as JaxAtomicVAEP
from socceraction_tpu.core.synthetic import synthetic_batch as jax_synthetic_batch
from socceraction_tpu.ml import mlp as jmlp
from socceraction_tpu.obs import metrics as jmetrics
from socceraction_tpu.obs import numerics as jnumerics
from socceraction_tpu.ops import fused as jfused
from socceraction_tpu.ops import xt as jxt
from socceraction_tpu.seq import classifier as jclassifier
from socceraction_tpu.vaep.base import VAEP as JaxVAEP
from socceraction_tpu.xthreat import ExpectedThreat as JaxExpectedThreat
from socceraction_tpu_torch import convert
from socceraction_tpu_torch.core.synthetic import synthetic_batch
from socceraction_tpu_torch.ml import mlp as tmlp
from socceraction_tpu_torch.obs import metrics as tmetrics
from socceraction_tpu_torch.obs import numerics as tnumerics
from socceraction_tpu_torch.ops import xt as txt
from socceraction_tpu_torch.vaep.base import XFNS_DEFAULT, load_model
from socceraction_tpu_torch.xthreat import ExpectedThreat
from tests.test_torch_atomic import atomic_batches
from tests.test_torch_seq import SEQ
from tests.test_torch_seq import _jax_params as _jax_seq_params
from tests.test_torch_seq import _stats as _seq_stats

N_FEATURES = {'standard': 568, 'atomic': 154}
HIDDEN = (16,)


@pytest.fixture(scope='module', autouse=True)
def _drain_storm_windows():
    """Retire this module's compiles from the JAX compile observatory's
    storm window (as tests/test_torch_vaep.py does)."""
    yield
    from socceraction_tpu.ops.fused import _pair_probs, _pair_probs_prepared
    from socceraction_tpu.seq import model as jseq

    for fn in (_pair_probs, _pair_probs_prepared, jseq._seq_pair_fn):
        fn.drain_storm_window()


def _batches(family):
    """Three ragged games of the family in both packages (bucket of 4)."""
    if family == 'atomic':
        return atomic_batches((256, 200, 90), seed=4)
    args = dict(fill=0.8, seed=4)
    return jax_synthetic_batch(3, 256, **args), synthetic_batch(3, 256, device='cpu', **args)


def _mlp_params(n_features, seed):
    rng = np.random.default_rng(seed)
    widths = (n_features, *HIDDEN, 1)
    return {'params': {
        f'Dense_{i}': {
            'kernel': rng.normal(0, widths[i] ** -0.5, (widths[i], widths[i + 1])).astype(np.float32),
            'bias': rng.normal(0, 0.1, widths[i + 1]).astype(np.float32),
        }
        for i in range(len(widths) - 1)
    }}


def _plant(params, plant, first, last):
    """A NaN in ``first[0][0]``, or the ``last`` layer scaled by 1e4."""
    params = jax.tree.map(np.array, params)  # writable copies
    if plant == 'nan':
        params[first[0]][first[1]][0, 0] = np.nan
    elif plant == 'overflow':
        for name in last:
            params[name[0]][name[1]] *= np.float32(1e4)
    return params


def _models(family, plant, tmp_path):
    """(JAX model, the port's model loaded from its checkpoint); the
    scores head carries the planted fault. Statistics are the features'
    own (a realistic head: clean logits stay well inside 88)."""
    jb, _ = _batches('atomic' if family == 'atomic' else 'standard')
    if family == 'seq':
        jmodel = JaxVAEP()
        mean, std = _seq_stats(*jfused.build_train_states(
            jb, names=XFNS_DEFAULT, k=3, registry_name='standard'))
        for seed, col in ((0, 'scores'), (9, 'concedes')):
            params = _jax_seq_params(jfused.REGISTRIES['standard'], 55, seed=seed)
            if col == 'scores':
                params = _plant(params, plant, ('readout', 'w1'),
                                (('readout', 'w2'), ('readout', 'b2')))
            clf = jclassifier.SeqClassifier(**SEQ)
            clf.params = jax.tree.map(jnp.asarray, params)
            clf.mean_, clf.std_ = mean, std
            jmodel._models[col] = clf
    else:
        jmodel = (JaxAtomicVAEP if family == 'atomic' else JaxVAEP)()
        X = np.asarray(jmodel.compute_features_batch(jb)).reshape(-1, N_FEATURES[family])
        mean = X.mean(axis=0).astype(np.float32)
        std = np.where(X.std(axis=0) > 0, X.std(axis=0), 1.0).astype(np.float32)
        for seed, col in enumerate(('scores', 'concedes')):
            params = _mlp_params(N_FEATURES[family], 40 + seed)['params']
            if col == 'scores':
                params = _plant(params, plant, ('Dense_0', 'kernel'),
                                (('Dense_1', 'kernel'), ('Dense_1', 'bias')))
            clf = jmlp.MLPClassifier(hidden=HIDDEN)
            clf.params = {'params': {
                layer: {k: jnp.asarray(a) for k, a in leaves.items()}
                for layer, leaves in params.items()
            }}
            clf.mean_, clf.std_ = mean, std
            jmodel._models[col] = clf
    jmodel.save_model(str(tmp_path))
    return jmodel, load_model(str(tmp_path), device='cpu')


def _drained(numerics, rate, batch):
    """Rate ``batch``, bring the values to the host, drain: the events."""
    numerics.clear_pending()
    values = np.asarray(rate(batch))
    events = sorted(tuple(e) for e in numerics.drain_guards())
    assert numerics.pending_guards() == 0
    return values, events


@pytest.mark.parametrize('plant', ['clean', 'nan', 'overflow'])
@pytest.mark.parametrize('family', ['standard', 'atomic', 'seq'])
def test_guard_counts_match_jax(family, plant, tmp_path):
    """Drained guard events of ``rate_batch`` equal the JAX package's,
    count for count, and the guarded values are bitwise the unguarded."""
    jmodel, model = _models(family, plant, tmp_path)
    jb, tb = _batches('atomic' if family == 'atomic' else 'standard')
    _, want = _drained(jnumerics, jmodel.rate_batch, jb)
    values, got = _drained(tnumerics, model.rate_batch, tb)
    assert got == want
    fn = 'seq_pair_probs' if family == 'seq' else 'pair_probs'
    rows = 4 * 256  # the bucket of four games is counted, padding included
    by_kind = {(e[1], e[2]): e[3] for e in got}
    assert {e[0] for e in got} <= {fn}
    if plant == 'clean':
        assert got == []
    elif plant == 'nan':
        # a NaN weight reaches every row of the planted head
        assert by_kind == {('probs', 'nonfinite'): rows}
    elif family == 'seq':
        # saturated logits serve finite 0/1: the seq guard counts nothing
        assert got == []
    else:
        assert set(by_kind) == {('logits', 'overflow')}
        assert rows // 2 < by_kind['logits', 'overflow'] <= rows
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv('SOCCERACTION_TPU_NUM_GUARDS', '0')
        tnumerics.clear_pending()
        unguarded = model.rate_batch(tb)
        # the MLP dispatch drops its guards; the seq dispatch counts
        # whatever the flag says, as the JAX package's does
        assert tnumerics.pending_guards() == (1 if family == 'seq' else 0)
    np.testing.assert_array_equal(unguarded.numpy(), values)
    assert unguarded.numpy().tobytes() == values.tobytes()


def test_guard_counts_are_device_tensors_left_on_the_stream():
    """The reductions give 0-d int32 tensors; ``note_guard`` reads nothing
    (an entry holds the tensor until a drain)."""
    a = torch.tensor([1.0, float('nan'), float('inf'), -100.0])
    b = torch.tensor([[90.0, -float('inf')]])
    n, o = tnumerics.nonfinite_count(a, b), tnumerics.overflow_count(a, b)
    assert n.dtype == o.dtype == torch.int32 and n.dim() == o.dim() == 0
    assert (int(n), int(o)) == (3, 4)
    jn = jnumerics.nonfinite_count(jnp.asarray(a.numpy()), jnp.asarray(b.numpy()))
    jo = jnumerics.overflow_count(jnp.asarray(a.numpy()), jnp.asarray(b.numpy()))
    assert (int(jn), int(jo)) == (3, 4)
    tnumerics.clear_pending()
    tnumerics.note_guard('probe', 'x', n)
    assert tnumerics._PENDING._ring[0][3] is n
    tnumerics.clear_pending()


def test_pending_ring_counts_drops_like_jax():
    """A full ring evicts its oldest entry and counts the drop; the drain
    records the rest, in the JAX package's events and counters."""
    out = {}
    for name, (numerics, metrics, make) in {
        'jax': (jnumerics, jmetrics, lambda v: jnp.int32(v)),
        'torch': (tnumerics, tmetrics, lambda v: torch.tensor(v, dtype=torch.int32)),
    }.items():
        metrics.REGISTRY.reset()
        ring = numerics._PendingGuards(capacity=3)
        for i, v in enumerate((0, 5, 0, 2, 7)):
            ring.note('probe', f'out{i}', 'overflow' if i == 4 else 'nonfinite', make(v))
        events = ring.drain()
        snap = metrics.REGISTRY.snapshot()
        out[name] = (
            ring.dropped, len(ring), [tuple(e) for e in events],
            snap.value('num/guard_drops'),
            snap.value('num/nonfinite_total', fn='probe', output='out3'),
            snap.value('num/overflow_guard_total', fn='probe'),
        )
    assert out['torch'] == out['jax']
    assert out['torch'][0] == 2 and out['torch'][2] == [
        ('probe', 'out3', 'nonfinite', 2), ('probe', 'out4', 'overflow', 7),
    ]


def _poison(module, lib):
    """``module.solve_xt`` with a NaN planted in the surface's first cell."""
    solve = module.solve_xt

    def poisoned(*args, **kwargs):
        sol = solve(*args, **kwargs)
        grid = sol.grid
        if lib == 'jax':
            grid = grid.at[0, 0].set(jnp.nan)
        else:
            grid = grid.clone()
            grid[0, 0] = float('nan')
        return sol._replace(grid=grid)

    return poisoned


def test_xt_certificate_guard_matches_jax(monkeypatch):
    """A clean fit records nothing; a NaN planted in the solved surface is
    counted under ``num/nonfinite_total{fn=solve_xt, output=grid}`` by
    both packages."""
    jb = jax_synthetic_batch(3, 256, seed=2)
    tb = synthetic_batch(3, 256, seed=2, device='cpu')
    out = {}
    for poison in (False, True):
        for name, (metrics, module, fit) in {
            'jax': (jmetrics, jxt, lambda: JaxExpectedThreat(backend='jax').fit(jb)),
            'torch': (tmetrics, txt, lambda: ExpectedThreat(device='cpu').fit(tb)),
        }.items():
            metrics.REGISTRY.reset()
            if poison:
                monkeypatch.setattr(module, 'solve_xt', _poison(module, name))
            fit()
            snap = metrics.REGISTRY.snapshot().get('num/nonfinite_total')
            out[name, poison] = sorted(
                (tuple(sorted(s.labels.items())), s.total) for s in snap.series if s.count
            ) if snap else []
    assert out['torch', False] == out['jax', False] == []
    assert out['torch', True] == out['jax', True] == [
        ((('fn', 'solve_xt'), ('output', 'grid')), 1.0)
    ]


def test_training_nonfinite_guard_matches_jax():
    """A warm start from NaN weights: every step is non-finite in both
    packages, counted into ``train/nonfinite_loss`` and
    ``num/nonfinite_total{fn=train_epoch, output=loss}``."""
    jb = jax_synthetic_batch(2, 256, seed=6)
    tb = synthetic_batch(2, 256, seed=6, device='cpu')
    y = np.random.default_rng(1).integers(0, 2, size=(2, 256)).astype(np.float32)
    params = _mlp_params(568, 3)
    params['params']['Dense_0']['kernel'][0, 0] = np.nan
    hyper = dict(hidden=HIDDEN, batch_size=256, max_epochs=2)
    jparams = jax.tree.map(jnp.asarray, params)
    out = {}
    for name, (metrics, fit) in {
        'jax': (jmetrics, lambda: jmlp.MLPClassifier(**hyper).fit_packed(
            jb, y, names=tuple(XFNS_DEFAULT), k=3, init_params=jparams)),
        'torch': (tmetrics, lambda: tmlp.MLPClassifier(**hyper, device='cpu').fit_packed(
            tb, y, names=XFNS_DEFAULT, k=3, init_params=convert.module_from_jax_params(params))),
    }.items():
        metrics.REGISTRY.reset()
        clf = fit()
        snap = metrics.REGISTRY.snapshot()
        out[name] = (
            clf.train_health_['finite'], clf.train_health_['nonfinite_steps'],
            snap.value('train/nonfinite_loss', path='fused', platform='cpu'),
            snap.value('num/nonfinite_total', fn='train_epoch', output='loss'),
        )
    assert out['torch'] == out['jax'] == (False, 4, 4, 4)
