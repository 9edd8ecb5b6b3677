"""The port's sequence parallelism against the JAX package's, on the CPU.

The counterpart of ``tests/test_sequence_parallel.py``, for both action
families. The port runs in 4 gloo ranks as a ``(games, seq) = (2, 2)``
mesh (``tests/torch_parallel_worker.py``, one spawn with its own time
limit and a file store under the test's temporary directory); the JAX
package runs on its own ``(2, 4)`` mesh of the 8 virtual CPU devices.
Each rank returns its ``(game, action)`` block and the blocks are joined
here. On valid rows:

- features, labels and values equal the port's unsharded kernels
  bitwise (the arctangent kernels within one ulp: the CPU's vectorized
  arctangent rounds by lane), and JAX's sequence-parallel ones: bitwise
  for ids, one-hots, counts, labels and values, and within the port's
  feature parity bounds (rtol 1e-5, atol 1e-6,
  ``tests/test_torch_features.py``) on the other float features;
- ``sequence_rate`` is within 1e-6 of the port's ``rate_batch`` and
  within 1e-5 of JAX's ``sequence_rate`` (the port's serving bound);
- family mismatches and heads that are not MLPs are rejected, a halo
  wider than its shard and an action axis that does not divide raise,
  and the goalscore prefix carries goals across shards.
"""


import jax
import jax.numpy as jnp
import numpy as np
import pandas as pd
import pytest
import torch

from socceraction_tpu.atomic.spadl import convert_to_atomic
from socceraction_tpu.atomic.vaep import AtomicVAEP as JaxAtomicVAEP
from socceraction_tpu.core.batch import pack_actions, pack_atomic_actions
from socceraction_tpu.core.synthetic import synthetic_actions_frame
from socceraction_tpu.ml.mlp import MLPClassifier as JaxMLP
from socceraction_tpu.parallel import sequence as jseq
from socceraction_tpu.vaep.base import VAEP as JaxVAEP
from socceraction_tpu_torch.atomic.vaep.base import XFNS_DEFAULT as ATOMIC_XFNS
from socceraction_tpu_torch.core.batch import ActionBatch, AtomicActionBatch
from socceraction_tpu_torch.ops import atomic as tatomic
from socceraction_tpu_torch.ops import features as tfeat
from socceraction_tpu_torch.ops.formula import vaep_values
from socceraction_tpu_torch.ops.fused import ATOMIC_REGISTRY, train_layout
from socceraction_tpu_torch.ops.labels import scores_concedes
from socceraction_tpu_torch.vaep.base import XFNS_DEFAULT

from torch_parallel_worker import model_of, spawn

NAMES = (
    'actiontype_onehot', 'result_onehot', 'bodypart_onehot', 'time', 'startlocation',
    'endlocation', 'startpolar', 'endpolar', 'movement', 'team', 'time_delta',
    'space_delta', 'goalscore',
)
ATOMIC_NAMES = (
    'actiontype_onehot', 'bodypart_onehot', 'time', 'team', 'time_delta', 'location',
    'polar', 'movement_polar', 'direction', 'goalscore',
)
#: Kernels whose columns are ids, 0/1 indicators or integer counts.
EXACT = {
    'actiontype_onehot', 'result_onehot', 'bodypart_onehot', 'team', 'goalscore', 'time',
}
#: Kernels with an arctangent. ATen's CPU arctangent rounds a value one
#: ulp apart by where it falls in a vector (its SIMD body or scalar tail),
#: and a shard places a game's columns elsewhere than the whole batch
#: does; every other kernel is held bitwise.
ARCTAN = {'startpolar', 'endpolar', 'movement_polar'}
SEQ = 2
A = 1024
HIDDEN = (16,)


def _fields(jbatch, cls):
    return {n: np.array(getattr(jbatch, n)) for n in cls.__dataclass_fields__}


def _port(fields, cls=ActionBatch):
    return cls(**{n: torch.from_numpy(a.copy()) for n, a in fields.items()})


def _standard_frames():
    return [
        synthetic_actions_frame(game_id=1000 + g, n_actions=700 + 100 * g, seed=g)
        for g in range(2)
    ]


@pytest.fixture(scope='module')
def jax_mesh():
    assert len(jax.devices()) == 8
    return jseq.make_sequence_mesh(seq_parallel=4)


@pytest.fixture(scope='module')
def batch():
    df = pd.concat(_standard_frames(), ignore_index=True)
    b, _ = pack_actions(df, home_team_ids={g: 100 for g in df['game_id'].unique()}, max_actions=A)
    return b


@pytest.fixture(scope='module')
def atomic_batch():
    frames = [
        convert_to_atomic(synthetic_actions_frame(game_id=1000 + g, n_actions=400 + 40 * g, seed=g))
        for g in range(2)
    ]
    df = pd.concat(frames, ignore_index=True)
    b, _ = pack_atomic_actions(
        df, home_team_ids={g: 100 for g in df['game_id'].unique()}, max_actions=A
    )
    return b


def _heads(seed, n_features, feats, mask):
    """``{head: (flax params, mean, std)}`` drawn from ``seed``; the
    statistics are those of the batch's own features."""
    rng = np.random.default_rng(seed)
    X = feats[mask]
    std = X.std(axis=0)
    mean, std = X.mean(axis=0).astype(np.float32), np.where(std > 0, std, 1.0).astype(np.float32)
    out = {}
    for head in ('scores', 'concedes'):
        widths = (n_features, *HIDDEN, 1)
        params = {'params': {
            f'Dense_{i}': {
                'bias': rng.normal(0, 0.1, widths[i + 1]).astype(np.float32),
                'kernel': rng.normal(0, widths[i] ** -0.5, (widths[i], widths[i + 1])).astype(np.float32),
            }
            for i in range(len(widths) - 1)
        }}
        out[head] = (params, mean, std)
    return out


def _jax_model(cls, heads, k):
    model = cls(backend='jax', nb_prev_actions=k)
    for head, (params, mean, std) in heads.items():
        clf = JaxMLP(hidden=HIDDEN)
        clf.params = jax.tree.map(jnp.asarray, params)
        clf.mean_, clf.std_ = mean, std
        model._models[head] = clf
    return model


@pytest.fixture(scope='module')
def models(batch, atomic_batch):
    """Seeded heads for the standard family at k = 1 and 3, and the atomic one."""
    mask = np.asarray(batch.mask)
    out = {}
    for k in (1, 3):
        feats = tfeat.compute_features(_port(_fields(batch, ActionBatch)), names=XFNS_DEFAULT, k=k)
        n = train_layout(XFNS_DEFAULT, k).n_features
        out[f'models_k{k}'] = _heads(k, n, feats.numpy(), mask)
    ab = _port(_fields(atomic_batch, AtomicActionBatch), AtomicActionBatch)
    feats = tatomic.compute_features(ab, names=ATOMIC_XFNS, k=3)
    n = train_layout(ATOMIC_XFNS, 3, ATOMIC_REGISTRY).n_features
    out['atomic_models'] = _heads(5, n, feats.numpy(), np.asarray(atomic_batch.mask))
    return out


@pytest.fixture(scope='module')
def probs(batch, atomic_batch):
    rng = np.random.default_rng(0)
    shape, ashape = np.asarray(batch.mask).shape, np.asarray(atomic_batch.mask).shape
    return {
        'ps': rng.uniform(size=shape).astype(np.float32),
        'pc': rng.uniform(size=shape).astype(np.float32),
        'aps': rng.uniform(size=ashape).astype(np.float32),
        'apc': rng.uniform(size=ashape).astype(np.float32),
    }


@pytest.fixture(scope='module')
def ranks(tmp_path_factory, batch, atomic_batch, models, probs):
    fields = _fields(batch, ActionBatch)
    short = pd.concat(
        [synthetic_actions_frame(game_id=g, n_actions=14, seed=g) for g in (1, 2)],
        ignore_index=True,
    )
    short_batch, _ = pack_actions(short, home_team_ids={1: 100, 2: 100}, max_actions=16)
    rng = np.random.default_rng(1)
    inputs = {
        'seq': SEQ,
        'standard': fields,
        'atomic': _fields(atomic_batch, AtomicActionBatch),
        # A = 1023 does not divide over 2 seq shards
        'odd': {n: a[:, : A - 1] if a.ndim == 2 else a for n, a in fields.items()},
        # A = 16 over 2 shards: 8 columns each, fewer than the 9 of the label halo
        'short': _fields(short_batch, ActionBatch),
        'names': NAMES,
        'atomic_names': ATOMIC_NAMES,
        'tiny_head': {'params': {
            'Dense_0': {'bias': np.zeros(4, np.float32), 'kernel': rng.normal(size=(1, 4)).astype(np.float32)},
            'Dense_1': {'bias': np.zeros(1, np.float32), 'kernel': rng.normal(size=(4, 1)).astype(np.float32)},
        }},
        **models,
        **probs,
    }
    return spawn('sequence', inputs, tmp_path_factory.mktemp('sequence'))


def _joined(results, key, game_dim=0, seq_dim=1):
    """The ``(games, seq)`` blocks of ``key`` joined into the global array."""
    n_games = 1 + max(r['coords']['games'] for r in results)
    rows = []
    for g in range(n_games):
        line = sorted((r for r in results if r['coords']['games'] == g), key=lambda r: r['coords']['seq'])
        rows.append(torch.cat([r[key] for r in line], dim=seq_dim))
    return torch.cat(rows, dim=game_dim).numpy()


def _joined_labels(results, key):
    """Labels come back stacked ``(2, G, A)`` per rank."""
    return _joined(results, key, game_dim=1, seq_dim=2)


def _assert_features(got, port, want, names, k, widths, mask):
    """Each kernel's block against the port's unsharded kernels (bitwise,
    or within one ulp for :data:`ARCTAN`) and JAX's sequence-parallel
    ones (bitwise on :data:`EXACT`, else the port's feature bounds)."""
    off = 0
    for name in names:
        a, b, c = widths[name]
        width = a * k + b * (k - 1) + c
        g = got[mask][:, off : off + width]
        p, w = port[mask][:, off : off + width], want[mask][:, off : off + width]
        if name in ARCTAN:
            np.testing.assert_array_max_ulp(g, p, maxulp=1)
        else:
            np.testing.assert_array_equal(g, p, err_msg=name)
        if name in EXACT:
            np.testing.assert_array_equal(g, w, err_msg=name)
        else:
            np.testing.assert_allclose(g, w, rtol=1e-5, atol=1e-6, err_msg=name)
        off += width
    assert off == got.shape[-1]


@pytest.mark.parametrize('k', [1, 2, 3])
def test_sequence_features_match(ranks, batch, jax_mesh, k):
    got = _joined(ranks, f'features_k{k}')
    port = tfeat.compute_features(_port(_fields(batch, ActionBatch)), names=NAMES, k=k).numpy()
    want = np.asarray(jseq.sequence_features(jseq.shard_batch_seq(batch, jax_mesh), jax_mesh, names=NAMES, k=k))
    _assert_features(got, port, want, NAMES, k, tfeat._WIDTHS, np.asarray(batch.mask))


@pytest.mark.parametrize('nr_actions', [2, 10])
def test_sequence_labels_match(ranks, batch, jax_mesh, nr_actions):
    got = _joined_labels(ranks, f'labels_nr{nr_actions}')
    mask = np.asarray(batch.mask)
    port = scores_concedes(_port(_fields(batch, ActionBatch)), nr_actions=nr_actions)
    want = jseq.sequence_labels(jseq.shard_batch_seq(batch, jax_mesh), jax_mesh, nr_actions=nr_actions)
    for i in range(2):
        np.testing.assert_array_equal(got[i][mask], port[i].numpy()[mask])
        np.testing.assert_array_equal(got[i][mask], np.asarray(want[i])[mask])


def _jax_sharded(x, mesh):
    from jax.sharding import NamedSharding, PartitionSpec as P

    return jax.device_put(jnp.asarray(x), NamedSharding(mesh, P('games', 'seq')))


def test_sequence_values_match(ranks, batch, jax_mesh, probs):
    got = _joined(ranks, 'values')
    mask = np.asarray(batch.mask)
    tb = _port(_fields(batch, ActionBatch))
    port = vaep_values(tb, torch.from_numpy(probs['ps']), torch.from_numpy(probs['pc'])).numpy()
    want = jseq.sequence_values(
        jseq.shard_batch_seq(batch, jax_mesh), _jax_sharded(probs['ps'], jax_mesh),
        _jax_sharded(probs['pc'], jax_mesh), jax_mesh,
    )
    np.testing.assert_array_equal(got[mask], port[mask])
    np.testing.assert_array_equal(got[mask], np.asarray(want)[mask])


@pytest.mark.parametrize('k', [1, 3])
def test_sequence_rate_matches_rate_batch(ranks, batch, jax_mesh, models, k):
    from socceraction_tpu_torch.vaep.base import VAEP

    got = _joined(ranks, f'rate_k{k}')
    mask = np.asarray(batch.mask)
    heads = models[f'models_k{k}']
    port = model_of(heads, VAEP, nb_prev_actions=k).rate_batch(_port(_fields(batch, ActionBatch)))
    np.testing.assert_allclose(got[mask], port.numpy()[mask], rtol=1e-6, atol=1e-6)
    want = jseq.sequence_rate(_jax_model(JaxVAEP, heads, k), jseq.shard_batch_seq(batch, jax_mesh), jax_mesh)
    np.testing.assert_allclose(got[mask], np.asarray(want)[mask], rtol=0, atol=1e-5)


def test_atomic_sequence_features_match(ranks, atomic_batch, jax_mesh):
    got = _joined(ranks, 'atomic_features')
    port = tatomic.compute_features(
        _port(_fields(atomic_batch, AtomicActionBatch), AtomicActionBatch), names=ATOMIC_NAMES, k=3
    ).numpy()
    want = np.asarray(jseq.sequence_features(
        jseq.shard_batch_seq(atomic_batch, jax_mesh), jax_mesh, names=ATOMIC_NAMES, k=3
    ))
    _assert_features(got, port, want, ATOMIC_NAMES, 3, tatomic.ATOMIC_WIDTHS, np.asarray(atomic_batch.mask))


def test_atomic_sequence_labels_match(ranks, atomic_batch, jax_mesh):
    got = _joined_labels(ranks, 'atomic_labels')
    mask = np.asarray(atomic_batch.mask)
    port = tatomic.scores_concedes(_port(_fields(atomic_batch, AtomicActionBatch), AtomicActionBatch))
    want = jseq.sequence_labels(jseq.shard_batch_seq(atomic_batch, jax_mesh), jax_mesh)
    for i in range(2):
        np.testing.assert_array_equal(got[i][mask], port[i].numpy()[mask])
        np.testing.assert_array_equal(got[i][mask], np.asarray(want[i])[mask])


def test_atomic_sequence_values_match(ranks, atomic_batch, jax_mesh, probs):
    got = _joined(ranks, 'atomic_values')
    mask = np.asarray(atomic_batch.mask)
    tb = _port(_fields(atomic_batch, AtomicActionBatch), AtomicActionBatch)
    port = tatomic.vaep_values(tb, torch.from_numpy(probs['aps']), torch.from_numpy(probs['apc'])).numpy()
    want = jseq.sequence_values(
        jseq.shard_batch_seq(atomic_batch, jax_mesh), _jax_sharded(probs['aps'], jax_mesh),
        _jax_sharded(probs['apc'], jax_mesh), jax_mesh,
    )
    np.testing.assert_array_equal(got[mask], port[mask])
    np.testing.assert_array_equal(got[mask], np.asarray(want)[mask])


def test_atomic_sequence_rate_matches_rate_batch(ranks, atomic_batch, jax_mesh, models):
    from socceraction_tpu_torch.atomic.vaep.base import AtomicVAEP

    got = _joined(ranks, 'atomic_rate')
    mask = np.asarray(atomic_batch.mask)
    heads = models['atomic_models']
    tb = _port(_fields(atomic_batch, AtomicActionBatch), AtomicActionBatch)
    port = model_of(heads, AtomicVAEP, nb_prev_actions=3).rate_batch(tb)
    np.testing.assert_allclose(got[mask], port.numpy()[mask], rtol=1e-6, atol=1e-6)
    want = jseq.sequence_rate(
        _jax_model(JaxAtomicVAEP, heads, 3), jseq.shard_batch_seq(atomic_batch, jax_mesh), jax_mesh
    )
    np.testing.assert_allclose(got[mask], np.asarray(want)[mask], rtol=0, atol=1e-5)


def test_goalscore_prefix_crosses_shards(ranks, batch):
    got = _joined(ranks, 'goalscore')
    port = tfeat.compute_features(_port(_fields(batch, ActionBatch)), names=('goalscore',), k=1)
    np.testing.assert_array_equal(got, port.numpy())
    totals = got[:, :, 0] + got[:, :, 1]
    n_last = np.asarray(batch.n_actions) - 1
    assert (n_last >= A // SEQ).all(), 'every game must reach the second shard'
    assert (totals[np.arange(2), n_last] > 0).all(), 'no goals crossed shards'


def test_rejections(ranks):
    for r in ranks:
        assert 'MLP heads' in r['error_tree']
        assert 'family' in r['error_family']
        assert 'halo width' in r['error_halo']
        assert 'does not divide' in r['error_axis']
        assert 'does not divide' in r['error_seq_divide']
