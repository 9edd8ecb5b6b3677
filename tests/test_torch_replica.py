"""The port's replica fan-out (``parallel/serve.py``) against the JAX package's.

The counterpart of the dispatcher cases of ``tests/test_mesh_serve.py``
(``:113-199``), in one process. The JAX ``ReplicaDispatcher`` runs on 4
of the 8 virtual CPU devices; the port's lanes sit on the one CPU device,
named four times (a list of devices may repeat one). A JAX ``VAEP`` gets
two MLP heads from seeded numpy arrays and the port the same heads
through ``convert.py``. Held:

- every lane, with or without a goalscore override, and every lane of a
  gang dispatch, bitwise the port's ``rate_batch(batch, bucket=False)``,
  and within 1e-5 (the port's serving bound) of JAX's lanes;
- a gang with goalscore blocks for some lanes only is refused, as are a
  lane count below one, more lanes than devices, and gangs of the wrong
  size or of mixed game counts;
- ``data_parallel_rate`` bitwise the single-device rating per batch.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from socceraction_tpu.core.batch import pack_actions
from socceraction_tpu.core.synthetic import synthetic_actions_frame
from socceraction_tpu.ml.mlp import MLPClassifier as JaxMLP
from socceraction_tpu.ops import features as jfeat
from socceraction_tpu.parallel import data_parallel_rate as jax_data_parallel_rate
from socceraction_tpu.parallel.serve import ReplicaDispatcher as JaxDispatcher
from socceraction_tpu.vaep.base import VAEP as JaxVAEP
from socceraction_tpu_torch import convert
from socceraction_tpu_torch.core.batch import ActionBatch
from socceraction_tpu_torch.parallel import ReplicaDispatcher, data_parallel_rate, make_replica_mesh
from socceraction_tpu_torch.vaep.base import VAEP

HOME = 100
MAX_ACTIONS = 512
N_REPLICAS = 4
HIDDEN = (16,)
ATOL = 1e-5
CPU4 = ['cpu'] * N_REPLICAS


def _batches(game_id, n_actions):
    """(JAX batch, port batch) of one seeded synthetic game."""
    frame = synthetic_actions_frame(game_id=game_id, seed=game_id, n_actions=n_actions)
    jb, _ = pack_actions(frame, home_team_id=HOME, max_actions=MAX_ACTIONS)
    fields = {n: torch.from_numpy(np.array(getattr(jb, n))) for n in ActionBatch.__dataclass_fields__}
    return jb, ActionBatch(**fields)


@pytest.fixture(scope='module')
def models():
    """(JAX model, port model) with the same seeded heads."""
    jb, _ = _batches(7, 400)
    names = JaxVAEP()._kernel_names()
    X = np.asarray(jfeat.compute_features(jb, names=names, k=3))[np.asarray(jb.mask)]
    std = X.std(axis=0)
    mean, std = X.mean(axis=0).astype(np.float32), np.where(std > 0, std, 1.0).astype(np.float32)
    rng = np.random.default_rng(0)
    jmodel, heads = JaxVAEP(), {}
    for head in ('scores', 'concedes'):
        widths = (X.shape[1], *HIDDEN, 1)
        params = {'params': {
            f'Dense_{i}': {
                'bias': rng.normal(0, 0.1, widths[i + 1]).astype(np.float32),
                'kernel': rng.normal(0, widths[i] ** -0.5, (widths[i], widths[i + 1])).astype(np.float32),
            }
            for i in range(len(widths) - 1)
        }}
        clf = JaxMLP(hidden=HIDDEN)
        clf.params = {'params': {
            layer: {n: jnp.asarray(a) for n, a in leaves.items()}
            for layer, leaves in params['params'].items()
        }}
        clf.mean_, clf.std_ = mean, std
        jmodel._models[head] = clf
        heads[head] = convert.mlp_from_jax_params(params, mean, std, device='cpu')
    return jmodel, VAEP(models=heads, device='cpu')


def test_lane_dispatch_is_bitwise_the_single_device_path(models):
    jmodel, model = models
    jb, tb = _batches(50, 200)
    ref = model.rate_batch(tb, bucket=False).numpy()
    disp = ReplicaDispatcher(model, n_replicas=N_REPLICAS, devices=CPU4)
    assert len(disp.devices) == N_REPLICAS
    jdisp = JaxDispatcher(jmodel, n_replicas=N_REPLICAS)
    mask = tb.mask.numpy()
    for r in range(N_REPLICAS):
        out = disp.rate_replica(r, tb)
        assert out.shape == ref.shape
        np.testing.assert_array_equal(out, ref)
        np.testing.assert_allclose(out[mask], jdisp.rate_replica(r, jb)[mask], rtol=0, atol=ATOL)


def test_lane_dispatch_goalscore_override_parity(models):
    jmodel, model = models
    jb, tb = _batches(51, 150)
    gs = np.random.default_rng(0).normal(size=(tb.n_games, tb.max_actions, 3)).astype(np.float32)
    ref = model.rate_batch(tb, dense_overrides={'goalscore': gs}, bucket=False).numpy()
    out = ReplicaDispatcher(model, n_replicas=2, devices=CPU4[:2]).rate_replica(1, tb, gs)
    np.testing.assert_array_equal(out, ref)
    want = JaxDispatcher(jmodel, n_replicas=2).rate_replica(1, jb, gs)
    mask = tb.mask.numpy()
    np.testing.assert_allclose(out[mask], want[mask], rtol=0, atol=ATOL)


def test_gang_dispatch_parity(models):
    jmodel, model = models
    jb, tb = _batches(52, 180)
    ref = model.rate_batch(tb, bucket=False).numpy()
    (g1,) = ReplicaDispatcher(model, n_replicas=1).rate_mesh([tb])
    np.testing.assert_array_equal(g1, ref)
    outs = ReplicaDispatcher(model, n_replicas=N_REPLICAS, devices=CPU4).rate_mesh([tb] * N_REPLICAS)
    want = JaxDispatcher(jmodel, n_replicas=N_REPLICAS).rate_mesh([jb] * N_REPLICAS)
    assert len(outs) == N_REPLICAS
    mask = tb.mask.numpy()
    for out, w in zip(outs, want):
        np.testing.assert_array_equal(out, ref)
        np.testing.assert_allclose(out[mask], w[mask], rtol=0, atol=ATOL)


def test_gang_dispatch_rejects_mixed_goalscore(models):
    _, model = models
    _, tb = _batches(53, 100)
    gs = np.zeros((tb.n_games, tb.max_actions, 3), dtype=np.float32)
    disp = ReplicaDispatcher(model, n_replicas=2, devices=CPU4[:2])
    with pytest.raises(ValueError, match='every replica or for none'):
        disp.rate_mesh([tb, tb], [gs, None])
    ref = model.rate_batch(tb, dense_overrides={'goalscore': gs}, bucket=False).numpy()
    for out in disp.rate_mesh([tb, tb], [gs, gs]):
        np.testing.assert_array_equal(out, ref)


def test_dispatcher_validates_topology(models, monkeypatch):
    _, model = models
    _, tb = _batches(55, 100)
    with pytest.raises(ValueError, match='n_replicas must be >= 1'):
        ReplicaDispatcher(model, 0)
    # one CPU device in this process
    with pytest.raises(ValueError, match='devices are available'):
        ReplicaDispatcher(model, 2)
    assert make_replica_mesh(2, devices=CPU4).shape == {'replicas': 2}
    disp = ReplicaDispatcher(model, 2, devices=CPU4[:2])
    with pytest.raises(ValueError, match='exactly one per replica'):
        disp.rate_mesh([tb])
    wider = ActionBatch(**{n: torch.cat([t, t]) for n, t in tb.fields().items()})
    with pytest.raises(ValueError, match='one bucket rung'):
        disp.rate_mesh([tb, wider])
    monkeypatch.setenv('SOCCERACTION_TPU_RATING_PATH', 'materialized')
    with pytest.raises(ValueError, match='fused dispatch path only'):
        ReplicaDispatcher(model, 1)


def test_data_parallel_rate_matches_single_device(models):
    jmodel, model = models
    jb, tb = _batches(54, 160)
    ref = model.rate_batch(tb, bucket=False).numpy()
    outs = data_parallel_rate(model, [tb] * N_REPLICAS, devices=CPU4)
    want = jax_data_parallel_rate(jmodel, [jb] * N_REPLICAS)
    assert len(outs) == N_REPLICAS
    mask = tb.mask.numpy()
    for out, w in zip(outs, want):
        np.testing.assert_array_equal(out, ref)
        np.testing.assert_allclose(out[mask], w[mask], rtol=0, atol=ATOL)
    with pytest.raises(ValueError, match='one batch per replica'):
        data_parallel_rate(model, [tb, tb], n_replicas=4, devices=CPU4)
