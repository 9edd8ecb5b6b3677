"""Seq and mixed MLP/seq pairs behind the port's rating service, against
the JAX package's, on the CPU.

A seq pair (two GRU heads) snaps each flush's action axis to its window
rung (``core.batch.window_ladder``); a mixed pair (an MLP scores head, a
seq concedes head) rates on the materialized path at the full window. The
same weights serve in both packages: a port model and the JAX package's
load of its checkpoint (written through ``convert.py``). Each case holds:

- the served values to the JAX service's within 1e-5, and each package's
  to its own one-game reference;
- the warm-up's shape counts and ``seq/window_slices`` equal, band by
  band; a band's requests fill the batcher's queue, so each band is one
  flush in both packages whatever the timing;
- the mixed pair reaches no B1 wrapper, as its MLP head reads the feature
  tensor;
- a hot swap from an MLP version to a seq version and the rollback.
"""

from types import SimpleNamespace

import numpy as np
import pytest

from socceraction_tpu.core.batch import pack_actions as jax_pack_actions
from socceraction_tpu.core.batch import unpack_values as jax_unpack_values
from socceraction_tpu.core.synthetic import synthetic_actions_frame
from socceraction_tpu.obs import REGISTRY as JAX_REGISTRY
from socceraction_tpu.serve import ModelRegistry as JaxRegistry
from socceraction_tpu.serve import RatingService as JaxService
from socceraction_tpu.vaep.base import load_model as jax_load_model
from socceraction_tpu_torch.core.batch import pack_actions, unpack_values, window_ladder
from socceraction_tpu_torch.core.synthetic import synthetic_batch
from socceraction_tpu_torch.obs import REGISTRY, drain_guards
from socceraction_tpu_torch.ops import fused as tfused
from socceraction_tpu_torch.serve import ModelRegistry, RatingService
from socceraction_tpu_torch.vaep.base import VAEP

HOME = 100
A = 256
RUNGS = window_ladder(A)  # (128, 256)
#: the port's served values against the JAX package's and each reference (f32)
ATOL = 1e-5
NEVER_MS = 600_000.0
WAIT = 120.0
BATCH = 4

PKGS = {
    'jax': SimpleNamespace(Service=JaxService, metrics=JAX_REGISTRY, registry=JaxRegistry),
    'port': SimpleNamespace(Service=RatingService, metrics=REGISTRY,
                            registry=lambda root: ModelRegistry(root, device='cpu')),
}


@pytest.fixture(scope='module', autouse=True)
def _drain_guards():
    """Leave the process-wide guard ring empty for the next module."""
    yield
    drain_guards()


def _fit(seed, **params):
    learner = params.pop('learner', 'mlp')
    return VAEP(device='cpu').fit_packed(
        synthetic_batch(2, A, seed=seed, device='cpu'), learner=learner,
        tree_params={'batch_size': 256, **params}, random_state=0,
    )


@pytest.fixture(scope='module')
def port_models():
    mlp = _fit(3, hidden=(16,), max_epochs=2)
    seq = _fit(4, learner='seq', embed_dim=8, hidden=16, readout=16, max_epochs=1)
    mixed = VAEP(models={'scores': mlp._models['scores'], 'concedes': seq._models['concedes']},
                 device='cpu')
    return {'mlp': mlp, 'seq': seq, 'mixed': mixed}


@pytest.fixture(scope='module')
def models(port_models, tmp_path_factory):
    """{kind: {'port': model, 'jax': the JAX package's load of its checkpoint}}."""
    out = {}
    for kind, model in port_models.items():
        path = str(tmp_path_factory.mktemp(kind))
        model.save_model(path)
        out[kind] = {'port': model, 'jax': jax_load_model(path)}
    return out


def _frame(i, n):
    return synthetic_actions_frame(game_id=i, seed=i, n_actions=n)


def _band_frames(rung, seed):
    """``BATCH`` frames whose lengths lie in (previous rung, rung]."""
    prev = ([0] + list(RUNGS))[RUNGS.index(rung)]
    rng = np.random.default_rng(seed)
    return [_frame(60 + 10 * seed + i, int(n)) for i, n in enumerate(rng.integers(prev + 1, rung + 1, BATCH))]


def _reference(pkg, model, frame):
    """``rate_batch_reference`` of one frame alone, unpacked, in ``pkg``."""
    if pkg == 'jax':
        batch, _ = jax_pack_actions(frame, home_team_id=HOME, max_actions=A)
        return np.asarray(jax_unpack_values(model.rate_batch_reference(batch), batch))
    batch, _ = pack_actions(frame, home_team_id=HOME, max_actions=A, device='cpu')
    return unpack_values(model.rate_batch_reference(batch), batch)


def _slices(p):
    snap = p.metrics.snapshot()
    return {r: snap.value('seq/window_slices', window=str(r)) for r in RUNGS}


def _delta(after, before):
    return {k: after[k] - before[k] for k in after}


def _serve_bands(pkg, model):
    """Warm a service, then send each band's frames at once (one full
    take a band); the warm-up's shapes and window slices, each band's
    window slices and values, and the shapes at the end."""
    p = PKGS[pkg]
    out = {'bands': {}}
    with p.Service(model, max_actions=A, max_batch_size=BATCH, max_wait_ms=NEVER_MS) as svc:
        before = _slices(p)
        svc.warmup()
        out['warm'] = (svc.compiled_shapes, _delta(_slices(p), before))
        for seed, rung in enumerate(RUNGS):
            frames = _band_frames(rung, seed)
            before = _slices(p)
            futs = [svc.rate(f, home_team_id=HOME) for f in frames]
            values = [f.result(timeout=WAIT).to_numpy() for f in futs]
            out['bands'][rung] = (_delta(_slices(p), before), values, frames)
        out['shapes'] = svc.compiled_shapes
    return out


@pytest.mark.parametrize('kind', ['seq', 'mixed'])
def test_warmup_and_window_bands_match_jax(models, kind, monkeypatch):
    """Equal warm-up shape counts ((bucket, rung) pairs for the seq pair,
    buckets for the mixed pair), equal ``seq/window_slices`` band by band,
    no shape added by traffic, and values within 1e-5 of the JAX
    service's and of each package's own reference."""
    calls = []
    for name in ('fused_first_layer', 'fused_first_layer_quant'):
        real = getattr(tfused, name)
        monkeypatch.setattr(tfused, name, lambda *a, _real=real, **k: calls.append(1) or _real(*a, **k))
    runs = {pkg: _serve_bands(pkg, models[kind][pkg]) for pkg in PKGS}
    ladder = len(RatingService(models[kind]['port'], max_actions=A, max_batch_size=BATCH).ladder)
    seq = kind == 'seq'
    warm_slices = {r: float(ladder if seq and r < A else 0) for r in RUNGS}
    assert runs['port']['warm'] == runs['jax']['warm'] == (ladder * (len(RUNGS) if seq else 1), warm_slices)
    assert runs['port']['shapes'] == runs['jax']['shapes'] == runs['port']['warm'][0]
    for rung in RUNGS:
        got, want = runs['port']['bands'][rung], runs['jax']['bands'][rung]
        assert got[0] == want[0] == {r: float(seq and r == rung and r < A) for r in RUNGS}
        for port_v, jax_v, frame in zip(got[1], want[1], got[2]):
            assert port_v.shape == jax_v.shape == (len(frame), 3)
            np.testing.assert_allclose(port_v, jax_v, rtol=0, atol=ATOL)
            np.testing.assert_allclose(port_v, _reference('port', models[kind]['port'], frame),
                                       rtol=0, atol=ATOL)
            np.testing.assert_allclose(jax_v, _reference('jax', models[kind]['jax'], frame),
                                       rtol=0, atol=ATOL)
    # the mixed pair's MLP head reads the feature tensor: no B1 wrapper runs
    assert calls == []


def test_swap_from_mlp_to_seq_and_rollback_matches_jax(models, tmp_path):
    """v1 an MLP pair, v2 a seq pair: the swap warms v2's window rungs
    before v2 serves (the shape count after the swap equals the seq pair's
    whole warm-up), a request after the swap is v2's and after the
    rollback v1's, each within 1e-5 of the JAX service's and its version's
    reference; the swap counters move alike."""
    frame_short, frame_long = _frame(91, 90), _frame(92, 200)
    outs, seen = {}, {}
    for pkg, p in PKGS.items():
        reg = p.registry(str(tmp_path / pkg))
        reg.publish('vaep', '1', models['mlp'][pkg])
        reg.publish('vaep', '2', models['seq'][pkg])
        reg.activate('vaep', '1')
        snap = p.metrics.snapshot()
        swaps = snap.value('serve/model_swaps')
        rollbacks = snap.value('serve/model_swaps', reason='rollback')
        with p.Service(registry=reg, max_actions=A, max_batch_size=BATCH, max_wait_ms=1.0) as svc:
            svc.warmup()
            v1_shapes = svc.compiled_shapes
            first = svc.rate_sync(frame_short, home_team_id=HOME, timeout=WAIT).to_numpy()
            svc.swap_model('vaep', '2')
            swapped = svc.compiled_shapes
            on_v2 = [svc.rate_sync(f, home_team_id=HOME, timeout=WAIT).to_numpy()
                     for f in (frame_short, frame_long)]
            svc.rollback_model()
            back = svc.rate_sync(frame_long, home_team_id=HOME, timeout=WAIT).to_numpy()
            active = reg.active()[:2]
            end_shapes = svc.compiled_shapes
        snap = p.metrics.snapshot()
        seen[pkg] = (v1_shapes, swapped, end_shapes, tuple(active),
                     snap.value('serve/model_swaps') - swaps,
                     snap.value('serve/model_swaps', reason='rollback') - rollbacks)
        outs[pkg] = [first, *on_v2, back]
        for got, version, frame in zip(outs[pkg], ('mlp', 'seq', 'seq', 'mlp'),
                                       (frame_short, frame_short, frame_long, frame_long)):
            np.testing.assert_allclose(got, _reference(pkg, models[version][pkg], frame),
                                       rtol=0, atol=ATOL)
    ladder = seen['port'][0]
    assert seen['port'] == seen['jax'] == (ladder, ladder * len(RUNGS), ladder * len(RUNGS),
                                           ('vaep', '1'), 1.0, 1.0)
    for got, want in zip(outs['port'], outs['jax']):
        np.testing.assert_allclose(got, want, rtol=0, atol=ATOL)
    # the versions are far apart: each request is wholly one version's
    assert np.abs(outs['port'][0] - outs['port'][1]).max() > 1e-3
