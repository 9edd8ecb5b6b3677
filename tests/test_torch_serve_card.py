"""Serving's outer tier on the card: replica lanes and the warm tier.

Every test here needs a CUDA card and skips without one; the machine with
the card has no JAX or pandas, so this file imports neither, builds its
requests from arrays and enters the service where ``rate`` arrives once it
has packed its frame (``_submit``), and runs without the suite's conftest:

    python -m pytest tests/test_torch_serve_card.py -m gpu --noconftest -q
"""

import numpy as np
import pytest
import torch

from socceraction_tpu_torch.config import COMPILE_CACHE_ENV
from socceraction_tpu_torch.core.synthetic import synthetic_batch
from socceraction_tpu_torch.obs import REGISTRY
from socceraction_tpu_torch.obs.context import new_request_context
from socceraction_tpu_torch.ops import cuda_build
from socceraction_tpu_torch.ops import gather_matmul as tgm
from socceraction_tpu_torch.serve import ModelRegistry, RatingService
from socceraction_tpu_torch.serve import service as serve_service
from socceraction_tpu_torch.serve.aot import KERNELS
from socceraction_tpu_torch.vaep.base import VAEP

A = 256


@pytest.fixture
def cuda():
    """The card, or a skip where there is none (decided per test, not at
    import, so every worker collects the same tests)."""
    if not torch.cuda.is_available():
        pytest.skip('needs a CUDA card')
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device('cuda', 0)


@pytest.fixture
def model(cuda):
    return VAEP(device=cuda).fit_packed(
        synthetic_batch(4, A, seed=3, device=cuda),
        tree_params={'hidden': (32,), 'batch_size': 512, 'max_epochs': 2}, random_state=0,
    )


def _requests(n, seed=7):
    """One-game host staging batches (numpy fields), each with a goalscore
    block of zeros (an override every service here is given alike)."""
    host = synthetic_batch(n, A, seed=seed, device='cpu')
    fields = {k: v.numpy() for k, v in host.fields().items()}
    out = []
    for g in range(n):
        staging = type(host)(**{k: v[g : g + 1] for k, v in fields.items()})
        n_actions = int(staging.n_actions[0])
        gs = np.zeros((1, A, 3), dtype=np.float32)
        out.append((staging, gs, n_actions))
    return out


def _submit(svc, req):
    staging, gs, n = req
    ctx = new_request_context('rate')
    return svc._submit(serve_service._Payload(staging, gs, keep=(0, n), ctx=ctx), 'rate', ctx)


@pytest.mark.gpu
def test_four_lanes_on_one_card_share_the_weights_and_match_one_lane(cuda, model):
    """Four lanes on one card: a stream each, no allocation to build them,
    one B1 launch a flush; each request alone comes back bitwise as the
    one-lane service rates it."""
    reqs = _requests(8)
    model._prepared_pair()  # the serving fold, built once for every lane
    before = torch.cuda.memory_stats(cuda)['requested_bytes.all.current']
    with RatingService(model, max_actions=A, max_batch_size=4, n_replicas=4) as svc:
        # no weight copy: under a megabyte requested (tensors freed meanwhile
        # may even lower the count)
        assert torch.cuda.memory_stats(cuda)['requested_bytes.all.current'] - before < 1 << 20
        assert len({s.cuda_stream for s in svc._lane_streams}) == 4
        svc.warmup()
        tgm.fused_first_layer_quant.launches = 0
        got = [_submit(svc, r).result(timeout=120) for r in reqs]
        assert tgm.fused_first_layer_quant.launches == len(reqs)
        lanes = [svc._flush([serve_service._Payload(reqs[0][0], reqs[0][1], keep=(0, reqs[0][2]))],
                            1, lane=lane)[0] for lane in range(4)]
    with RatingService(model, max_actions=A, max_batch_size=4) as one:
        want = [_submit(one, r).result(timeout=120) for r in reqs]
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)
    for v in lanes:
        np.testing.assert_array_equal(v, want[0])


@pytest.mark.gpu
def test_a_shipped_library_loads_and_launches_without_nvcc(cuda, model, tmp_path, monkeypatch):
    """A version published with ``aot=``, loaded by a service whose compile
    cache is empty: ``hit``, every library installed there, loaded with
    ``nvcc`` made to fail, no build counted, and B1 launches from the
    shipped library with the values of the library built here."""
    registry = ModelRegistry(str(tmp_path / 'registry'), device=cuda)
    registry.publish('vaep', '1', model, aot={'ladder': (1, 2, 4), 'max_actions': A})
    registry.activate('vaep', '1')
    req = _requests(1, seed=9)[0]
    with RatingService(registry=registry, max_actions=A, max_batch_size=4) as svc:
        want = _submit(svc, req).result(timeout=120)
    cache = tmp_path / 'replica-cache'
    monkeypatch.setenv(COMPILE_CACHE_ENV, str(cache))
    monkeypatch.setattr(cuda_build, '_loaded', {})
    monkeypatch.setattr(cuda_build, '_paths', {})

    def no_nvcc():
        raise AssertionError('nvcc must not run')

    monkeypatch.setattr(cuda_build, '_nvcc', no_nvcc)
    builds = sum(REGISTRY.snapshot().value('dispatch/kernel_builds', kernel=k) for k in KERNELS)
    with RatingService(registry=registry, max_actions=A, max_batch_size=4) as svc:
        state = svc.load_aot()
        assert state['outcome'] == 'hit' and state['entries_loaded'] == len(KERNELS)
        tgm.fused_first_layer_quant.launches = 0
        got = _submit(svc, req).result(timeout=120)
        assert tgm.fused_first_layer_quant.launches == 1
    assert sum(REGISTRY.snapshot().value('dispatch/kernel_builds', kernel=k) for k in KERNELS) == builds
    assert cuda_build._paths['gather_matmul'].parent == cache
    np.testing.assert_array_equal(got, want)


def _seq_requests(lengths, seed=11):
    """One-game requests of the given lengths, each a game of a seeded
    batch cut to its length (masked tail), with a zero goalscore block."""
    host = synthetic_batch(len(lengths), A, seed=seed, device='cpu')
    fields = {k: v.numpy() for k, v in host.fields().items()}
    out = []
    for g, n in enumerate(lengths):
        one = {k: v[g : g + 1].copy() for k, v in fields.items()}
        valid = np.arange(A)[None, :] < n
        one['mask'] = valid
        one['n_actions'] = np.array([n], dtype=np.int32)
        one['row_index'] = np.where(valid, one['row_index'], -1).astype(np.int32)
        out.append((type(host)(**one), np.zeros((1, A, 3), dtype=np.float32), n))
    return out


@pytest.mark.gpu
def test_seq_pair_serves_each_window_rung_on_the_card(cuda):
    """A seq pair behind the service on the card: every (bucket, window
    rung) shape warmed, a short request cut to the first rung and a long
    one at the full window, each within 1e-5 of its own reference, B1
    never launched and no shape added."""
    model = VAEP(device=cuda).fit_packed(
        synthetic_batch(4, A, seed=3, device=cuda), learner='seq',
        tree_params={'embed_dim': 8, 'hidden': 16, 'readout': 16, 'batch_size': 512,
                     'max_epochs': 1}, random_state=0,
    )
    assert model.time_rungs and model._rating_path() == 'seq'
    reqs = _seq_requests([100, 200])
    with RatingService(model, max_actions=A, max_batch_size=4) as svc:
        svc.warmup()
        warm = svc.compiled_shapes
        assert warm == len(svc.ladder) * 2  # rungs 128 and 256
        before = REGISTRY.snapshot().value('seq/window_slices', window='128')
        tgm.fused_first_layer_quant.launches = 0
        got = [_submit(svc, r).result(timeout=120) for r in reqs]
        assert tgm.fused_first_layer_quant.launches == 0
        assert REGISTRY.snapshot().value('seq/window_slices', window='128') - before == 1
        assert svc.compiled_shapes == warm
    for (staging, gs, n), values in zip(reqs, got):
        batch, overrides = serve_service._upload(staging, gs, cuda)
        ref = model.rate_batch_reference(batch, dense_overrides=overrides)[0, :n].cpu().numpy()
        assert values.shape == (n, 3)
        np.testing.assert_allclose(values, ref, rtol=0, atol=1e-5)
