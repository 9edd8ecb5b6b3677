"""The port's streaming feed against the JAX package's, on the same stores.

Seeded numpy draws are written as per-game frames into a ``SeasonStore``
(both engines: parquet and HDF5), for both SPADL families, at a small
size: 10 games of 40 to 256 actions. Both packages then read the same
store: ``load_batch``, and ``iter_batches`` on its three paths (the
store, a packed-cache hit, and the overlapped build on a miss) with
``prefetch`` 0 and 2. Every field of every batch is held bitwise to the
JAX package's (same dtype, same values). The port runs on the CPU here;
its card path is in ``tests/test_torch_feed_card.py``.
"""

import gc
import os
import threading
import time

import numpy as np
import pandas as pd
import pytest
import torch

from socceraction_tpu.core import batch as jbatch
from socceraction_tpu.data.statsbomb import StatsBombLoader
from socceraction_tpu.pipeline import SeasonStore as JaxSeasonStore
from socceraction_tpu.pipeline import build_spadl_store as jax_build_spadl_store
from socceraction_tpu.pipeline import iter_batches as jax_iter_batches
from socceraction_tpu.pipeline import load_batch as jax_load_batch
from socceraction_tpu.spadl import statsbomb as jax_statsbomb
from socceraction_tpu_torch.core import batch as tbatch
from socceraction_tpu_torch.obs import REGISTRY, owned_bytes
from socceraction_tpu_torch.pipeline import (
    SeasonStore,
    build_spadl_store,
    iter_batches,
    load_batch,
)
from socceraction_tpu_torch.pipeline.packed import ship_host_batch
from socceraction_tpu_torch.resil import FaultPlan, FaultSpec

ENGINES = ['parquet', 'hdf5']
FAMILIES = ['standard', 'atomic']
N_GAMES, MAX_ACTIONS = 10, 256
DATA_DIR = os.path.join(os.path.dirname(__file__), 'datasets', 'statsbomb', 'raw')


def draw_frames(family, n_games=N_GAMES, seed=0, type_high=None):
    """``{game_id: frame}`` of seeded per-game actions of a family, 40 to
    256 actions each, teams 10 + 2g (home) and 11 + 2g."""
    rng = np.random.default_rng(seed)
    frames = {}
    for g in range(n_games):
        gid = 7000 + 3 * g
        n = int(rng.integers(40, MAX_ACTIONS + 1))
        home = 10 + 2 * g
        f = {
            'game_id': np.full(n, gid, dtype=np.int64),
            'action_id': np.arange(n, dtype=np.int64),
            'team_id': np.where(rng.random(n) < 0.5, home, home + 1).astype(np.int64),
            'period_id': np.sort(rng.integers(1, 3, size=n)).astype(np.int64),
            'time_seconds': np.sort(rng.uniform(0, 2700, size=n)),
            'bodypart_id': rng.integers(0, 4, size=n).astype(np.int64),
        }
        if family == 'standard':
            f['type_id'] = rng.integers(0, type_high or 23, size=n).astype(np.int64)
            f['result_id'] = rng.integers(0, 6, size=n).astype(np.int64)
            for c, hi in (('start_x', 105.0), ('start_y', 68.0), ('end_x', 105.0), ('end_y', 68.0)):
                f[c] = rng.uniform(0, hi, size=n)
        else:
            f['type_id'] = rng.integers(0, type_high or 33, size=n).astype(np.int64)
            f['x'] = rng.uniform(0, 105.0, size=n)
            f['y'] = rng.uniform(0, 68.0, size=n)
            f['dx'] = rng.normal(0, 10, size=n)
            f['dy'] = rng.normal(0, 6, size=n)
        frames[gid] = pd.DataFrame(f)
    return frames


def write_store(path, family, frames, store_cls=JaxSeasonStore):
    """The frames under the reference key layout, with a games table. A
    store lists its games by their standard frames, so an atomic store
    holds both families, as ``build_spadl_store(atomic=True)`` writes."""
    standard = frames if family == 'standard' else draw_frames('standard', len(frames), seed=99)
    with store_cls(path, mode='w') as store:
        for (gid, frame), std in zip(frames.items(), standard.values()):
            if family == 'standard':
                store.put_actions(gid, frame)
            else:
                store.put_actions(gid, std.assign(game_id=gid))
                store.put_atomic_actions(gid, frame)
        store.put('games', pd.DataFrame({
            'game_id': list(frames),
            'home_team_id': [10 + 2 * g for g in range(len(frames))],
        }))
    return path


def store_path(tmp_path, engine, name='store'):
    return str(tmp_path / (f'{name}.h5' if engine == 'hdf5' else name))


def assert_batch_equal(got, want):
    """Every field of the port's batch equals the JAX package's (or
    another port batch's): same dtype, shape and values."""
    for name in got.fields():
        a = got.fields()[name]
        a = a.numpy() if isinstance(a, torch.Tensor) else np.asarray(a)
        b = getattr(want, name)
        b = b.numpy() if isinstance(b, torch.Tensor) else np.asarray(b)
        assert a.dtype == b.dtype, (name, a.dtype, b.dtype)
        assert a.shape == b.shape, (name, a.shape, b.shape)
        np.testing.assert_array_equal(a, b, err_msg=name)


def assert_streams_equal(got, want):
    got, want = list(got), list(want)
    assert [ids for _, ids in got] == [ids for _, ids in want]
    assert len(got) == len(want) > 0
    for (a, _), (b, _) in zip(got, want):
        assert_batch_equal(a, b)


@pytest.fixture(scope='module', params=[(e, f) for e in ENGINES for f in FAMILIES],
                ids=lambda p: f'{p[0]}-{p[1]}')
def store(request, tmp_path_factory):
    """(engine, family, path) of a store the JAX package wrote."""
    engine, family = request.param
    path = store_path(tmp_path_factory.mktemp(f'{engine}-{family}'), engine)
    write_store(path, family, draw_frames(family, seed=len(family)))
    return engine, family, path


def test_load_batch_matches_jax(store):
    engine, family, path = store
    with JaxSeasonStore(path, mode='r') as js, SeasonStore(path, mode='r') as ts:
        assert ts.engine == engine and ts.game_ids() == js.game_ids()
        want, want_ids = jax_load_batch(js, family=family)
        got, got_ids = load_batch(ts, family=family, device='cpu')
        subset = ts.game_ids()[3:7][::-1]
        want_sub, _ = jax_load_batch(js, subset, max_actions=384, family=family)
        got_sub, got_sub_ids = load_batch(ts, subset, max_actions=384, family=family, device='cpu')
    assert got_ids == want_ids and got_sub_ids == subset
    assert_batch_equal(got, want)
    assert_batch_equal(got_sub, want_sub)


@pytest.mark.parametrize('prefetch', [0, 2])
@pytest.mark.parametrize('path_kind', ['store', 'cache', 'overlapped'])
def test_iter_batches_matches_jax(store, tmp_path, path_kind, prefetch):
    """Same chunks, same ids, bitwise the same fields, on each of the
    feed's paths. On the cache path both packages read one cache (the
    port's build); on the overlapped path each builds its own."""
    engine, family, path = store
    kw = dict(max_actions=MAX_ACTIONS, family=family)
    with JaxSeasonStore(path, mode='r') as js, SeasonStore(path, mode='r') as ts:
        want = list(jax_iter_batches(js, 4, **kw))
        if path_kind == 'store':
            got = iter_batches(ts, 4, prefetch=prefetch, device='cpu', **kw)
        elif path_kind == 'cache':
            cache = str(tmp_path / 'cache')
            list(iter_batches(ts, 4, packed_cache=cache, device='cpu', **kw))  # builds
            assert os.path.isfile(os.path.join(cache, 'meta.json'))
            want = list(jax_iter_batches(js, 4, packed_cache=cache, **kw))
            got = iter_batches(ts, 4, packed_cache=cache, prefetch=prefetch, device='cpu', **kw)
        else:
            cache = str(tmp_path / 'port-cache')
            got = list(iter_batches(ts, 4, packed_cache=cache, prefetch=prefetch, device='cpu',
                                    **kw))
            assert os.path.isfile(os.path.join(cache, 'meta.json'))
        assert_streams_equal(got, want)


def test_iter_batches_static_shapes_and_drop_remainder(store):
    engine, family, path = store
    with JaxSeasonStore(path, mode='r') as js, SeasonStore(path, mode='r') as ts:
        kw = dict(max_actions=384, family=family, drop_remainder=True)
        want = list(jax_iter_batches(js, 3, **kw))
        got = list(iter_batches(ts, 3, device='cpu', **kw))
    assert [b.type_id.shape for b, _ in got] == [(3, 384)] * 3
    assert_streams_equal(got, want)


@pytest.mark.parametrize('family', FAMILIES)
def test_pack_as_numpy_matches_jax(family):
    """The host staging pack (``as_numpy=True``) is the JAX package's,
    field by field: numpy arrays, no device copy."""
    frames = draw_frames(family, n_games=3, seed=5)
    frame = pd.concat(frames.values(), ignore_index=True)
    homes = {gid: 10 + 2 * i for i, gid in enumerate(frames)}
    jpack = jbatch.pack_actions if family == 'standard' else jbatch.pack_atomic_actions
    tpack = tbatch.pack_actions if family == 'standard' else tbatch.pack_atomic_actions
    want, want_ids = jpack(frame, homes, max_actions=MAX_ACTIONS, as_numpy=True)
    got, got_ids = tpack(frame, homes, max_actions=MAX_ACTIONS, as_numpy=True)
    assert got_ids == want_ids
    assert all(isinstance(a, np.ndarray) for a in got.fields().values())
    assert_batch_equal(got, want)
    with pytest.raises(ValueError, match='mutually exclusive'):
        tpack(frame, homes, as_numpy=True, device='cpu')


@pytest.mark.parametrize('family', FAMILIES)
def test_astype_matches_jax(family):
    """A float64 pack cast to float32 equals the JAX package's float32
    pack (and, for the standard family, its own ``astype``)."""
    frames = draw_frames(family, n_games=2, seed=6)
    frame = pd.concat(frames.values(), ignore_index=True)
    homes = {gid: 10 + 2 * i for i, gid in enumerate(frames)}
    jpack = jbatch.pack_actions if family == 'standard' else jbatch.pack_atomic_actions
    tpack = tbatch.pack_actions if family == 'standard' else tbatch.pack_atomic_actions
    want = jpack(frame, homes, float_dtype=np.float32)[0]
    got = tpack(frame, homes, float_dtype=np.float64, device='cpu')[0].astype('float32')
    assert_batch_equal(got, want)
    if family == 'standard':
        assert_batch_equal(got, jpack(frame, homes, float_dtype=np.float64)[0].astype(np.float32))
    assert got.astype(torch.float64).time_seconds.dtype == torch.float64


def test_bucket_ladder_matches_jax():
    for n in (1, 2, 3, 5, 64, 100):
        assert tbatch.bucket_ladder(n) == jbatch.bucket_ladder(n)


# -- the prefetch worker ----------------------------------------------------------------


@pytest.fixture
def small_store(tmp_path):
    return write_store(str(tmp_path / 'small'), 'standard', draw_frames('standard', 6, seed=9),
                       store_cls=SeasonStore)


def test_prefetch_error_is_reraised_on_the_consumer(small_store):
    """A game missing from the store fails its chunk; with prefetch the
    error is raised where the consumer takes that chunk."""
    with SeasonStore(small_store, mode='r') as ts:
        ids = ts.game_ids()
        it = iter_batches(ts, 1, game_ids=[ids[0], 999_999], max_actions=MAX_ACTIONS,
                          prefetch=2, device='cpu')
        batch, got = next(it)
        assert got == [ids[0]]
        with pytest.raises(KeyError, match='999999'):
            next(it)


def _live_workers(timeout=10.0):
    deadline = time.monotonic() + timeout
    while True:
        alive = [t for t in threading.enumerate() if t.name == 'iter_batches']
        if not alive or time.monotonic() > deadline:
            return alive
        time.sleep(0.05)


def test_early_close_retires_the_worker(small_store):
    with SeasonStore(small_store, mode='r') as ts:
        it = iter_batches(ts, 1, max_actions=MAX_ACTIONS, prefetch=2, device='cpu')
        next(it)
        it.close()  # what a `break` does
        assert not _live_workers(), 'the prefetch worker outlived an early close'


def test_feed_records_its_stages(small_store):
    """The JAX package's metric names: the stage series and the queue
    depth gauge."""
    snap0 = REGISTRY.snapshot()

    def count(snap, stage):
        s = snap.series('pipeline/stage_seconds', stage=stage)
        return s.count if s else 0

    with SeasonStore(small_store, mode='r') as ts:
        list(iter_batches(ts, 2, max_actions=MAX_ACTIONS, prefetch=2, device='cpu'))
    snap = REGISTRY.snapshot()
    for stage, n in (('read', 3), ('read_io', 6), ('decode', 3), ('pack', 3), ('transfer', 3),
                     ('feed_wait', 4)):
        assert count(snap, stage) - count(snap0, stage) == n, stage
    assert snap.get('pipeline/feed_queue_depth').unit == 'chunks'


def test_shipped_batches_are_claimed_weakly(small_store):
    """Every shipped batch counts under ``pipeline_feed`` until the
    consumer drops it."""
    gc.collect()
    base = owned_bytes().get('pipeline_feed', 0)
    with SeasonStore(small_store, mode='r') as ts:
        held = list(iter_batches(ts, 2, max_actions=MAX_ACTIONS, prefetch=2, device='cpu'))
    nbytes = sum(t.nbytes for b, _ in held for t in b.fields().values())
    assert owned_bytes()['pipeline_feed'] - base == nbytes
    del held
    gc.collect()
    assert owned_bytes().get('pipeline_feed', 0) == base == 0


def test_a_transient_read_fault_is_retried(small_store):
    """One injected OSError at ``ingest.read`` is retried (the store's
    READ_RETRY) and the batch comes back unchanged."""
    with SeasonStore(small_store, mode='r') as ts:
        want, _ = load_batch(ts, device='cpu')
        before = REGISTRY.snapshot().value('resil/retries', site='ingest.read', outcome='recovered')
        plan = FaultPlan(seed=0, specs=[FaultSpec('ingest.read', error=OSError, nth=2)])
        with plan:
            got, _ = load_batch(ts, device='cpu')
        after = REGISTRY.snapshot().value('resil/retries', site='ingest.read', outcome='recovered')
    assert len(plan.history) == 1 and after - before == 1
    assert_batch_equal(got, want)


def test_ship_host_batch_rejects_interleaved_frames():
    """Interleaved games keep frame-order row ids, which the wire's
    rebuilt row_index cannot reproduce: refused, as in the JAX package."""
    frames = draw_frames('standard', 2, seed=4)
    a, b = frames.values()
    interleaved = pd.concat([a.iloc[:10], b.iloc[:10], a.iloc[10:], b.iloc[10:]],
                            ignore_index=True)
    host, _ = tbatch.pack_actions(interleaved, {a.game_id[0]: 10, b.game_id[0]: 12},
                                  as_numpy=True)
    with pytest.raises(ValueError, match='contiguous row run'):
        ship_host_batch(host, device='cpu')


def test_ship_host_batch_widens_the_wire_for_large_ids(tmp_path):
    """Ids past int8 ship as int32 and arrive exact, as the JAX package's."""
    path = write_store(str(tmp_path / 'wide'), 'standard',
                       draw_frames('standard', 3, seed=8, type_high=400))
    with JaxSeasonStore(path, mode='r') as js, SeasonStore(path, mode='r') as ts:
        want, _ = jax_load_batch(js)
        got, _ = load_batch(ts, device='cpu')
    assert int(got.type_id.max()) > 127
    assert_batch_equal(got, want)


# -- build_spadl_store ---------------------------------------------------------------


def test_build_spadl_store_matches_jax(tmp_path):
    """The same loader and converter through both packages write the same
    store (the port has no converters yet: the test passes the JAX
    package's)."""
    loader = StatsBombLoader(getter='local', root=DATA_DIR)
    convert = jax_statsbomb.convert_to_actions
    with JaxSeasonStore(str(tmp_path / 'jax'), mode='w') as js:
        jax_build_spadl_store(loader, js, convert=convert)
    with SeasonStore(str(tmp_path / 'port'), mode='w') as ts:
        build_spadl_store(loader, ts, convert=convert)
    with JaxSeasonStore(str(tmp_path / 'jax'), mode='r') as js, \
            SeasonStore(str(tmp_path / 'port'), mode='r') as ts:
        assert ts.keys() == js.keys()
        for key in js.keys():
            pd.testing.assert_frame_equal(ts.get(key), js.get(key), check_dtype=True)
        want, _ = jax_load_batch(js)
        got, _ = load_batch(ts, device='cpu')
    assert_batch_equal(got, want)


def test_build_spadl_store_names_the_missing_converter(tmp_path):
    loader = StatsBombLoader(getter='local', root=DATA_DIR)
    with SeasonStore(str(tmp_path / 'port'), mode='w') as ts:
        with pytest.raises(ValueError, match='spadl.statsbomb.convert_to_actions'):
            build_spadl_store(loader, ts)
        with pytest.raises(ValueError, match='Atomic-SPADL converter'):
            build_spadl_store(loader, ts, convert=jax_statsbomb.convert_to_actions, atomic=True)
