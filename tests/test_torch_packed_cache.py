"""The port's packed-season cache against the JAX package's.

The cache format is shared: each package opens the cache the other
wrote and takes bitwise the same batches from it. The lifecycle is the
JAX package's: a stale store fingerprint, another shape, family or dtype,
or a partial directory reads as a miss; the overlapped first-pass build
publishes when complete and never when closed early; ids past int8 ship
over an int32 wire. Stores are small seeded draws (10 games of 40 to 256
actions, ``tests/test_torch_pipeline.py``); the port runs on the CPU.
"""

import json
import os
import shutil
import socket
from itertools import islice

import numpy as np
import pandas as pd
import pytest
import torch

from socceraction_tpu.pipeline import SeasonStore as JaxSeasonStore
from socceraction_tpu.pipeline import ensure_packed as jax_ensure_packed
from socceraction_tpu.pipeline import iter_batches as jax_iter_batches
from socceraction_tpu.pipeline import load_batch as jax_load_batch
from socceraction_tpu.pipeline.packed import PackedSeason as JaxPackedSeason
from socceraction_tpu_torch.core.synthetic import synthetic_batch
from socceraction_tpu_torch.pipeline import (
    PackedSeason,
    SeasonStore,
    ensure_packed,
    iter_batches,
    open_packed,
)
from socceraction_tpu_torch.pipeline.packed import (
    PackedSeasonWriter,
    hand_over,
    packed_cache_dir,
)
from tests.test_torch_pipeline import (
    FAMILIES,
    MAX_ACTIONS,
    assert_batch_equal,
    assert_streams_equal,
    draw_frames,
    write_store,
)


@pytest.fixture(scope='module', params=FAMILIES)
def store(request, tmp_path_factory):
    """(family, path) of a parquet store the JAX package wrote."""
    family = request.param
    path = str(tmp_path_factory.mktemp(family) / 'store')
    write_store(path, family, draw_frames(family, seed=11))
    return family, path


def test_each_package_opens_the_others_cache(store, tmp_path):
    """The port reads the JAX package's cache and the JAX package the
    port's: the same meta, the same column files, the same batches."""
    family, path = store
    jdir, tdir = str(tmp_path / 'jax-cache'), str(tmp_path / 'port-cache')
    with JaxSeasonStore(path, mode='r') as js, SeasonStore(path, mode='r') as ts:
        jax_ensure_packed(js, max_actions=MAX_ACTIONS, cache_dir=jdir, family=family)
        ensure_packed(ts, max_actions=MAX_ACTIONS, cache_dir=tdir, family=family)
        ids = ts.game_ids()
        subset = [ids[5], ids[0], ids[7], ids[1]]
        for d in (jdir, tdir):
            assert open_packed(ts, max_actions=MAX_ACTIONS, cache_dir=d, family=family) is not None
            want, _ = JaxPackedSeason(d).take(subset)
            got, got_ids = PackedSeason(d).take(subset, device='cpu')
            assert got_ids == subset
            assert_batch_equal(got, want)
            whole, _ = PackedSeason(d).take(ids, device='cpu')
            assert_batch_equal(whole, jax_load_batch(js, max_actions=MAX_ACTIONS, family=family)[0])
    with open(os.path.join(jdir, 'meta.json')) as fh:
        jmeta = json.load(fh)
    with open(os.path.join(tdir, 'meta.json')) as fh:
        tmeta = json.load(fh)
    assert tmeta == jmeta
    assert set(tmeta) >= {'version', 'family', 'int_wire', 'game_ids', 'store_fingerprint'}
    assert sorted(os.listdir(tdir)) == sorted(os.listdir(jdir))
    for name in os.listdir(tdir):
        if name.endswith('.npy'):
            a, b = np.load(os.path.join(tdir, name)), np.load(os.path.join(jdir, name))
            assert a.dtype == b.dtype and np.array_equal(a, b), name


def test_default_cache_location_is_shared(store):
    family, path = store
    from socceraction_tpu.pipeline.packed import packed_cache_dir as jax_packed_cache_dir

    for dtype in ('float32', np.float64):
        assert packed_cache_dir(path, 384, dtype, family) == jax_packed_cache_dir(
            path, 384, dtype, family
        )


def test_a_stale_fingerprint_misses(tmp_path):
    """A store written after the build invalidates the cache; the rebuild
    sees the new game."""
    path = write_store(str(tmp_path / 'store'), 'standard', draw_frames('standard', 4, seed=2))
    with SeasonStore(path, mode='r') as ts:
        season = ensure_packed(ts, max_actions=MAX_ACTIONS)
        assert season.valid_for(path)
    extra = draw_frames('standard', 5, seed=3)
    gid, frame = list(extra.items())[-1]
    with SeasonStore(path, mode='a') as ts:
        ts.put_actions(gid, frame)
        games = ts.games()
        ts.put('games', pd.concat([games, pd.DataFrame([{'game_id': gid, 'home_team_id': 18}])],
                                  ignore_index=True))
    assert not PackedSeason(season.cache_dir).valid_for(path)
    with SeasonStore(path, mode='r') as ts:
        assert open_packed(ts, max_actions=MAX_ACTIONS) is None
        rebuilt = ensure_packed(ts, max_actions=MAX_ACTIONS)
    assert rebuilt.valid_for(path) and gid in rebuilt.game_ids
    # the JAX package sees the same: its open of the port's rebuild is valid
    assert JaxPackedSeason(rebuilt.cache_dir).valid_for(path)


def test_another_shape_family_or_dtype_misses(store, tmp_path):
    family, path = store
    cache = str(tmp_path / 'cache')
    other = 'atomic' if family == 'standard' else 'standard'
    with SeasonStore(path, mode='r') as ts:
        ensure_packed(ts, max_actions=MAX_ACTIONS, cache_dir=cache, family=family)
        assert open_packed(ts, max_actions=384, cache_dir=cache, family=family) is None
        assert open_packed(ts, max_actions=MAX_ACTIONS, cache_dir=cache, family=other) is None
        assert open_packed(ts, max_actions=MAX_ACTIONS, float_dtype='float64', cache_dir=cache,
                           family=family) is None
        rebuilt = ensure_packed(ts, max_actions=384, cache_dir=cache, family=family)
    assert rebuilt.max_actions == 384


def test_a_partial_cache_reads_as_a_miss(tmp_path):
    path = write_store(str(tmp_path / 'store'), 'standard', draw_frames('standard', 3, seed=4))
    with SeasonStore(path, mode='r') as ts:
        season = ensure_packed(ts, max_actions=MAX_ACTIONS)
        os.unlink(os.path.join(season.cache_dir, 'meta.json'))
        assert open_packed(ts, max_actions=MAX_ACTIONS) is None
        rebuilt = ensure_packed(ts, max_actions=MAX_ACTIONS)
        assert rebuilt.valid_for(path)
        with pytest.raises(ValueError, match='requires max_actions'):
            next(iter_batches(ts, 2, packed_cache=True, device='cpu'))


def test_ids_past_int8_take_the_int32_wire(tmp_path):
    """The wire dtype is a property of the cache, decided at build time;
    a cache without it (an older build) is scanned once and the answer
    persisted. Values are exact either way."""
    path = write_store(str(tmp_path / 'store'), 'standard',
                       draw_frames('standard', 4, seed=8, type_high=400))
    with JaxSeasonStore(path, mode='r') as js, SeasonStore(path, mode='r') as ts:
        season = ensure_packed(ts, max_actions=MAX_ACTIONS)
        assert season.meta['int_wire'] == 'int32'
        want, _ = jax_load_batch(js, max_actions=MAX_ACTIONS)
        got, _ = season.take(season.game_ids, device='cpu')
        assert int(got.type_id.max()) > 127
        assert_batch_equal(got, want)
        meta_path = os.path.join(season.cache_dir, 'meta.json')
        with open(meta_path) as fh:
            meta = json.load(fh)
        del meta['int_wire']
        with open(meta_path, 'w') as fh:
            json.dump(meta, fh)
        legacy = PackedSeason(season.cache_dir)
        assert legacy.meta['int_wire'] == 'int32'
        with open(meta_path) as fh:
            assert json.load(fh)['int_wire'] == 'int32'
        assert_batch_equal(legacy.take(legacy.game_ids, device='cpu')[0], want)
    small = write_store(str(tmp_path / 'small'), 'standard', draw_frames('standard', 2, seed=9))
    with SeasonStore(small, mode='r') as ts:
        assert ensure_packed(ts, max_actions=MAX_ACTIONS).meta['int_wire'] == 'int8'


def _building_dirs(cache):
    parent = os.path.dirname(cache)
    return [d for d in os.listdir(parent) if d.startswith(os.path.basename(cache) + '.building')]


def test_an_early_closed_overlapped_build_publishes_nothing(tmp_path):
    """Synchronously (prefetch=0) a close after the first of three chunks
    is an incomplete build: nothing is published and no temp directory
    stays. With prefetch the worker may have written every chunk before
    the close landed; then only a complete cache may publish, and it must
    match the store."""
    import time

    path = write_store(str(tmp_path / 'store'), 'standard', draw_frames('standard', 6, seed=5))
    cache = str(tmp_path / 'cache')
    with SeasonStore(path, mode='r') as ts:
        it = iter_batches(ts, 2, max_actions=MAX_ACTIONS, packed_cache=cache, device='cpu')
        next(it)
        it.close()
        assert not os.path.exists(cache) and not _building_dirs(cache)

        it = iter_batches(ts, 2, max_actions=MAX_ACTIONS, packed_cache=cache, prefetch=2,
                          device='cpu')
        next(it)
        it.close()
        deadline = time.monotonic() + 10  # the worker retires asynchronously
        while _building_dirs(cache) and time.monotonic() < deadline:
            time.sleep(0.05)
        assert not _building_dirs(cache)
        if os.path.exists(cache):
            season = PackedSeason(cache)
            assert_batch_equal(season.take(season.game_ids, device='cpu')[0],
                               load_or_jax(path)[0])


def test_a_complete_overlapped_build_publishes(tmp_path):
    """A full pass publishes; so does a close right after the last batch,
    and a drop_remainder pass whose tail was written before the last yield."""
    path = write_store(str(tmp_path / 'store'), 'standard', draw_frames('standard', 5, seed=6))
    with JaxSeasonStore(path, mode='r') as js, SeasonStore(path, mode='r') as ts:
        want = list(jax_iter_batches(js, 2, max_actions=MAX_ACTIONS))
        full = str(tmp_path / 'full')
        assert_streams_equal(
            iter_batches(ts, 2, max_actions=MAX_ACTIONS, packed_cache=full, device='cpu'), want
        )
        assert os.path.isfile(os.path.join(full, 'meta.json'))
        last = str(tmp_path / 'last')
        it = iter_batches(ts, 2, max_actions=MAX_ACTIONS, packed_cache=last, device='cpu')
        assert len(list(islice(it, 3))) == 3
        it.close()
        assert os.path.isfile(os.path.join(last, 'meta.json'))
        tail = str(tmp_path / 'tail')
        it = iter_batches(ts, 2, max_actions=MAX_ACTIONS, packed_cache=tail, drop_remainder=True,
                          device='cpu')
        assert len(list(islice(it, 2))) == 2
        it.close()
        season = PackedSeason(tail)
        assert season.game_ids == ts.game_ids()
        assert_batch_equal(season.take(season.game_ids, device='cpu')[0],
                           jax_load_batch(js, max_actions=MAX_ACTIONS)[0])
        assert not _building_dirs(tail)


def test_a_subset_stream_on_a_miss_builds_serially(tmp_path):
    path = write_store(str(tmp_path / 'store'), 'standard', draw_frames('standard', 5, seed=7))
    with JaxSeasonStore(path, mode='r') as js, SeasonStore(path, mode='r') as ts:
        subset = ts.game_ids()[::-2]
        kw = dict(game_ids=subset, max_actions=MAX_ACTIONS)
        got = iter_batches(ts, 2, packed_cache=True, device='cpu', **kw)
        assert_streams_equal(got, jax_iter_batches(js, 2, **kw))
        assert os.path.isdir(packed_cache_dir(path, MAX_ACTIONS, 'float32'))


def test_seed_from_copies_packed_rows(tmp_path):
    """An append-only rebuild copies the old cache's rows by game id and
    reads only the new games."""
    frames = draw_frames('standard', 5, seed=12)
    first = dict(list(frames.items())[:3])
    path = write_store(str(tmp_path / 'store'), 'standard', first, store_cls=SeasonStore)
    with SeasonStore(path, mode='r') as ts:
        old = ensure_packed(ts, max_actions=MAX_ACTIONS, cache_dir=str(tmp_path / 'old'))
    write_store(path, 'standard', frames, store_cls=SeasonStore)
    with SeasonStore(path, mode='r') as ts:
        writer = PackedSeasonWriter(ts, max_actions=MAX_ACTIONS, cache_dir=str(tmp_path / 'new'))
        assert writer.seed_from(old) == 3
        writer.write_missing(ts)
        new = writer.finalize()
        want, _ = load_or_jax(path)
    assert_batch_equal(new.take(new.game_ids, device='cpu')[0], want)


def load_or_jax(path):
    with JaxSeasonStore(path, mode='r') as js:
        return jax_load_batch(js, max_actions=MAX_ACTIONS)


def test_dead_builds_are_swept(tmp_path):
    path = write_store(str(tmp_path / 'store'), 'standard', draw_frames('standard', 2, seed=13))
    cache = str(tmp_path / 'cache')
    host = ''.join(ch for ch in socket.gethostname() if ch.isalnum())[:32] or 'host'
    dead = f'{cache}.building.{host}-{2 ** 22 + 12345}.0'
    os.makedirs(dead)
    with SeasonStore(path, mode='r') as ts:
        ensure_packed(ts, max_actions=MAX_ACTIONS, cache_dir=cache)
    assert not os.path.exists(dead)


class _ArrayStore:
    """A stand-in store over arrays, as the card's smoke run uses."""

    def __init__(self, path, n_games):
        os.makedirs(path)
        self.path = path
        self.n_games = n_games

    def game_ids(self):
        return list(range(self.n_games))

    def home_team_ids(self):
        return {g: 0 for g in range(self.n_games)}


def test_a_cache_written_from_arrays_reads_in_both_packages(tmp_path):
    """The card has no parquet reader: its caches are written from a
    draw through a stand-in store. The JAX package takes the same batch
    from it, and the port's feed streams it."""
    draw = synthetic_batch(6, 256, fill=0.75, seed=3, device='cpu')
    store = _ArrayStore(str(tmp_path / 'store'), 6)
    writer = PackedSeasonWriter(store, max_actions=256, cache_dir=str(tmp_path / 'cache'))
    for lo in (0, 3):
        writer.write_chunk(lo, type(draw)(**{n: t[lo:lo + 3] for n, t in draw.fields().items()}))
    season = writer.finalize()
    got, _ = season.take([0, 1, 2, 3, 4, 5], device='cpu')
    want, _ = JaxPackedSeason(season.cache_dir).take([0, 1, 2, 3, 4, 5])
    assert_batch_equal(got, want)
    assert_batch_equal(got, draw)  # the draw's game and row ids are the packer's
    assert got.ready is None and hand_over(got) is got  # nothing to wait for on the CPU
    chunks = list(iter_batches(store, 4, max_actions=256, packed_cache=season.cache_dir,
                               prefetch=2, device='cpu'))
    assert [ids for _, ids in chunks] == [[0, 1, 2, 3], [4, 5]]
    assert torch.equal(chunks[1][0].start_x, draw.start_x[4:])
    shutil.rmtree(str(tmp_path / 'cache'))
