"""Feed stored seasons to the card as packed batch chunks.

Port of the JAX package's ``socceraction_tpu/pipeline/feed.py``. The
streaming path (:func:`iter_batches`) is a staged, double-bufferable
feed:

1. **read** — the next chunk's per-game files are fetched and decoded
   through :meth:`SeasonStore.get_concat` (``stage=read``), or, from the
   packed cache, memmap rows are gathered into pinned wire buffers
   (``stage=read_cache``);
2. **pack** — store frames are packed into a host *staging* batch
   (``as_numpy=True``, ``stage=pack``);
3. **transfer** — the wire (stacked floats, int8-narrowed ids, flags,
   lengths) is copied to the card on its copy stream and rebuilt there
   (:func:`~socceraction_tpu_torch.pipeline.packed.ship_host_batch`,
   :meth:`~socceraction_tpu_torch.pipeline.packed.PackedSeason.take`;
   ``stage=transfer``).

With ``prefetch > 0`` a worker thread runs all three stages ahead through
a bounded queue, so the copies of batch N+1 overlap the consumer's
kernels on batch N even when the consumer blocks on results. The worker
makes the card its current device and the copy stream its current
stream itself (both are per thread in PyTorch); the consumer's stream
waits on each batch's ``ready`` event as the batch is handed over. The
queue depth at every consumer take goes to the
``pipeline/feed_queue_depth`` gauge, and the time the consumer is
*blocked* on the queue to ``stage=feed_wait`` — the direct measure of a
host-bound feed. The worker is cancelled (stop event + queue drain) when
the consumer closes the generator early; its errors are re-raised on the
consumer.
"""

from __future__ import annotations

from typing import Any, Iterator, List, Optional, Sequence, Tuple

from ..device import DeviceLike, resolve_device
from ..obs import gauge, span, timed_labels
from .store import SeasonStore

__all__ = ['load_batch', 'iter_batches']


def load_batch(
    store: SeasonStore,
    game_ids: Optional[Sequence[Any]] = None,
    *,
    max_actions: Optional[int] = None,
    float_dtype: Any = 'float32',
    device: DeviceLike = None,
    family: str = 'standard',
) -> Tuple[Any, List[Any]]:
    """Pack the given stored games (default: all) into one batch on
    ``device`` (default ``cuda``).

    ``family='standard'`` reads ``actions/game_<id>`` into an
    ``ActionBatch``; ``family='atomic'`` reads ``atomic_actions/game_<id>``
    into an ``AtomicActionBatch``. The frames are shipped over the same
    minimal wire as the streaming path.
    """
    from .packed import FAMILIES, _read_and_pack_chunk, ship_host_batch

    dev = resolve_device(device)
    fam = FAMILIES[family]
    if game_ids is None:
        game_ids = store.game_ids()
    game_ids = list(game_ids)
    host = _read_and_pack_chunk(
        store, fam, game_ids, store.home_team_ids(),
        max_actions=max_actions, float_dtype=float_dtype,
    )
    return ship_host_batch(host, family=family, device=dev), game_ids


def iter_batches(
    store: SeasonStore,
    games_per_batch: int,
    *,
    game_ids: Optional[Sequence[Any]] = None,
    max_actions: Optional[int] = None,
    float_dtype: Any = 'float32',
    device: DeviceLike = None,
    drop_remainder: bool = False,
    prefetch: int = 0,
    packed_cache: Any = False,
    family: str = 'standard',
) -> Iterator[Tuple[Any, List[Any]]]:
    """Stream the store in fixed-size game chunks onto ``device`` (default
    ``cuda``).

    With ``max_actions`` set every chunk has the same ``(games_per_batch,
    max_actions)`` shape; ``drop_remainder`` skips the final short chunk.

    ``prefetch > 0`` runs the read → pack → transfer stages up to that
    many chunks ahead on a worker thread (bounded queue); ``prefetch=2``
    is double buffering into device memory. ``prefetch=0`` is the
    synchronous path: same batches, same order, no worker thread.

    ``packed_cache`` (False | True | path) serves chunks from the
    season's packed memmap cache (:mod:`.packed`) instead of re-parsing
    the store. On a miss, a full-season stream (the default ``game_ids``)
    builds the cache *overlapped* with this first pass
    (:func:`~socceraction_tpu_torch.pipeline.build.iter_packed_build`); a
    subset or reordered stream falls back to the serial
    :func:`~socceraction_tpu_torch.pipeline.packed.ensure_packed` build.
    Requires ``max_actions``; batches are bit-identical to the uncached
    path either way.

    ``family`` selects the SPADL family as in :func:`load_batch`; the
    packed cache is per family.
    """
    from .packed import (
        FAMILIES,
        _read_and_pack_chunk,
        ensure_packed,
        hand_over,
        open_packed,
        producer_stream,
        ship_host_batch,
    )

    dev = resolve_device(device)
    fam = FAMILIES[family]
    # the default game_ids is the store's full listing — a directory scan
    # on the parquet engine, deferred until a branch consumes it
    full_season = game_ids is None

    season = None
    overlapped = None
    if packed_cache:
        if max_actions is None:
            raise ValueError('packed_cache requires max_actions')

        import os as _os

        cache_dir = (
            _os.fspath(packed_cache)
            if isinstance(packed_cache, (str, _os.PathLike))
            else None
        )
        season = open_packed(
            store, max_actions=max_actions, float_dtype=float_dtype,
            cache_dir=cache_dir, family=family,
        )
        if season is None:
            if full_season or list(game_ids) == store.game_ids():
                from .build import iter_packed_build

                overlapped = iter_packed_build(
                    store, games_per_batch, max_actions=max_actions,
                    float_dtype=float_dtype, device=dev,
                    drop_remainder=drop_remainder, family=family, cache_dir=cache_dir,
                )
            else:
                season = ensure_packed(
                    store, max_actions=max_actions, float_dtype=float_dtype,
                    cache_dir=cache_dir, family=family,
                )
    if full_season and overlapped is None:
        # a cache hit carries the validated full listing (in the cache's
        # own row order); only the uncached stream scans the store
        game_ids = list(season.game_ids) if season is not None else store.game_ids()
    home = store.home_team_ids() if season is None and overlapped is None else None

    def produce() -> Iterator[Tuple[Any, List[Any]]]:
        if overlapped is not None:
            yield from overlapped
            return
        path = 'cache' if season is not None else 'store'
        for lo in range(0, len(game_ids), games_per_batch):
            chunk = list(game_ids[lo : lo + games_per_batch])
            if drop_remainder and len(chunk) < games_per_batch:
                return
            # yield OUTSIDE the span and the stage timers: with prefetch the
            # generator suspends on the queue put, which would otherwise be
            # charged to a stage
            with span('pipeline/chunk', games=len(chunk), path=path):
                if season is not None:
                    item = season.take(chunk, device=dev)
                else:
                    host = _read_and_pack_chunk(
                        store, fam, chunk, home,
                        max_actions=max_actions, float_dtype=float_dtype,
                    )
                    item = (ship_host_batch(host, family=family, device=dev), chunk)
            yield item

    if prefetch <= 0:
        yield from produce()
        return

    import queue
    import threading

    q: 'queue.Queue' = queue.Queue(maxsize=prefetch)
    _END = object()
    failure: List[BaseException] = []
    stop = threading.Event()

    def _put(item: Any) -> bool:
        """Bounded put that gives up when the consumer signalled stop."""
        while not stop.is_set():
            try:
                q.put(item, timeout=0.1)
                return True
            except queue.Full:
                continue
        return False

    def worker() -> None:
        src = produce()
        try:
            # the card and its copy stream are this thread's current
            # device and stream: a `with` on the consumer's thread does
            # not carry into this one
            with producer_stream(dev):
                for item in src:
                    # re-check stop AFTER a successful put: the consumer's
                    # close-time drain can free a slot, and advancing the
                    # source past its last item would then complete (and
                    # publish) an overlapped build the consumer abandoned
                    if not _put(item) or stop.is_set():
                        return  # consumer closed the generator early
        except BaseException as e:  # re-raised on the consumer thread
            failure.append(e)
        finally:
            # close the source HERE, on the worker thread: the overlapped
            # build then discards a partial cache (or publishes a complete
            # one) deterministically. The END sentinel must go out even if
            # close itself fails, or the consumer hangs on q.get()
            try:
                src.close()
            except BaseException as e:
                if not failure:
                    failure.append(e)
            finally:
                _put(_END)

    threading.Thread(target=worker, daemon=True, name='iter_batches').start()
    try:
        while True:
            gauge('pipeline/feed_queue_depth', unit='chunks').set(q.qsize())
            # feed_wait: the time the CONSUMER was blocked on the queue
            with timed_labels('pipeline/stage_seconds', stage='feed_wait'):
                item = q.get()
            if item is _END:
                if failure:
                    raise failure[0]
                return
            # the consumer's stream waits on the batch's copies
            yield hand_over(item[0]), item[1]
    finally:
        # consumer stopped early: unblock and retire the worker instead of
        # leaking it (and the device batches it holds) on the full queue
        stop.set()
        while True:
            try:
                q.get_nowait()
            except queue.Empty:
                break
