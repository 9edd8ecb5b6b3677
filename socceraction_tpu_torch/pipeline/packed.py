"""Packed-season cache: serve batch chunks from memmaps, onto the card.

Port of the JAX package's ``socceraction_tpu/pipeline/packed.py``. The
season is packed ONCE into exactly the ``(G, A)`` columns a batch holds,
written as one ``.npy`` per column, and later passes slice memmaps — no
parquet, no HDF5, no pandas, no per-game loop. The on-disk format is the
JAX package's, so either package opens the cache the other wrote: one
``.npy`` per family data column (int32 id columns), ``n_actions.npy``,
and ``meta.json`` with ``version``, ``family``, ``max_actions``,
``float_dtype``, ``int_wire``, ``game_ids`` and ``store_fingerprint``.

Only the family's data columns and per-game ``n_actions`` are stored:
packing left-aligns every game, so ``mask`` is
``arange(A) < n_actions[:, None]`` and the chunk-local ``row_index`` is
the running valid-row offset plus the action position — both rebuilt for
ANY game subset.

The read side sends a minimal wire to the card: the float columns as one
stacked array, the id columns narrowed to int8 (every SPADL vocabulary
fits; int32 otherwise), the ``is_home`` flags and the ``(G,)`` lengths —
25 bytes an action in four copies, against 37 bytes an action in 13
copies for the whole batch. On the card:

- :meth:`PackedSeason.take` gathers the memmap rows straight into
  *pinned* host buffers (the id columns narrow to the wire dtype in the
  same gather), so the copies to the card are real asynchronous DMA
  (from pageable memory the CUDA runtime stages the copy and nothing
  overlaps). PyTorch's caching host allocator reuses a pinned block only
  after the copy recorded on it has completed.
- :func:`_ship_wire` issues the four copies and the unpack
  (:func:`_device_unpack`) on a dedicated copy stream
  (:func:`copy_stream`) and records an event there; the batch carries
  that event (``batch.ready``). :func:`hand_over` makes the consumer's
  stream wait on it and calls ``record_stream`` on every field, so the
  caching allocator cannot hand a field's memory to the next chunk while
  the consumer's kernels still read it.

On the CPU the same wire is built in ordinary memory and unpacked there.

Validity: the cache records a fingerprint of the backing store (size +
mtime, summed over files for directory stores) plus the packed shape and
dtype; a store rewrite or another ``max_actions``/``float_dtype`` misses
and rebuilds. Builds go to a temp directory and are published with one
``os.replace``, so an interrupted build is never mistaken for a cache.
"""

from __future__ import annotations

import contextlib
import itertools
import json
import os
import shutil
import threading
from typing import Any, Dict, Iterator, List, Optional, Sequence, Tuple

import numpy as np
import torch

from ..core.batch import (
    ActionBatch,
    AtomicActionBatch,
    pack_actions,
    pack_atomic_actions,
    torch_dtype,
)
from ..device import DeviceLike, resolve_device
from ..obs import claim_bytes, timed_labels
from .store import SeasonStore

__all__ = [
    'FAMILIES',
    'PackedSeason',
    'PackedSeasonWriter',
    'copy_stream',
    'ensure_packed',
    'hand_over',
    'open_packed',
    'packed_cache_dir',
    'ship_host_batch',
]

_VERSION = 1


class _Family:
    """Column layout + packing recipe of one action family."""

    def __init__(
        self,
        name: str,
        float_cols: Tuple[str, ...],
        int_cols: Tuple[str, ...],
        batch_cls: Any,
        packer: Any,
        key_prefix: str,
    ) -> None:
        self.name = name
        self.float_cols = float_cols
        self.int_cols = int_cols
        self.bool_cols = ('is_home',)
        self.all_cols = float_cols + int_cols + self.bool_cols
        self.batch_cls = batch_cls
        self.packer = packer
        self.key_prefix = key_prefix  # store key group of the per-game frames
        #: the columns the packer actually touches — streamed reads
        #: project to these so the engines never decode the rest
        #: (player ids, event ids, ...): game grouping, the is_home
        #: source, then the packed columns themselves
        self.read_columns = ('game_id', 'team_id') + float_cols + int_cols

    def game_keys(self, game_ids: Sequence[Any]) -> List[str]:
        """Store keys of these games' frames, for batched ``get_many``."""
        return [f'{self.key_prefix}/game_{gid}' for gid in game_ids]


#: The two SPADL families the pipeline can stream and cache. Column sets
#: mirror ``core/batch.py`` (``_FLOAT_COLS``/``_ATOMIC_FLOAT_COLS`` etc.).
FAMILIES = {
    'standard': _Family(
        'standard',
        ('time_seconds', 'start_x', 'start_y', 'end_x', 'end_y'),
        ('type_id', 'result_id', 'bodypart_id', 'period_id'),
        ActionBatch, pack_actions, 'actions',
    ),
    'atomic': _Family(
        'atomic',
        ('time_seconds', 'x', 'y', 'dx', 'dy'),
        ('type_id', 'bodypart_id', 'period_id'),
        AtomicActionBatch, pack_atomic_actions, 'atomic_actions',
    ),
}


def require_chunk_ids(got: Sequence[Any], want: Sequence[Any]) -> None:
    """Packing a chunk must return exactly the requested games, in order.

    A game whose stored frame is empty (or whose ``game_id`` column
    disagrees with its store key) silently vanishes from the packer's
    factorize; rows written to the cache or yielded under the wrong game
    would follow. The writer and the streaming feed fail loudly instead.
    """
    if list(got) != list(want):
        raise ValueError(
            f'packed games {list(got)!r} != requested chunk {list(want)!r}: '
            'a game frame is empty, missing, or mislabelled in the store'
        )


def _read_and_pack_chunk(
    store: SeasonStore,
    fam: '_Family',
    chunk: Sequence[Any],
    home: Dict[Any, Any],
    *,
    max_actions: Optional[int],
    float_dtype: Any,
) -> Any:
    """One chunk's projected store read + host-staging pack, id-verified.

    The single definition keeps the cache builds and the streamed feed
    bit-identical: every path reads the same projected columns, packs
    with the same arguments, and fails loudly on a missing, empty or
    mislabelled game. Stage costs land under ``stage=read`` and
    ``stage=pack`` of the ``pipeline/stage_seconds`` histogram.
    """
    with timed_labels('pipeline/stage_seconds', stage='read'):
        actions = store.get_concat(fam.game_keys(chunk), columns=fam.read_columns)
    with timed_labels('pipeline/stage_seconds', stage='pack'):
        host, ids = fam.packer(
            actions,
            {gid: home[gid] for gid in chunk},
            max_actions=max_actions,
            float_dtype=float_dtype,
            as_numpy=True,
        )
    require_chunk_ids(ids, chunk)
    return host


#: distinguishes concurrent writers within one process (an early-closed
#: overlapped build aborts asynchronously and must never rmtree a newer
#: sibling's identically-named temp directory)
_BUILD_SEQ = itertools.count()


def _host_tag() -> str:
    """Alphanumeric host token for build temp names (pids are only
    meaningful on the host that issued them)."""
    import socket

    return ''.join(ch for ch in socket.gethostname() if ch.isalnum())[:32] or 'host'


def _sweep_dead_builds(cache_dir: str) -> None:
    """Reclaim ``{cache_dir}.building.<host>-<pid>.<seq>`` orphans.

    A killed build skips :meth:`PackedSeasonWriter.abort`, and the
    per-process sequence suffix means no later writer reuses the name.
    Only this host's directories are judged; directories whose pid is
    alive or unverifiable belong to a possibly live build and stay.
    """
    import glob

    prefix = f'{cache_dir}.building.'
    host = _host_tag()
    for path in glob.glob(f'{glob.escape(prefix)}*'):
        token = path[len(prefix):].split('.', 1)[0]
        owner, sep, pid_s = token.rpartition('-')
        if not sep or owner != host:
            continue  # another host's build (or unknown format)
        try:
            pid = int(pid_s)
        except ValueError:
            continue
        if pid == os.getpid():
            continue  # a live sibling writer in this very process
        try:
            os.kill(pid, 0)
        except ProcessLookupError:
            shutil.rmtree(path, ignore_errors=True)
        except OSError:
            continue  # e.g. EPERM: pid alive under another user


def _store_fingerprint(path: str) -> Dict[str, int]:
    """Cheap change-detection for a store file or directory."""
    if os.path.isfile(path):
        st = os.stat(path)
        return {'size': st.st_size, 'mtime_ns': st.st_mtime_ns}
    size = 0
    mtime = 0
    for dirpath, _dirs, files in os.walk(path):
        for name in files:
            st = os.stat(os.path.join(dirpath, name))
            size += st.st_size
            mtime = max(mtime, st.st_mtime_ns)
    return {'size': size, 'mtime_ns': mtime}


def packed_cache_dir(
    store_path: str, max_actions: int, float_dtype: Any, family: str = 'standard'
) -> str:
    """Default sidecar location, keyed by family, packed shape and dtype."""
    dt = np.dtype(float_dtype).name
    base = store_path.rstrip('/').rstrip(os.sep)
    fam = '' if family == 'standard' else f'-{family}'
    return f'{base}.packed-v{_VERSION}{fam}-a{int(max_actions)}-{dt}'


def _rows(idx: np.ndarray) -> Any:
    """A slice for an ascending run of consecutive rows (a memmap view,
    read once), else the index array itself (a gather)."""
    if len(idx) and idx[-1] - idx[0] == len(idx) - 1 and np.all(np.diff(idx) == 1):
        return slice(int(idx[0]), int(idx[-1]) + 1)
    return idx


class PackedSeason:
    """Read side of the cache: memmapped columns + slice-to-batch."""

    def __init__(self, cache_dir: str) -> None:
        self.cache_dir = cache_dir
        with open(os.path.join(cache_dir, 'meta.json'), encoding='utf-8') as fh:
            self.meta = json.load(fh)
        self.family = FAMILIES[self.meta.get('family', 'standard')]
        self.max_actions = int(self.meta['max_actions'])
        self.float_dtype = np.dtype(self.meta['float_dtype'])
        self.game_ids: List[Any] = list(self.meta['game_ids'])
        self._pos = {gid: i for i, gid in enumerate(self.game_ids)}
        # copy-on-write maps: read-only on disk, but writable arrays, which
        # torch.from_numpy views without a copy (or a warning)
        self._cols = {
            c: np.load(os.path.join(cache_dir, f'{c}.npy'), mmap_mode='c')
            for c in self.family.all_cols
        }
        self.n_actions = np.load(os.path.join(cache_dir, 'n_actions.npy'))
        # the id columns' wire dtype is a property of the CACHE, decided at
        # build time (meta), or by one scan here for caches written before
        # the key existed — never per take()
        wire = self.meta.get('int_wire')
        if wire is None:
            wire = _int_wire_name(self._cols[c] for c in self.family.int_cols)
            # persist the scanned answer so a legacy cache pays the scan
            # once; atomically, and best-effort (a read-only cache simply
            # scans again next open). pid alone is not unique: a prefetch
            # worker and the main thread may open the same cache at once
            self.meta['int_wire'] = wire
            tmp = os.path.join(
                cache_dir, f'meta.json.tmp.{os.getpid()}.{threading.get_ident()}'
            )
            try:
                with open(tmp, 'w', encoding='utf-8') as fh:
                    json.dump(self.meta, fh)
                os.replace(tmp, os.path.join(cache_dir, 'meta.json'))
            except OSError:
                # never strand the temp file inside the published cache
                try:
                    os.unlink(tmp)
                except OSError:
                    pass
        self._int_wire = np.dtype(wire)

    def valid_for(self, store_path: str) -> bool:
        """True while the backing store is unchanged since the build."""
        return self.meta.get('store_fingerprint') == _store_fingerprint(store_path)

    def take(
        self, game_ids: Sequence[Any], *, device: DeviceLike = None
    ) -> Tuple[Any, List[Any]]:
        """Build the batch for these games (any subset, any order) on
        ``device`` (default ``cuda``).

        Bit-identical to packing the same games' frames with the family's
        packer at the cached ``max_actions``/``float_dtype``. The memmap
        rows are gathered into the wire buffers (pinned on the card's
        path) under ``stage=read_cache``; the copies and the unpack are
        issued under ``stage=transfer`` of ``pipeline/stage_seconds``.

        The gather is torch's ``copy_``/``index_select``, which run without
        the interpreter lock (a numpy assignment holds it for the whole
        copy), so a prefetch worker's gather leaves the consumer's Python
        free to run.
        """
        dev = resolve_device(device)
        fam = self.family
        with timed_labels('pipeline/stage_seconds', stage='read_cache'):
            idx = np.asarray([self._pos[g] for g in game_ids], dtype=np.int64)
            rows = _rows(idx)
            if not isinstance(rows, slice):
                rows = torch.from_numpy(rows)
            wire = _wire_buffers(
                fam, len(idx), self.max_actions, self.float_dtype, self._int_wire,
                pinned=dev.type == 'cuda',
            )
            floats, ints, is_home, n_act = wire
            sources = [(floats[i], c) for i, c in enumerate(fam.float_cols)]
            sources += [(ints[i], c) for i, c in enumerate(fam.int_cols)]  # int32 -> wire dtype
            sources.append((is_home, 'is_home'))
            for dst, c in sources:
                dst.copy_(_gather(torch.from_numpy(self._cols[c]), rows))
            n_act.copy_(_gather(torch.from_numpy(self.n_actions), rows))
        with timed_labels('pipeline/stage_seconds', stage='transfer'):
            batch = _ship_wire(fam, wire, dev)
        return batch, list(game_ids)


def _gather(src: torch.Tensor, rows: Any) -> torch.Tensor:
    """Rows of ``src``: a view for a slice, a gather for an index tensor."""
    return src[rows] if isinstance(rows, slice) else src.index_select(0, rows)


def _int_wire_name(int_cols: Any) -> str:
    """``'int8'`` when every id column fits, else ``'int32'``.

    Every SPADL vocabulary fits int8; a store with exotic ids ships
    int32 (correct, merely wider on the wire).
    """
    for col in int_cols:
        if col.size and (col.min() < -128 or col.max() > 127):
            return 'int32'
    return 'int8'


def _wire_buffers(
    fam: _Family, n_games: int, max_actions: int, float_dtype: Any, int_dtype: Any,
    *, pinned: bool,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor]:
    """Empty host wire tensors ``(floats (F, G, A), ints (I, G, A),
    is_home (G, A), n_actions (G,))``, page-locked when ``pinned``."""
    G, A = n_games, max_actions
    return (
        torch.empty((len(fam.float_cols), G, A), dtype=torch_dtype(float_dtype), pin_memory=pinned),
        torch.empty((len(fam.int_cols), G, A), dtype=torch_dtype(int_dtype), pin_memory=pinned),
        torch.empty((G, A), dtype=torch.bool, pin_memory=pinned),
        torch.empty((G,), dtype=torch.int32, pin_memory=pinned),
    )


_COPY_STREAMS: Dict[int, Any] = {}
_COPY_STREAMS_LOCK = threading.Lock()


def copy_stream(device: DeviceLike = None) -> 'torch.cuda.Stream':
    """The card's dedicated host-to-device copy stream (one per card,
    made at first use)."""
    dev = resolve_device(device)
    with _COPY_STREAMS_LOCK:
        stream = _COPY_STREAMS.get(dev.index)
        if stream is None:
            stream = _COPY_STREAMS[dev.index] = torch.cuda.Stream(dev)
    return stream


@contextlib.contextmanager
def producer_stream(device: torch.device) -> Iterator[None]:
    """Run the enclosed block as a producer of card batches on this
    thread: the card is the thread's current device and its copy stream
    the current stream. Both are per thread in PyTorch, so a worker
    thread must enter this itself. A no-op for the CPU."""
    if device.type != 'cuda':
        yield
        return
    torch.cuda.set_device(device)
    with torch.cuda.stream(copy_stream(device)):
        yield


def hand_over(batch: Any, stream: Any = None) -> Any:
    """Make a shipped batch safe to use on ``stream`` (default: the
    calling thread's current stream) and return it.

    The stream waits on the batch's ``ready`` event, and every field is
    marked as used by the stream (``record_stream``), so its memory is not
    reused while the stream's work may still read it. A batch without a
    ``ready`` event (the CPU, or one made otherwise) is returned as it is.
    Safe to call again, for another stream.
    """
    if batch.ready is None:
        return batch
    if stream is None:
        stream = torch.cuda.current_stream(batch.device)
    stream.wait_event(batch.ready)
    for t in batch.fields().values():
        t.record_stream(stream)
    return batch


def _ship_wire(fam: _Family, wire: Tuple[torch.Tensor, ...], device: torch.device) -> Any:
    """Move the host wire tensors to ``device`` and rebuild the batch there.

    On the card, the four copies (non-blocking, from pinned memory) and
    the unpack run on the copy stream; the batch carries the event
    recorded after them and is handed over to the calling thread's
    current stream. On the CPU the wire is unpacked where it is. Every
    shipped batch is claimed weakly under ``pipeline_feed`` in the
    residency ledger: per-field finalizers shrink the claim as the
    consumer drops the batch.
    """
    total = int(wire[3].sum())  # the lengths, counted on the host
    if device.type == 'cuda':
        consumer = torch.cuda.current_stream(device)
        stream = copy_stream(device)
        with torch.cuda.stream(stream):
            on_card = [t.to(device, non_blocking=True) for t in wire]
            batch = _device_unpack(fam, *on_card)
            ready = torch.cuda.Event()
            ready.record(stream)
        object.__setattr__(batch, 'ready', ready)
        hand_over(batch, consumer)
    else:
        batch = _device_unpack(fam, *wire)
    batch.with_total(total)
    claim_bytes('pipeline_feed', batch, weak=True)
    return batch


def _device_unpack(
    fam: _Family, floats: torch.Tensor, ints: torch.Tensor, is_home: torch.Tensor,
    n_act: torch.Tensor,
) -> Any:
    """Wire tensors -> a ``fam`` batch on their device.

    Matches the host packer bit for bit: ``mask`` by length comparison,
    ``row_index`` as the running valid-row offset plus the position (the
    cumulative sum runs in int64, as the JAX package's does in x64 mode;
    the field is int32 by contract), ``game_id`` as the chunk-local iota,
    ids widened back to int32.
    """
    G, A = is_home.shape
    ar = torch.arange(A, dtype=torch.int32, device=is_home.device)
    mask = ar[None, :] < n_act[:, None]
    offsets = torch.cumsum(n_act, 0) - n_act  # int64
    row_index = torch.where(mask, offsets[:, None] + ar[None, :], -1).to(torch.int32)
    cols = {c: floats[i] for i, c in enumerate(fam.float_cols)}
    cols.update({c: ints[i].to(torch.int32) for i, c in enumerate(fam.int_cols)})
    return fam.batch_cls(
        **cols,
        is_home=is_home,
        mask=mask,
        n_actions=n_act,
        game_id=torch.arange(G, dtype=torch.int32, device=is_home.device),
        row_index=row_index,
    )


def ship_host_batch(
    batch: Any, *, family: str = 'standard', device: DeviceLike = None
) -> Any:
    """Send a host staging batch to ``device`` (default ``cuda``) over the
    minimal wire.

    ``batch`` must be a numpy-backed batch from the family's packer with
    ``as_numpy=True`` whose games occupy *contiguous* source-frame row
    runs (the packer keeps frame-order ``row_index``, so an interleaved
    multi-game frame does NOT qualify — every internal caller reads via
    ``get_concat``, which concatenates whole games; a violation raises
    rather than silently rewriting the attribution). Only the stacked
    float columns, the id columns narrowed to their wire dtype, the
    ``is_home`` flags and the ``(G,)`` lengths are transferred (from
    pinned memory on the card), and :func:`_device_unpack` rebuilds
    ``mask``/``row_index``/``game_id`` bit-identically from ``n_actions``.

    The wire dtype is decided per chunk (one min/max over the stacked
    ids): a stream whose later chunk exceeds int8 widens to int32 for
    that chunk only. The staging copy and the issue of the copies are
    timed under ``stage=transfer``.
    """
    fam = FAMILIES[family]
    dev = resolve_device(device)
    # the device unpack rebuilds row_index as a cumsum of n_actions; that
    # is only bit-identical to the host packer's frame positions when each
    # game's rows are contiguous in the source frame. row_index is
    # strictly increasing per game (frame order), so first == offset and
    # last == offset + n - 1 proves contiguity in O(games)
    n_act = np.asarray(batch.n_actions)
    row_index = np.asarray(batch.row_index)
    if row_index.shape[1]:
        offsets = np.cumsum(n_act) - n_act
        rows = np.arange(len(n_act))
        first = row_index[rows, 0]
        last = row_index[rows, np.maximum(n_act - 1, 0)]
        if not np.all(
            (n_act == 0)
            | ((first == offsets) & (last == offsets + n_act - 1))
        ):
            raise ValueError(
                'ship_host_batch requires each game to occupy a '
                'contiguous row run of the source frame (row_index is '
                'rebuilt from a length cumsum on device); pack games '
                'from per-game frames via get_concat, or transfer the '
                'full batch instead'
            )
    with timed_labels('pipeline/stage_seconds', stage='transfer'):
        ints_host = np.stack([np.asarray(getattr(batch, c)) for c in fam.int_cols])
        G, A = row_index.shape
        float_dtype = np.asarray(getattr(batch, fam.float_cols[0])).dtype
        wire = _wire_buffers(
            fam, G, A, float_dtype, _int_wire_name(iter(ints_host)),
            pinned=dev.type == 'cuda',
        )
        floats, ints, is_home, n_act_wire = wire
        for i, c in enumerate(fam.float_cols):
            floats[i].copy_(torch.from_numpy(np.asarray(getattr(batch, c))))
        ints.copy_(torch.from_numpy(ints_host))
        is_home.copy_(torch.from_numpy(np.asarray(batch.is_home)))
        n_act_wire.copy_(torch.from_numpy(n_act))
        return _ship_wire(fam, wire, dev)


def _host(a: Any) -> np.ndarray:
    """A field as a host numpy array (a tensor is copied off its device)."""
    if isinstance(a, torch.Tensor):
        return a.detach().cpu().numpy()
    return np.asarray(a)


class PackedSeasonWriter:
    """Write side of the cache: incremental chunk writes + atomic publish.

    Runs in two shapes: the serial one-pass build (:func:`ensure_packed`
    on a miss) and the *overlapped* build
    (:func:`~socceraction_tpu_torch.pipeline.build.iter_packed_build`),
    where each streamed chunk is written into the memmaps while the same
    chunk is shipped to the device.

    Rows are addressed by position in ``self.game_ids`` (the store's
    ``game_ids()`` order, which every later :meth:`PackedSeason.take`
    resolves against). Nothing is visible to readers until
    :meth:`finalize` publishes the temp directory with one ``os.replace``;
    :meth:`abort` (or ``finalize`` never running) leaves no cache behind.

    ``store`` needs only ``path``, ``game_ids()`` and ``home_team_ids()``
    unless :meth:`write_missing` reads it, so a cache can be written from
    numpy data alone (``write_chunk`` of host staging batches).
    """

    def __init__(
        self,
        store: SeasonStore,
        *,
        max_actions: int,
        float_dtype: Any = 'float32',
        cache_dir: Optional[str] = None,
        family: str = 'standard',
    ) -> None:
        self.family = FAMILIES[family]
        self.store_path = store.path
        # fingerprint BEFORE the first read: a store rewritten mid-build
        # must leave the published cache invalid
        self._fingerprint = _store_fingerprint(store.path)
        self.cache_dir = cache_dir or packed_cache_dir(
            store.path, max_actions, float_dtype, family
        )
        self.max_actions = int(max_actions)
        self.float_dtype = np.dtype(float_dtype)
        # always the store's own full listing: rows are addressed by
        # position in store order
        self.game_ids: List[Any] = store.game_ids()
        self.home = store.home_team_ids()
        self._written = np.zeros(len(self.game_ids), dtype=bool)
        G, A = len(self.game_ids), self.max_actions
        _sweep_dead_builds(self.cache_dir)
        self._tmp = (
            f'{self.cache_dir}.building.'
            f'{_host_tag()}-{os.getpid()}.{next(_BUILD_SEQ)}'
        )
        if os.path.isdir(self._tmp):
            shutil.rmtree(self._tmp)
        os.makedirs(self._tmp)
        self._maps: Dict[str, Any] = {}
        # preallocation can fail partway (ENOSPC on the G x A memmaps):
        # clean up here, or each same-process retry strands a temp dir
        try:
            for cols, dtype in (
                (self.family.float_cols, self.float_dtype),
                (self.family.int_cols, np.int32),
                (self.family.bool_cols, bool),
            ):
                for c in cols:
                    self._maps[c] = np.lib.format.open_memmap(
                        os.path.join(self._tmp, f'{c}.npy'), mode='w+',
                        dtype=dtype, shape=(G, A),
                    )
            self._n_actions = np.zeros(G, dtype=np.int32)
        except BaseException:
            self.abort()
            raise

    @property
    def complete(self) -> bool:
        """True once every game's rows have been written."""
        return bool(self._written.all())

    def write_chunk(self, lo: int, batch: Any) -> None:
        """Write one packed chunk (games ``lo:lo+G_chunk`` of
        ``self.game_ids``; a host staging batch, or any batch whose fields
        can be copied to the host) into the column memmaps."""
        hi = lo + batch.is_home.shape[0]
        for c in self.family.all_cols:
            self._maps[c][lo:hi] = _host(getattr(batch, c))
        self._n_actions[lo:hi] = _host(batch.n_actions)
        self._written[lo:hi] = True

    def write_missing(self, store: SeasonStore, build_chunk: int = 256) -> None:
        """Pack and write every game not covered by a prior
        :meth:`write_chunk` (e.g. a ``drop_remainder`` tail the stream
        never yielded), reading the store in ``build_chunk`` spans."""
        missing = np.flatnonzero(~self._written)
        for span_lo in range(0, len(missing), build_chunk):
            span = missing[span_lo : span_lo + build_chunk]
            # contiguous runs within the span write in one slice each
            runs: List[List[int]] = []
            for i in span:
                if runs and runs[-1][-1] == i - 1:
                    runs[-1].append(int(i))
                else:
                    runs.append([int(i)])
            for run in runs:
                chunk = [self.game_ids[i] for i in run]
                batch = _read_and_pack_chunk(
                    store, self.family, chunk, self.home,
                    max_actions=self.max_actions,
                    float_dtype=self.float_dtype,
                )
                self.write_chunk(run[0], batch)

    def seed_from(self, old: PackedSeason, *, copy_chunk: int = 256) -> int:
        """Copy rows for games an existing cache already packed.

        The incremental half of an append-only ingest: when new matches
        land, the store fingerprint changes and the whole cache reads as
        a miss, but the rows of every previously packed game are still
        right. This seeds the new build's memmaps from the old cache's
        (matched by game id), so the rebuild only reads and packs the new
        games. Returns the number of rows copied; a shape, family or
        dtype mismatch copies nothing. A store that *rewrites* an
        existing game must drop the cache instead.
        """
        if (
            old.family.name != self.family.name
            or old.max_actions != self.max_actions
            or old.float_dtype != self.float_dtype
        ):
            return 0
        pairs = [
            (i, old._pos[gid])
            for i, gid in enumerate(self.game_ids)
            if not self._written[i] and gid in old._pos
        ]
        for lo in range(0, len(pairs), copy_chunk):
            chunk = pairs[lo : lo + copy_chunk]
            new_idx = np.asarray([p[0] for p in chunk])
            old_idx = np.asarray([p[1] for p in chunk])
            for c in self.family.all_cols:
                self._maps[c][new_idx] = np.asarray(
                    old._cols[c][old_idx], dtype=self._maps[c].dtype
                )
            self._n_actions[new_idx] = old.n_actions[old_idx]
            self._written[new_idx] = True
        return len(pairs)

    def finalize(self) -> PackedSeason:
        """Flush, write ``meta.json`` and publish atomically.

        Every game must have been written; a gap raises instead of
        publishing a cache that would serve zeros. If a concurrent build
        published first, its (valid) cache is returned instead.
        """
        if not self._written.all():
            self.abort()
            raise RuntimeError(
                f'{int((~self._written).sum())} games were never written; '
                'call write_missing(store) before finalize()'
            )
        try:
            for m in self._maps.values():
                m.flush()
            np.save(os.path.join(self._tmp, 'n_actions.npy'), self._n_actions)
            meta = {
                'version': _VERSION,
                'family': self.family.name,
                'max_actions': self.max_actions,
                'float_dtype': self.float_dtype.name,
                'int_wire': _int_wire_name(
                    self._maps[c] for c in self.family.int_cols
                ),
                'game_ids': [_json_safe(g) for g in self.game_ids],
                'store_fingerprint': self._fingerprint,
            }
            with open(os.path.join(self._tmp, 'meta.json'), 'w', encoding='utf-8') as fh:
                json.dump(meta, fh)
            if os.path.isdir(self.cache_dir):
                shutil.rmtree(self.cache_dir)
            try:
                os.replace(self._tmp, self.cache_dir)
            except OSError:
                # a concurrent build published first: use its cache if valid
                ps = _try_open(self.cache_dir, self.store_path)
                if ps is not None:
                    return ps
                raise
        finally:
            self.abort()
        return PackedSeason(self.cache_dir)

    def abort(self) -> None:
        """Drop the in-progress temp directory (idempotent, never raises).

        Runs on close and error paths: a cleanup failure must not replace
        the original error or kill the feed's worker thread before its END
        sentinel goes out; a leftover directory is reclaimed by the next
        build's dead-pid sweep.
        """
        self._maps = {}
        shutil.rmtree(self._tmp, ignore_errors=True)


def open_packed(
    store: SeasonStore,
    *,
    max_actions: int,
    float_dtype: Any = 'float32',
    cache_dir: Optional[str] = None,
    family: str = 'standard',
) -> Optional[PackedSeason]:
    """Open the store's packed cache if present, valid and matching.

    The no-build half of :func:`ensure_packed`: ``None`` on any miss
    (absent or partial directory, stale store fingerprint, or a cache
    built for another family, shape or dtype).
    """
    fam = FAMILIES[family]
    cache_dir = cache_dir or packed_cache_dir(store.path, max_actions, float_dtype, family)
    ps = _try_open(cache_dir, store.path)
    if ps is None:
        return None
    # an explicit cache_dir may point at a cache built for another
    # family/shape/dtype; a mismatch is a miss, never silently-wrong batches
    if (
        ps.family.name == fam.name
        and ps.max_actions == int(max_actions)
        and ps.float_dtype == np.dtype(float_dtype)
    ):
        return ps
    return None


def ensure_packed(
    store: SeasonStore,
    *,
    max_actions: int,
    float_dtype: Any = 'float32',
    cache_dir: Optional[str] = None,
    build_chunk: int = 256,
    family: str = 'standard',
) -> PackedSeason:
    """Open the store's packed cache, building it on a miss.

    The build streams the store once in ``build_chunk``-game chunks
    (:meth:`SeasonStore.get_concat`, packed host-side with
    ``as_numpy=True``) into preallocated ``.npy`` memmaps, then publishes
    the directory atomically; timed under ``stage=pack_cache_build``.
    For a streaming first pass prefer ``iter_batches(...,
    packed_cache=True)``, which builds the same cache overlapped with the
    epoch.
    """
    ps = open_packed(
        store, max_actions=max_actions, float_dtype=float_dtype,
        cache_dir=cache_dir, family=family,
    )
    if ps is not None:
        return ps
    with timed_labels('pipeline/stage_seconds', stage='pack_cache_build'):
        writer = PackedSeasonWriter(
            store, max_actions=max_actions, float_dtype=float_dtype,
            cache_dir=cache_dir, family=family,
        )
        try:
            writer.write_missing(store, build_chunk=build_chunk)
            return writer.finalize()
        except BaseException:
            writer.abort()
            raise


def _try_open(cache_dir: str, store_path: str) -> Optional[PackedSeason]:
    """Open the cache if it is complete AND matches the store; else None.

    A directory left by an interrupted delete or publish (missing
    meta.json or arrays) reads as a miss, never as an error.
    """
    if not os.path.isdir(cache_dir):
        return None
    try:
        ps = PackedSeason(cache_dir)
    except (OSError, ValueError, KeyError, json.JSONDecodeError):
        return None
    return ps if ps.valid_for(store_path) else None


def _json_safe(gid: Any) -> Any:
    """Game ids ride through meta.json; numpy scalars need unwrapping."""
    return gid.item() if hasattr(gid, 'item') else gid
