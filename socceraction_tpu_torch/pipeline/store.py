"""Keyed season store with the reference HDF5 key convention.

Key layout (mirrors reference ``tests/datasets/download.py:95-124``):

- ``competitions``, ``games``, ``teams``, ``players`` -- metadata tables
- ``actiontypes``, ``results``, ``bodyparts`` -- SPADL vocabulary tables
- ``actions/game_<id>`` -- one SPADL (or Atomic-SPADL) frame per game

Engines:

- ``parquet`` (default): a directory of ``<key>.parquet`` files with an
  ``actions/`` subdirectory. Arrow-native, columnar, mmap-friendly -- the
  natural on-disk twin of the device ``ActionBatch``.
- ``hdf5``: a single ``.h5`` file via h5py (pandas' HDFStore needs
  pytables, which this engine deliberately avoids). One group per key, one
  dataset per column; numeric/bool columns are stored natively,
  datetime64 as int64 nanoseconds, and object columns as JSON-encoded
  strings (exact for the str/int/float/None values SPADL frames contain).

A copy of the JAX package's ``socceraction_tpu/pipeline/store.py``. It
imports pandas, pyarrow and h5py inside the functions that need them,
never at the top: the machine with the card has none of them, and still
imports this module (a packed cache records the store it came from).
The read costs quoted below were measured for the JAX package, on its
host.
"""

from __future__ import annotations

import json
import os
import re
from typing import TYPE_CHECKING, Any, List, Optional, Sequence

import numpy as np

from ..obs import timed_labels
from ..resil.faults import fault_point
from ..resil.retry import RetryPolicy, retry_call

if TYPE_CHECKING:  # pandas is imported inside the functions that need it
    import pandas as pd

__all__ = ['SeasonStore']

#: Per-file parquet reads retried under this policy: a transient
#: ``OSError`` (NFS hiccup, briefly-full page cache) backs off and
#: retries; a missing file (``FileNotFoundError`` → ``KeyError``) or a
#: schema/projection mismatch raises immediately — the data will not
#: appear by waiting. Delays are small: per-game files are ~100 KB and
#: the multi-game reader fans these out across worker threads.
READ_RETRY = RetryPolicy(max_attempts=3, base_delay_s=0.02, max_delay_s=0.5)

_GAME_KEY_RE = re.compile(r'^actions/game_(.+)$')


def _read_threads(threads: Optional[int]) -> int:
    """Resolve the parquet reader's worker count: an explicit argument
    wins, else the ``SOCCERACTION_TPU_READ_THREADS`` env var when set,
    else ``min(8, cpu_count)``."""
    if threads is not None:
        return threads
    try:
        from_env = int(os.environ.get('SOCCERACTION_TPU_READ_THREADS', 0))
    except ValueError:  # set-but-empty/garbage reads as unset, never a crash
        from_env = 0
    return from_env or min(8, os.cpu_count() or 1)


def _infer_engine(path: str, engine: Optional[str]) -> str:
    if engine is not None:
        return engine
    if path.endswith(('.h5', '.hdf5')):
        return 'hdf5'
    return 'parquet'


def _looks_like_store(path: str) -> bool:
    """Whether an existing directory is plausibly a parquet SeasonStore.

    ``mode='w'`` recursively deletes ``path``; unlike HDF5's 'w' (which
    truncates one file) that could wipe an unrelated directory on a typo,
    so deletion is only allowed for an empty directory or one whose
    contents are store-shaped (an ``actions`` subdir / ``*.parquet``
    files / subdirs of them).
    """
    entries = os.listdir(path)
    if not entries:
        return True
    if 'actions' in entries:
        return True

    def parquet_only(directory: str, depth: int = 0) -> bool:
        for name in os.listdir(directory):
            full = os.path.join(directory, name)
            if os.path.isdir(full):
                if depth >= 2 or not parquet_only(full, depth + 1):
                    return False
            elif not name.endswith('.parquet'):
                return False
        return True

    return parquet_only(path)


class SeasonStore:
    """A keyed DataFrame store holding one or more converted seasons.

    Parameters
    ----------
    path : str
        Directory (parquet engine) or ``.h5`` file (hdf5 engine).
    engine : {'parquet', 'hdf5'}, optional
        Defaults to 'hdf5' when ``path`` ends in ``.h5``/``.hdf5``, else
        'parquet'.
    mode : {'a', 'r', 'w'}
        'w' truncates an existing store, 'a' appends/overwrites keys,
        'r' is read-only. With the parquet engine, 'w' refuses to delete a
        pre-existing directory that does not look like a store (see
        :func:`_looks_like_store`).
    """

    def __init__(self, path: str, engine: Optional[str] = None, mode: str = 'a') -> None:
        if mode not in ('a', 'r', 'w'):
            raise ValueError(f"mode must be 'a', 'r' or 'w', got {mode!r}")
        self.path = path
        self.engine = _infer_engine(path, engine)
        if self.engine not in ('parquet', 'hdf5'):
            raise ValueError(f'unknown engine {self.engine!r}')
        self.mode = mode
        self._h5 = None
        if self.engine == 'hdf5':
            import h5py

            h5_mode = {'a': 'a', 'r': 'r', 'w': 'w'}[mode]
            self._h5 = h5py.File(path, h5_mode)
        else:
            if mode == 'w' and os.path.isdir(path):
                if not _looks_like_store(path):
                    raise ValueError(
                        f'refusing to overwrite {path!r}: existing directory '
                        'does not look like a SeasonStore (expected an '
                        "'actions' subdirectory or only .parquet content); "
                        'delete it manually if this is intended'
                    )
                import shutil

                shutil.rmtree(path)
            if mode != 'r':
                os.makedirs(os.path.join(path, 'actions'), exist_ok=True)
            elif not os.path.isdir(path):
                raise FileNotFoundError(path)

    # -- context manager ---------------------------------------------------
    def __enter__(self) -> 'SeasonStore':
        return self

    def __exit__(self, *exc: Any) -> None:
        self.close()

    def close(self) -> None:
        """Release the underlying HDF5 handle (idempotent)."""
        if self._h5 is not None:
            self._h5.close()
            self._h5 = None

    # -- generic key access ------------------------------------------------
    def _check_writable(self) -> None:
        if self.mode == 'r':
            raise OSError('store opened read-only')

    def _parquet_path(self, key: str) -> str:
        return os.path.join(self.path, *key.split('/')) + '.parquet'

    def put(self, key: str, frame: 'pd.DataFrame') -> None:
        """Write ``frame`` under ``key`` (overwriting any existing frame)."""
        self._check_writable()
        if self.engine == 'parquet':
            path = self._parquet_path(key)
            os.makedirs(os.path.dirname(path), exist_ok=True)
            frame.to_parquet(path, index=False)
        else:
            assert self._h5 is not None
            if key in self._h5:
                del self._h5[key]
            group = self._h5.create_group(key)
            group.attrs['columns'] = json.dumps(list(map(str, frame.columns)))
            for col in frame.columns:
                _write_column(group, str(col), frame[col])

    def get(self, key: str) -> 'pd.DataFrame':
        """Read the frame stored under ``key``."""
        if self.engine == 'parquet':
            return self._read_parquet(key)
        return self._read_hdf5(key)

    def _read_parquet(
        self, key: str, columns: Optional[Sequence[str]] = None
    ) -> 'pd.DataFrame':
        table = self._read_parquet_table(key, columns)
        return table.to_pandas(use_threads=False)

    def _read_parquet_table(
        self, key: str, columns: Optional[Sequence[str]] = None
    ) -> Any:
        """Open one per-key parquet file and read it as an Arrow table.

        ``pq.ParquetFile`` + ``read(use_threads=False)`` instead of
        ``read_table``: the dataset machinery ``read_table`` spins up per
        call costs ~5 ms on a ~100 KB per-game file (more than the read
        itself), and Arrow's per-file decode pool fights the file-level
        fan-out of :meth:`get_many` for cores — measured ~4x per-file on
        the bench host. ``columns`` pushes a projection into the columnar
        read so callers that pack a known schema never decode the rest;
        ``ParquetFile.read`` silently drops unknown names, so the
        projection is checked against the schema first — a typo'd column
        must ``KeyError`` like the HDF5 engine, never vanish.
        """
        import pyarrow as pa
        import pyarrow.parquet as pq

        path = self._parquet_path(key)

        def _read_bytes() -> bytes:
            # the named chaos point + retried unit: the byte slurp is
            # the only part of the read that touches the filesystem, so
            # an injected/transient OSError here retries without
            # re-running the (deterministic) Arrow parse below
            fault_point('ingest.read', key=key)
            # slurp + parse from memory: one sequential read() instead of
            # the seek-heavy footer/page reads of a file-backed open —
            # measured ~2x per-file on ~100 KB per-game files (projection
            # then skips decode, not IO; per-key store files are small
            # enough that reading all bytes is the right trade)
            with open(path, 'rb') as fh:
                return fh.read()

        try:
            buf = retry_call(_read_bytes, site='ingest.read', policy=READ_RETRY)
        except FileNotFoundError:
            raise KeyError(key) from None
        pf = pq.ParquetFile(pa.BufferReader(buf))
        if columns is not None:
            have = set(pf.schema_arrow.names)
            missing = [c for c in columns if c not in have]
            if missing:
                raise KeyError(f'{key}: missing columns {missing}')
        return pf.read(columns=columns, use_threads=False)

    def _read_hdf5(
        self, key: str, columns: Optional[Sequence[str]] = None
    ) -> 'pd.DataFrame':
        import pandas as pd

        assert self._h5 is not None
        if key not in self._h5:
            raise KeyError(key)
        group = self._h5[key]
        cols = json.loads(group.attrs['columns'])
        if columns is not None:
            missing = [c for c in columns if c not in cols]
            if missing:
                raise KeyError(f'{key}: missing columns {missing}')
            cols = list(columns)
        return pd.DataFrame({col: _read_column(group, col) for col in cols})

    def _get_parquet_staged(
        self, key: str, columns: Optional[Sequence[str]] = None
    ) -> 'pd.DataFrame':
        """One parquet read with the file fetch and the columnar decode
        attributed separately (``stage=read_io`` / ``stage=decode`` of the
        labeled ``pipeline/stage_seconds`` histogram).

        Only the multi-game reader goes through here: the per-stage totals
        are summed across worker threads, so with ``threads > 1`` they can
        legitimately exceed the wall time of the enclosing call (IO and
        decode overlap across files — that overlap is the point).
        """
        with timed_labels('pipeline/stage_seconds', stage='read_io'):
            table = self._read_parquet_table(key, columns)
        with timed_labels('pipeline/stage_seconds', stage='decode'):
            return table.to_pandas(use_threads=False)

    def get_many(
        self,
        keys: Sequence[str],
        *,
        columns: Optional[Sequence[str]] = None,
        threads: Optional[int] = None,
    ) -> List['pd.DataFrame']:
        """Read several keys, concurrently where the engine allows it.

        The parquet engine fans the reads out over a thread pool (pyarrow
        releases the GIL for both the file read and the columnar decode, so
        per-game files fetch and decode in parallel instead of one ``get``
        at a time — the cold-path ingest fix). The HDF5 engine reads
        serially: h5py serializes all access under a global API lock, so
        threads would only add overhead.

        Parameters
        ----------
        keys : sequence of str
            Store keys; the result list preserves their order.
        columns : sequence of str, optional
            Project each frame to exactly these columns (both engines —
            parquet skips the decode of the rest entirely). Raises
            ``KeyError`` if any requested column is absent.
        threads : int, optional
            Worker count for the parquet engine. Defaults to the
            ``SOCCERACTION_TPU_READ_THREADS`` env var when set, else
            ``min(8, cpu_count)``. ``threads <= 1`` forces the serial path.

        Raises
        ------
        KeyError
            If any key is missing (raised on the calling thread).
        """
        keys = list(keys)
        if self.engine != 'parquet':
            return [self._read_hdf5(k, columns) for k in keys]
        return self._fanout(
            keys, lambda k: self._get_parquet_staged(k, columns), threads
        )

    def _read_arrow_staged(
        self, key: str, columns: Optional[Sequence[str]] = None
    ) -> Any:
        """One per-key parquet file as an Arrow table (``stage=read_io``)."""
        with timed_labels('pipeline/stage_seconds', stage='read_io'):
            return self._read_parquet_table(key, columns)

    def get_concat(
        self,
        keys: Sequence[str],
        *,
        columns: Optional[Sequence[str]] = None,
        threads: Optional[int] = None,
    ) -> 'pd.DataFrame':
        """Read several same-schema keys as ONE concatenated frame.

        Row order follows key order, with a fresh RangeIndex — exactly
        ``pd.concat(get_many(keys), ignore_index=True)``, but on the
        parquet engine the per-key files are fetched (concurrently, as in
        :meth:`get_many`) as Arrow tables, concatenated zero-copy at the
        Arrow level, and converted to pandas ONCE for the whole group —
        measured ~6x cheaper than 512 per-game ``to_pandas`` calls plus a
        ``pd.concat``. This is the chunk-read primitive of the streaming
        feed (``pipeline/feed.py``), which packs whole chunks and never
        needs the per-game frames individually.
        """
        keys = list(keys)
        if self.engine != 'parquet':
            import pandas as pd

            return pd.concat(
                [self._read_hdf5(k, columns) for k in keys], ignore_index=True
            )
        import pyarrow as pa

        tables = self._fanout(
            keys, lambda k: self._read_arrow_staged(k, columns), threads
        )
        with timed_labels('pipeline/stage_seconds', stage='decode'):
            return pa.concat_tables(tables).to_pandas(use_threads=False)

    def _fanout(
        self, keys: List[str], read_one: Any, threads: Optional[int]
    ) -> List[Any]:
        """Run one per-key read callable over the worker pool, preserving
        key order; ``threads <= 1`` (or a single key) stays serial on the
        calling thread."""
        threads = _read_threads(threads)
        if threads <= 1 or len(keys) <= 1:
            return [read_one(k) for k in keys]
        from concurrent.futures import ThreadPoolExecutor

        with ThreadPoolExecutor(
            max_workers=min(threads, len(keys)), thread_name_prefix='store-read'
        ) as pool:
            return list(pool.map(read_one, keys))

    def delete(self, key: str) -> None:
        """Remove ``key`` from the store; no-op if it does not exist."""
        self._check_writable()
        if self.engine == 'parquet':
            path = self._parquet_path(key)
            if os.path.exists(path):
                os.unlink(path)
            return
        assert self._h5 is not None
        if key in self._h5:
            del self._h5[key]

    def keys(self) -> List[str]:
        """All keys in the store ('actions/game_<id>' entries included)."""
        if self.engine == 'parquet':
            found = []
            for root, _dirs, files in os.walk(self.path):
                for name in files:
                    if name.endswith('.parquet'):
                        rel = os.path.relpath(os.path.join(root, name), self.path)
                        found.append(rel[: -len('.parquet')].replace(os.sep, '/'))
            return sorted(found)
        assert self._h5 is not None
        found = []

        def _visit(name: str, obj: Any) -> None:
            if 'columns' in getattr(obj, 'attrs', {}):
                found.append(name)

        self._h5.visititems(_visit)
        return sorted(found)

    def __contains__(self, key: str) -> bool:
        try:
            if self.engine == 'parquet':
                return os.path.exists(self._parquet_path(key))
            assert self._h5 is not None
            return key in self._h5
        except Exception:
            return False

    # -- the reference key convention --------------------------------------
    def put_actions(self, game_id: Any, actions: 'pd.DataFrame') -> None:
        """Store one game's action frame under ``actions/game_<id>``."""
        self.put(f'actions/game_{game_id}', actions)

    def get_actions(self, game_id: Any) -> 'pd.DataFrame':
        """Read one game's action frame."""
        return self.get(f'actions/game_{game_id}')

    def put_atomic_actions(self, game_id: Any, actions: 'pd.DataFrame') -> None:
        """Store one game's Atomic-SPADL frame under
        ``atomic_actions/game_<id>`` (the key ``build_spadl_store`` writes
        with ``atomic=True``)."""
        self.put(f'atomic_actions/game_{game_id}', actions)

    def get_atomic_actions(self, game_id: Any) -> 'pd.DataFrame':
        """Read one game's Atomic-SPADL frame."""
        return self.get(f'atomic_actions/game_{game_id}')

    def game_ids(self) -> List[Any]:
        """All stored game ids, parsed back to int where possible."""
        ids: List[Any] = []
        for key in self.keys():
            m = _GAME_KEY_RE.match(key)
            if m:
                raw = m.group(1)
                ids.append(int(raw) if raw.lstrip('-').isdigit() else raw)
        return ids

    def games(self) -> 'pd.DataFrame':
        """The store's games table (HDF5 key ``games``)."""
        return self.get('games')

    def home_team_ids(self) -> dict:
        """Mapping ``game_id -> home_team_id`` from the games table.

        The single source both batch-feeding paths (store stream and
        packed cache) use to orient packing, so they can never diverge.
        """
        games = self.games()
        return dict(zip(games['game_id'], games['home_team_id']))

    def teams(self) -> 'pd.DataFrame':
        """The store's teams table (HDF5 key ``teams``)."""
        return self.get('teams')

    def players(self) -> 'pd.DataFrame':
        """The store's players table (HDF5 key ``players``)."""
        return self.get('players')


# -- hdf5 column codecs ----------------------------------------------------

def _write_column(group: Any, name: str, series: 'pd.Series') -> None:
    import h5py

    pandas_dtype = str(series.dtype)
    values = series.to_numpy()
    if np.issubdtype(values.dtype, np.datetime64):
        data = values.astype('datetime64[ns]').astype(np.int64)
        ds = group.create_dataset(name, data=data)
        ds.attrs['codec'] = 'datetime'
    elif values.dtype == object or values.dtype.kind in ('U', 'S'):
        # numpy scalars surviving in object columns (np.bool_, np.int32, ...
        # from provider parsers) are not JSON-serializable; unwrap them.
        encoded = [
            json.dumps(None if _isna(v) else v, default=_unwrap_numpy)
            for v in values
        ]
        ds = group.create_dataset(
            name, data=encoded, dtype=h5py.string_dtype(encoding='utf-8')
        )
        ds.attrs['codec'] = 'json'
    else:
        ds = group.create_dataset(name, data=values)
        ds.attrs['codec'] = 'native'
    ds.attrs['pandas_dtype'] = pandas_dtype


def _read_column(group: Any, name: str) -> Any:
    import pandas as pd

    ds = group[name]
    codec = ds.attrs.get('codec', 'native')
    pandas_dtype = ds.attrs.get('pandas_dtype', None)
    if codec == 'datetime':
        out = pd.Series(ds[...].astype(np.int64).view('datetime64[ns]'))
    elif codec == 'json':
        raw = [v.decode('utf-8') if isinstance(v, bytes) else v for v in ds[...]]
        decoded = [json.loads(v) for v in raw]
        out = pd.Series(
            [np.nan if v is None else v for v in decoded], dtype=object
        )
    else:
        return ds[...]
    if pandas_dtype and pandas_dtype != str(out.dtype):
        try:
            out = out.astype(pandas_dtype)
        except (TypeError, ValueError):
            pass  # unknown extension dtype in this pandas version
    return out


def _isna(v: Any) -> bool:
    import pandas as pd

    try:
        return bool(pd.isna(v))
    except (TypeError, ValueError):
        return False


def _unwrap_numpy(o: Any) -> Any:
    if isinstance(o, np.generic):
        return o.item()
    if isinstance(o, np.ndarray):
        return o.tolist()
    raise TypeError(f'Object of type {type(o).__name__} is not JSON serializable')
