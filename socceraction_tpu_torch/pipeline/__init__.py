"""The pipeline layer of the port: season stores and the batch feed.

Port of the JAX package's ``socceraction_tpu/pipeline``:

- :class:`SeasonStore` -- a keyed DataFrame store with the reference's
  key layout (``games``, ``teams``, ``players``, the vocabulary tables and
  ``actions/game_<id>``) and two engines: parquet (per-game files read
  concurrently by :meth:`SeasonStore.get_concat`) and HDF5 through h5py.
- :func:`build_spadl_store` -- loader + converter -> store.
- :func:`load_batch` / :func:`iter_batches` -- stored games as packed
  batches on the card, including a double-buffered streaming iterator
  (read -> pack -> transfer, ``prefetch``-deep, copies from pinned memory
  on a side stream).
- :func:`ensure_packed` / :func:`open_packed` / :class:`PackedSeason` --
  the packed-season memmap cache (the JAX package's on-disk format).
- :func:`iter_packed_build` -- a first pass that builds that cache
  overlapped with the epoch.

Exports resolve lazily (PEP 562): a data-prep process that only reads a
store does not import the batch core.
"""

from typing import Any, List

__all__ = [
    'PackedSeason',
    'SeasonStore',
    'build_spadl_store',
    'ensure_packed',
    'iter_batches',
    'iter_packed_build',
    'load_batch',
    'open_packed',
]

#: symbol -> defining submodule, resolved lazily
_EXPORTS = {
    'PackedSeason': 'packed',
    'SeasonStore': 'store',
    'build_spadl_store': 'build',
    'ensure_packed': 'packed',
    'iter_batches': 'feed',
    'iter_packed_build': 'build',
    'load_batch': 'feed',
    'open_packed': 'packed',
}


def __getattr__(name: str) -> Any:
    if name in _EXPORTS:
        import importlib

        module = importlib.import_module(f'{__name__}.{_EXPORTS[name]}')
        value = getattr(module, name)
        globals()[name] = value  # cache: __getattr__ runs at most once
        return value
    raise AttributeError(f'module {__name__!r} has no attribute {name!r}')


def __dir__() -> List[str]:
    return sorted(set(globals()) | set(__all__))
