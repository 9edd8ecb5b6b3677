"""Ingest side of the continuous-learning loop: watch + extend.

A copy of the JAX package's ``socceraction_tpu/learn/ingest.py`` over the
port's season store and packed cache (whose on-disk format is that
package's).

Two small primitives close the gap between "matches land in the season
store" and "the training feed can stream them":

- :class:`SeasonWatcher` — tracks which stored games the loop has
  already consumed into training and reports the newly landed ones.
  ``poll()`` is read-only (a crashed iteration re-polls the same games);
  :meth:`SeasonWatcher.commit` marks games consumed once their training
  pass actually completed.
- :func:`extend_packed` — brings the season's packed memmap cache up to
  date *incrementally*: new games invalidate the cache's store
  fingerprint, but an append-only store leaves every previously packed
  row exactly right, so the rebuild seeds the new cache from the old
  one (:meth:`~socceraction_tpu_torch.pipeline.packed.PackedSeasonWriter.seed_from`)
  and reads/packs only the games that actually landed — O(new matches)
  store IO, same atomic publish as the overlapped first build.

Contract: the store is **append-only per game** (matches land; played
matches never mutate). A pipeline that rewrites an existing game's
actions must delete the cache directory before the next loop iteration.
"""

from __future__ import annotations

import json
import os
from typing import Any, List, Optional, Sequence, Set, Tuple

from ..obs import counter
from ..pipeline.packed import (
    FAMILIES,
    PackedSeason,
    PackedSeasonWriter,
    open_packed,
    packed_cache_dir,
)
from ..pipeline.store import SeasonStore

__all__ = ['SeasonWatcher', 'extend_packed', 'newest_game_ids']


def newest_game_ids(game_ids: Sequence[Any], n: int) -> List[Any]:
    """The ``n`` most recently assigned game ids of a listing.

    ``SeasonStore.game_ids()`` is ordered by *key string*, which sorts
    lexicographically (``game_9999`` after ``game_10000``) — taking its
    tail would return stale games once ids grow a digit. Providers
    assign increasing numeric ids, so "newest" is the largest ids under
    numeric-aware order; non-numeric ids sort after numeric ones by
    their string form (a deterministic, if arbitrary, recency proxy).
    """
    def key(gid: Any):
        s = str(gid)
        if s.lstrip('-').isdigit():
            return (0, int(s), '')
        return (1, 0, s)

    return sorted(game_ids, key=key)[-max(0, int(n)):] if n > 0 else []


class SeasonWatcher:
    """Tracks which stored games the learning loop has consumed.

    Parameters
    ----------
    store : SeasonStore
        The season store new matches land in.
    prime : bool
        ``True`` marks every game already present at construction as
        consumed — the posture of a loop attached to an already-trained
        serving model. ``False`` (default) treats the whole store as new,
        so the first iteration is the bootstrap fit.
    """

    def __init__(self, store: SeasonStore, *, prime: bool = False) -> None:
        self.store = store
        self._seen: Set[Any] = set(store.game_ids()) if prime else set()

    @property
    def seen(self) -> Set[Any]:
        """Game ids already consumed (a copy)."""
        return set(self._seen)

    def poll(self) -> List[Any]:
        """Newly landed game ids, in store order. Read-only: polling does
        NOT consume — call :meth:`commit` once training over them
        succeeded, so a crashed iteration retries the same games."""
        return [g for g in self.store.game_ids() if g not in self._seen]

    def commit(self, game_ids: Sequence[Any]) -> None:
        """Mark ``game_ids`` as consumed into training."""
        self._seen.update(game_ids)


def extend_packed(
    store: SeasonStore,
    *,
    max_actions: int,
    float_dtype: Any = 'float32',
    cache_dir: Optional[str] = None,
    family: str = 'standard',
    build_chunk: int = 256,
) -> Tuple[PackedSeason, int, int]:
    """Bring the packed cache up to date; returns ``(season, reused, packed)``.

    A valid cache returns immediately (``reused == n_games``,
    ``packed == 0``). Otherwise a new build starts and, when the stale
    cache on disk matches this build's family/shape/dtype, every game it
    already packed is copied memmap→memmap
    (:meth:`~socceraction_tpu_torch.pipeline.packed.PackedSeasonWriter.seed_from`)
    before a :meth:`write_missing` pass reads **only the remaining
    games** from the store. The publish is the writer's usual atomic
    rename, so readers always see either the old complete cache or the
    new complete cache.

    ``reused``/``packed`` count games served from the old cache vs.
    freshly read from the store — the loop reports them under
    ``learn/cache_games{source=reused|packed}``.
    """
    fam = FAMILIES[family]
    cache_dir = cache_dir or packed_cache_dir(
        store.path, max_actions, float_dtype, family
    )
    season = open_packed(
        store,
        max_actions=max_actions,
        float_dtype=float_dtype,
        cache_dir=cache_dir,
        family=family,
    )
    if season is not None:
        return season, len(season.game_ids), 0

    # a stale-but-shaped cache is the incremental seed; anything else
    # (absent, torn, other family/shape/dtype) means a cold build
    old: Optional[PackedSeason] = None
    if os.path.isdir(cache_dir):
        try:
            cand = PackedSeason(cache_dir)
        except (OSError, ValueError, KeyError, json.JSONDecodeError):
            cand = None
        if cand is not None and cand.family.name == fam.name:
            old = cand

    writer = PackedSeasonWriter(
        store,
        max_actions=max_actions,
        float_dtype=float_dtype,
        cache_dir=cache_dir,
        family=family,
    )
    try:
        reused = writer.seed_from(old) if old is not None else 0
        writer.write_missing(store, build_chunk=build_chunk)
        season = writer.finalize()
    except BaseException:
        writer.abort()
        raise
    packed = len(writer.game_ids) - reused
    counter('learn/cache_games', unit='count').inc(reused, source='reused')
    counter('learn/cache_games', unit='count').inc(packed, source='packed')
    return season, reused, packed
