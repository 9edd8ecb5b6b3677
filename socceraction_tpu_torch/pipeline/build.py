"""Build season artifacts: provider loader → store, and store → packed cache.

Port of the JAX package's ``socceraction_tpu/pipeline/build.py``.

:func:`build_spadl_store` converts every game of a provider loader into a
:class:`~socceraction_tpu_torch.pipeline.store.SeasonStore`: the
per-game frames plus the metadata and vocabulary tables, converted by the
provider's SPADL converter (chosen by the loader's class name) unless the
caller passes ``convert=``.

:func:`iter_packed_build` is the *overlapped* build of the packed-season
memmap cache (:mod:`socceraction_tpu_torch.pipeline.packed`): it streams
the season chunk by chunk, ships each chunk to the device **and** writes
the same columns into the cache memmaps as it goes, publishing the cache
when the pass completes — the first epoch pays for the cache instead of
waiting on it.
"""

from __future__ import annotations

import logging
from typing import TYPE_CHECKING, Any, Callable, Iterable, Iterator, List, Optional, Sequence, Tuple

from ..device import DeviceLike
from ..obs import timed_labels
from .store import SeasonStore

if TYPE_CHECKING:  # pandas is imported inside build_spadl_store only
    import pandas as pd

logger = logging.getLogger(__name__)

__all__ = ['build_spadl_store', 'iter_packed_build']


def build_spadl_store(
    loader: Any,
    store: SeasonStore,
    competitions: Optional[Iterable[Tuple[Any, Any]]] = None,
    *,
    convert: Optional[Callable[['pd.DataFrame', Any], 'pd.DataFrame']] = None,
    atomic: bool = False,
    on_error: str = 'raise',
) -> SeasonStore:
    """Convert every game of the given competitions into ``store``.

    Parameters
    ----------
    loader : EventDataLoader
        Any provider loader (StatsBomb, Wyscout, Opta, ...): one with
        ``competitions()``, ``games()``, ``events()``, ``teams()`` and
        ``players()``.
    store : SeasonStore
        Open, writable store to populate.
    competitions : iterable of (competition_id, season_id), optional
        Defaults to every competition the loader advertises.
    convert : callable, optional
        ``convert(events, home_team_id) -> actions``. Defaults to the
        provider converter matching the loader class name.
    atomic : bool
        Additionally convert each game to Atomic-SPADL and store the
        atomic vocabulary (``atomic/spadl/config.py`` id space).
    on_error : {'raise', 'skip'}
        'skip' logs and continues past games whose feed files are missing
        or malformed.

    Returns
    -------
    SeasonStore
        ``store``, for chaining.
    """
    import pandas as pd

    from ..spadl import config as spadlcfg

    if convert is None:
        convert = _default_converter(loader)

    store.put('actiontypes', spadlcfg.actiontypes_df())
    store.put('results', spadlcfg.results_df())
    store.put('bodyparts', spadlcfg.bodyparts_df())
    if atomic:
        from ..atomic.spadl import config as atomiccfg
        from ..atomic.spadl import convert_to_atomic

        store.put('atomic_actiontypes', atomiccfg.actiontypes_df())

    comp_table = loader.competitions()
    store.put('competitions', comp_table)
    if competitions is None:
        competitions = list(
            comp_table[['competition_id', 'season_id']].itertuples(index=False)
        )

    all_games, all_teams, all_players = [], [], []
    for competition_id, season_id in competitions:
        games = loader.games(competition_id, season_id)
        for row in games.itertuples(index=False):
            game_id = row.game_id
            try:
                with timed_labels('pipeline/stage_seconds', stage='load_events'):
                    events = loader.events(game_id)
                    teams = loader.teams(game_id)
                    players = loader.players(game_id)
                with timed_labels('pipeline/stage_seconds', stage='convert'):
                    actions = convert(events, row.home_team_id)
                # inside the guarded region: a failure in the atomic
                # conversion or the writes must also be skippable, and no
                # metadata is appended for a partially-written game
                store.put_actions(game_id, actions)
                if atomic:
                    store.put_atomic_actions(game_id, convert_to_atomic(actions))
            except Exception:
                if on_error == 'skip':
                    logger.warning('skipping game %s', game_id, exc_info=True)
                    # drop any partially-written frames so keys()/game_ids()
                    # never enumerate a corrupt game
                    for key in (f'actions/game_{game_id}', f'atomic_actions/game_{game_id}'):
                        try:
                            store.delete(key)
                        except Exception:
                            logger.warning('could not clean up %s', key, exc_info=True)
                    continue
                raise
            # metadata only for games whose actions made it into the store
            all_games.append(games[games['game_id'] == game_id])
            all_teams.append(teams)
            all_players.append(players)
            logger.info('stored game %s (%d actions)', game_id, len(actions))

    empty = pd.DataFrame(columns=['game_id', 'home_team_id', 'away_team_id'])
    store.put('games', pd.concat(all_games, ignore_index=True) if all_games else empty)
    if all_teams:
        teams = pd.concat(all_teams, ignore_index=True)
        store.put('teams', teams.drop_duplicates(subset='team_id').reset_index(drop=True))
    if all_players:
        players = pd.concat(all_players, ignore_index=True)
        store.put('players', players.reset_index(drop=True))
    return store


def iter_packed_build(
    store: SeasonStore,
    games_per_batch: int,
    *,
    max_actions: int,
    float_dtype: Any = 'float32',
    device: DeviceLike = None,
    drop_remainder: bool = False,
    family: str = 'standard',
    cache_dir: Optional[str] = None,
) -> Iterator[Tuple[Any, List[Any]]]:
    """Stream the whole store in chunks while building its packed cache.

    Always covers the store's full ``game_ids()`` listing, in store order
    (the cache addresses rows positionally in that order). Yields exactly
    what ``iter_batches(store, games_per_batch, ...)`` yields for the full
    season, and writes every chunk's columns into a
    :class:`~socceraction_tpu_torch.pipeline.packed.PackedSeasonWriter`
    (timed under ``stage=cache_write``); the cache publishes atomically
    when the stream completes.

    A ``drop_remainder`` tail is still packed and written (the cache must
    cover every game), never yielded, and written *before* the last yield,
    so stopping at the final batch leaves the build complete. If the
    consumer closes the stream early, an *incomplete* build is discarded
    (no cache is published); a build whose every chunk was already
    written when the close lands IS published (a flush and a rename).
    """
    from .packed import FAMILIES, PackedSeasonWriter, _read_and_pack_chunk, ship_host_batch

    fam = FAMILIES[family]
    writer = PackedSeasonWriter(
        store, max_actions=max_actions, float_dtype=float_dtype,
        cache_dir=cache_dir, family=family,
    )
    game_ids: Sequence[Any] = writer.game_ids
    published = False
    finalize_started = False

    def _write_span(lo: int) -> Tuple[Any, List[Any]]:
        chunk = list(game_ids[lo : lo + games_per_batch])
        host = _read_and_pack_chunk(
            store, fam, chunk, writer.home,
            max_actions=max_actions, float_dtype=float_dtype,
        )
        with timed_labels('pipeline/stage_seconds', stage='cache_write'):
            writer.write_chunk(lo, host)
        return host, chunk

    spans = list(range(0, len(game_ids), games_per_batch))
    tail = None
    if drop_remainder and spans and len(game_ids) - spans[-1] < games_per_batch:
        tail = spans.pop()
    try:
        if tail is not None and not spans:
            _write_span(tail)  # every chunk is short: cache-only pass
        for i, lo in enumerate(spans):
            host, chunk = _write_span(lo)
            if tail is not None and i == len(spans) - 1:
                _write_span(tail)
            yield ship_host_batch(host, family=family, device=device), chunk
        finalize_started = True
        writer.finalize()
        published = True
    finally:
        if not published:
            # finalize_started: the publish itself failed (and cleaned up
            # in its own finally) — re-attempting would mask its error
            if writer.complete and not finalize_started:
                # closed after the last batch was produced: every row is
                # in the memmaps, so publishing costs a flush + rename.
                # Best-effort: a failed publish degrades to no cache.
                try:
                    writer.finalize()
                except Exception:
                    logger.warning(
                        'packed cache publish at close failed; discarding', exc_info=True
                    )
                    writer.abort()
            else:
                writer.abort()


def _default_converter(loader: Any) -> Callable[['pd.DataFrame', Any], 'pd.DataFrame']:
    """The SPADL converter of the provider the loader's class name names."""
    name = type(loader).__name__.lower()
    if 'statsbomb' in name:
        from ..spadl import statsbomb

        return statsbomb.convert_to_actions
    if 'wyscout' in name:
        from ..spadl import wyscout

        return wyscout.convert_to_actions
    if 'opta' in name:
        from ..spadl import opta

        return opta.convert_to_actions
    raise ValueError(
        f'cannot infer a SPADL converter for loader {type(loader).__name__}; '
        'pass convert= explicitly'
    )
