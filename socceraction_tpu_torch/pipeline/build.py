"""Build season artifacts: provider loader → store, and store → packed cache.

Port of the JAX package's ``socceraction_tpu/pipeline/build.py``.

:func:`build_spadl_store` converts every game of a provider loader into a
:class:`~socceraction_tpu_torch.pipeline.store.SeasonStore`: the
per-game frames plus the metadata and vocabulary tables. The port has no
SPADL converters yet, so the caller passes ``convert=``; without it the
call names the converter that is missing.

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
        Any provider loader (``competitions()``, ``games()``,
        ``events()``, ``teams()``, ``players()``).
    store : SeasonStore
        Open, writable store to populate.
    competitions : iterable of (competition_id, season_id), optional
        Defaults to every competition the loader advertises.
    convert : callable
        ``convert(events, home_team_id) -> actions``. Required: the port
        has no provider converters yet, and a call without it raises a
        ``ValueError`` that names the converter the JAX package would use.
    atomic : bool
        Also store each game as Atomic-SPADL. Needs the Atomic-SPADL
        converter, which the port does not have yet: raises
        ``ValueError``.
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
    if atomic:
        raise ValueError(
            'atomic=True needs the Atomic-SPADL converter (convert_to_atomic), '
            'which socceraction_tpu_torch does not have yet; store atomic frames '
            'with SeasonStore.put_atomic_actions'
        )

    store.put('actiontypes', spadlcfg.actiontypes_df())
    store.put('results', spadlcfg.results_df())
    store.put('bodyparts', spadlcfg.bodyparts_df())

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
                store.put_actions(game_id, actions)
            except Exception:
                if on_error == 'skip':
                    logger.warning('skipping game %s', game_id, exc_info=True)
                    # drop a partially-written frame so keys()/game_ids()
                    # never enumerate a corrupt game
                    try:
                        store.delete(f'actions/game_{game_id}')
                    except Exception:
                        logger.warning('could not clean up game %s', game_id, exc_info=True)
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


#: The JAX package's converter for each provider loader, by the loader
#: class name's provider word.
_CONVERTERS = {
    'statsbomb': 'spadl.statsbomb.convert_to_actions',
    'wyscout': 'spadl.wyscout.convert_to_actions',
    'opta': 'spadl.opta.convert_to_actions',
}


def _default_converter(loader: Any) -> Callable[['pd.DataFrame', Any], 'pd.DataFrame']:
    """Refuse to guess: name the converter a call without ``convert=``
    would need. The SPADL converters are not ported yet."""
    name = type(loader).__name__
    for provider, converter in _CONVERTERS.items():
        if provider in name.lower():
            raise ValueError(
                f'loader {name} needs the SPADL converter {converter}, which '
                'socceraction_tpu_torch does not have yet; pass convert= explicitly'
            )
    raise ValueError(
        f'cannot infer a SPADL converter for loader {name}; pass convert= explicitly'
    )
