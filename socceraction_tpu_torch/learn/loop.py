"""The continuous-learning orchestrator: stream → train → shadow → swap.

Port of the JAX package's ``socceraction_tpu/learn/loop.py``. Promotions
and rollbacks activate through the in-process
:class:`~socceraction_tpu_torch.serve.service.RatingService` when one is
attached (its ladder warmed before the swap goes live), and through the
:class:`~socceraction_tpu_torch.serve.registry.ModelRegistry` otherwise.
The journal, the registry's layout and every report are that package's,
so a journal or a registry written by either package is read by the
other.

:class:`ContinuousLearner` closes the loop between the ported subsystems.
One :meth:`~ContinuousLearner.run_once` iteration:

1. **ingest** — poll the :class:`~socceraction_tpu_torch.learn.ingest.SeasonWatcher`
   for newly landed matches; nothing new short-circuits to a
   ``no_new_data`` report (and a bitwise no-op on the serving model).
   Otherwise the packed cache is extended incrementally
   (:func:`~socceraction_tpu_torch.learn.ingest.extend_packed` — O(new
   matches) store IO).
2. **train** — stream the season through the packed feed
   (:func:`~socceraction_tpu_torch.pipeline.feed.iter_batches`, cache-hit)
   into :meth:`VAEP.fit_packed` on the card, **warm-started** from the
   active registry model's parameters (and in-process Adam state) so the
   candidate is an incremental continuation, not a from-scratch retrain.
   The fit launches the fused first layer (B1) every step and the
   segment sum (B2) in its statistics.
3. **shadow** — replay recent traffic (a
   :class:`~socceraction_tpu_torch.serve.capture.TrafficCapture`, falling
   back to the newest stored matches when no capture exists) through the
   candidate AND the active model over one byte-identical packed batch
   (:meth:`ContinuousLearner._replay_batch`); compute per-head calibration
   with bootstrap intervals on the card
   (:mod:`socceraction_tpu_torch.learn.calibration`, B2).
4. **gate** — apply the calibration bands
   (:class:`~socceraction_tpu_torch.learn.gate.GateConfig`); every
   decision becomes a typed
   :class:`~socceraction_tpu_torch.learn.gate.PromotionReport` recorded to
   the run log, the flight recorder and ``learn/*`` metrics.
5. **publish** — on pass, the staged candidate is atomically promoted to
   the next registry version and activated; on rejection the candidate
   stays staged for post-mortems, the retention policy
   (:meth:`ModelRegistry.gc_candidates`) bounds the backlog, and a
   flight-recorder debug bundle is dumped automatically.

:meth:`~ContinuousLearner.rollback` is the explicit escape hatch back to
the previously active version (counted under
``serve/model_swaps{reason="rollback"}``).

Every stage runs inside a ``learn/*`` span and lands its wall time in
the ``learn/stage_seconds{stage=...}`` histogram. The whole loop runs on
the CPU too, with a CPU registry (``ModelRegistry(root, device='cpu')``).
pandas is imported only where stored or captured frames are packed.
"""

from __future__ import annotations

import time
from dataclasses import dataclass, field
from typing import TYPE_CHECKING, Any, Callable, Dict, List, Optional, Tuple

from ..device import resolve_device
from ..obs import counter, histogram, span
from ..obs.recorder import RECORDER, default_debug_dir, dump_debug_bundle
from ..resil.faults import fault_point
from ..resil.journal import IterationJournal
from .drift import (
    DriftConfig,
    DriftResult,
    DriftWatch,
    build_drift_reference,
)
from .gate import (
    GateConfig,
    PromotionReport,
    compare_heads,
    evaluate_gate,
    record_report,
)
from .ingest import SeasonWatcher, extend_packed, newest_game_ids
from .shadow import ShadowResult, pack_replay_batch, shadow_replay

if TYPE_CHECKING:  # pandas is imported where frames are read or packed
    import pandas as pd

__all__ = ['ContinuousLearner', 'LearnConfig']


@dataclass
class LearnConfig:
    """Knobs of one :class:`ContinuousLearner`.

    ``train_params`` are the MLP head hyperparameters (``tree_params`` of
    :meth:`VAEP.fit_packed`); under a warm start they override the
    inherited schedule knobs while the architecture stays the warm
    model's. ``model_factory`` builds the bootstrap model (default: a
    fresh default :class:`~socceraction_tpu_torch.vaep.base.VAEP` on the
    registry's device).
    """

    model_name: str = 'vaep'
    max_actions: int = 1664
    games_per_batch: int = 64
    learner: str = 'mlp'
    train_params: Optional[Dict[str, Any]] = None
    fit_params: Optional[Dict[str, Any]] = None
    val_size: float = 0.25
    random_state: Optional[int] = 0
    warm_start: bool = True
    gate: GateConfig = field(default_factory=GateConfig)
    #: drift watch over the capture ring vs the active model's training
    #: reference; None (default) disables the watch entirely
    drift: Optional[DriftConfig] = None
    #: wait for at least this many new games before retraining — the
    #: drift watch is the early trigger: a triggered check overrides the
    #: floor and retrains on whatever has landed
    min_new_games: int = 1
    #: traffic source of last resort: replay the newest N stored matches
    #: when no capture ring is attached (or it is empty)
    fallback_replay_games: int = 8
    #: staged candidates kept by the retention policy after a rejection
    retention_keep: int = 2
    cache_dir: Optional[str] = None
    float_dtype: Any = 'float32'
    family: str = 'standard'
    model_factory: Optional[Callable[[], Any]] = None
    debug_dir: Optional[str] = None
    #: durable iteration journal (resil.journal.IterationJournal): every
    #: stage of every iteration is fsync'd here BEFORE its effects
    #: proceed, and a new learner replays it at startup — consumed games
    #: are never retrained, a half-finished publish is completed, and
    #: the decision trail survives any crash. None (default) keeps the
    #: in-memory-only behavior.
    journal_path: Optional[str] = None
    #: serving shapes to ship the kernel libraries for with every staged
    #: candidate (``{'ladder': (1, ..., B), 'max_actions': N}``: match the
    #: replicas' ``RatingService`` bucket ladder and capacity). The
    #: libraries ride the candidate through the promotion's atomic rename,
    #: so a replica hot-swapping to the promoted version runs no ``nvcc``
    #: (:mod:`socceraction_tpu_torch.serve.aot`). ``None`` (default) ships
    #: none.
    aot: Optional[Dict[str, Any]] = None


def _head_archs(model: Any) -> Dict[str, str]:
    """Per-head architecture kinds of a VAEP model (``{}`` for ``None``).

    The short names match the checkpoint head-kind vocabulary
    (``'mlp'``/``'seq'``); anything else — tree learners, test doubles —
    reports its class name, so the promotion record never loses the
    information, it just gets less pretty.
    """
    from ..ml.mlp import MLPClassifier
    from ..seq.classifier import SeqClassifier

    kinds: Dict[str, str] = {}
    for col, head in getattr(model, '_models', {}).items():
        if isinstance(head, SeqClassifier):
            kinds[col] = 'seq'
        elif isinstance(head, MLPClassifier):
            kinds[col] = 'mlp'
        else:
            kinds[col] = type(head).__name__
    return kinds


class ContinuousLearner:
    """Drives the stream → train → shadow-eval → gated activation loop.

    Parameters
    ----------
    store : SeasonStore
        Where new matches land.
    registry : ModelRegistry
        Versioned model store; the loop publishes candidates here, reads
        the active model as its warm-start / comparison baseline and
        activates promoted versions. The learner trains, replays and
        packs on the device the registry loads onto (``registry.device``;
        the card for a registry that names none).
    service : RatingService, optional
        A live serving front end. When given, promotions go through its
        pre-warmed atomic :meth:`swap_model`, :meth:`rollback` through its
        :meth:`rollback_model`, and the gate reads its numeric health.
    capture : TrafficCapture, optional
        Traffic source for the shadow replay and the drift watch; defaults
        to ``service.capture``.
    config : LearnConfig, optional
    prime_watcher : bool
        ``True`` (default when the registry already has an active model
        AND no journal is configured) marks the store's current games as
        consumed, so the first iteration only trains when *new* matches
        land. With a ``journal_path`` in the config, the journal's
        replayed ``consumed`` entries are the priming source instead —
        games that landed while the process was down stay *pending* and
        train on the first post-restart iteration.
    """

    def __init__(
        self,
        store: Any,
        registry: Any,
        *,
        service: Any = None,
        capture: Any = None,
        config: Optional[LearnConfig] = None,
        prime_watcher: Optional[bool] = None,
    ) -> None:
        self.store = store
        self.registry = registry
        self.service = service
        self.capture = capture if capture is not None else (
            getattr(service, 'capture', None) if service is not None else None
        )
        self.config = config if config is not None else LearnConfig()
        self.device = resolve_device(getattr(registry, 'device', None))
        if prime_watcher is None:
            # with a journal, the journal IS the consumption record: a
            # blanket "everything present is consumed" prime would mark
            # games that landed while the process was down as trained
            # (the exact restart gap the journal closes) — so prime from
            # the replayed 'consumed' entries instead
            prime_watcher = (
                self._active() is not None
                and not self.config.journal_path
            )
        self.watcher = SeasonWatcher(store, prime=prime_watcher)
        self.last_report: Optional[PromotionReport] = None
        self._drift_watch: Optional[DriftWatch] = None
        self._drift_version: Optional[str] = None
        self.journal: Optional[IterationJournal] = (
            IterationJournal(self.config.journal_path)
            if self.config.journal_path
            else None
        )
        self.last_recovery: Optional[Dict[str, Any]] = None
        if self.journal is not None:
            self._recover()

    # -- pieces ------------------------------------------------------------

    def _active(self) -> Optional[Tuple[str, str, Any]]:
        try:
            return self.registry.active()
        except RuntimeError:
            return None

    def _debug_dir(self) -> str:
        return self.config.debug_dir or default_debug_dir()

    def _journal_append(self, stage: str, **fields: Any) -> None:
        """Durably journal one iteration stage (no-op without a journal)."""
        if self.journal is not None:
            self.journal.append(
                stage, model_name=self.config.model_name, **fields
            )

    def _recover(self) -> None:
        """Replay the journal: re-consume games, finish half-done publishes.

        Runs once at construction, before the first :meth:`run_once`.
        Three invariants come out of it (see
        :mod:`socceraction_tpu_torch.resil.journal` for the stage grammar):

        - **no double-consumed games** — every game any past iteration
          committed is marked consumed on the fresh watcher, so a crash
          mid-iteration never retrains data it already trained on;
        - **no half-published registry** — a ``verdict: promoted``
          without ``published`` promotes the still-staged candidate
          under its intended version (the rename is atomic — an intent
          whose version dir already exists just proceeds); ``published``
          without ``activated`` activates/swap-warms the version;
        - **nothing silent** — every completion/abandonment is itself
          journaled (``recovered`` fields mark it), counted under
          ``resil/recoveries{outcome}`` and put in the flight recorder.

        A recovery step that *fails* (the registry is gone, the swap
        target no longer validates) records ``outcome='failed'`` and
        leaves the journal as-was — the next restart retries; the
        learner still constructs so the operator can inspect it.
        """
        assert self.journal is not None
        state = self.journal.replay()
        summary: Dict[str, Any] = {
            'consumed_games': len(state.consumed_games),
            'skipped_lines': state.skipped_lines,
            'pending_stage': state.pending_stage,
            'outcome': None,
        }
        if state.consumed_games:
            self.watcher.commit(state.consumed_games)
        pending = state.open_iteration
        if pending is not None:
            name = pending.get('model_name') or self.config.model_name
            tag = pending.get('tag')
            try:
                outcome = self._finish_pending(pending, name, tag)
            except Exception as e:
                outcome = 'failed'
                summary['error'] = f'{type(e).__name__}: {e}'
            summary['outcome'] = outcome
            counter('resil/recoveries', unit='count').inc(1, outcome=outcome)
        RECORDER.record('journal_recovery', **summary)
        try:
            # dual-write to the run log so `obsctl resil <runlog>` can
            # show what a restart found (the recorder ring dies with
            # the process)
            from ..obs.trace import current_runlog

            log = current_runlog()
            if log is not None:
                log.event('journal_recovery', **summary)
        except Exception:
            pass  # telemetry must not fail the recovery
        self.last_recovery = summary

    def _finish_pending(
        self, pending: Dict[str, Any], name: str, tag: Optional[str]
    ) -> str:
        """Complete (or close out) one half-done journaled iteration."""
        stage = pending.get('stage')
        verdict = pending.get('verdict')
        if stage in ('consumed',) or (stage == 'verdict' and verdict is None):
            # crashed in shadow/gate: games stay consumed, the staged
            # candidate stays for post-mortems, the iteration closes as
            # a recorded abandonment (retraining would double-consume)
            self._journal_append(
                'verdict', verdict='abandoned', tag=tag, recovered=True
            )
            return 'abandoned'
        if verdict != 'promoted':
            # a terminal verdict that somehow stayed open — close it
            self._journal_append(
                'verdict', verdict='abandoned', tag=tag, recovered=True
            )
            return 'abandoned'
        version = pending.get('version')
        if stage in ('verdict', 'intent_publish'):
            if version is None:
                version = self.registry.next_version(name)
                self._journal_append(
                    'intent_publish', version=version, tag=tag, recovered=True
                )
            # the crash may have hit between the atomic rename and its
            # journal entry: a version dir that already exists means the
            # publish completed — proceed straight to activation
            if version not in self.registry.versions(name):
                self.registry.promote_candidate(name, version, tag)
            self._journal_append(
                'published', version=version, tag=tag, recovered=True
            )
        if self.service is not None:
            self.service.swap_model(name, version)
        else:
            self.registry.activate(name, version)
        self._journal_append(
            'activated', version=version, tag=tag, recovered=True
        )
        return 'completed_publish'

    def _new_model(self, active_model: Any) -> Any:
        """An unfitted candidate shell matching the active feature layout,
        on the active model's device (with none: ``model_factory``, else a
        default :class:`VAEP` on the learner's device)."""
        if active_model is not None:
            return type(active_model)(
                xfns=list(active_model.xfns),
                nb_prev_actions=active_model.nb_prev_actions,
                device=active_model.device,
            )
        if self.config.model_factory is not None:
            return self.config.model_factory()
        from ..vaep.base import VAEP

        return VAEP(device=self.device)

    def _train_candidate(self, active_model: Any) -> Any:
        """Incremental fit: packed feed (cache hit) + warm start."""
        from ..pipeline.feed import iter_batches

        cfg = self.config
        candidate = self._new_model(active_model)
        batches = iter_batches(
            self.store,
            cfg.games_per_batch,
            max_actions=cfg.max_actions,
            float_dtype=cfg.float_dtype,
            device=candidate.device,
            packed_cache=cfg.cache_dir if cfg.cache_dir else True,
            family=cfg.family,
        )
        warm = active_model if (cfg.warm_start and active_model is not None) else None
        candidate.fit_packed(
            batches,
            learner=cfg.learner,
            val_size=cfg.val_size,
            tree_params=cfg.train_params,
            fit_params=cfg.fit_params,
            random_state=cfg.random_state,
            warm_start=warm,
        )
        return candidate

    def _build_manifest(
        self, candidate: Any, new_ids: Any
    ) -> Dict[str, Any]:
        """The candidate's training manifest (staged with the checkpoint).

        Two provenance facts a restarted process cannot reconstruct
        from the checkpoint alone:

        - ``trained_game_ids`` — everything this candidate's fit
          streamed (the whole store at train time: the packed feed is a
          full-season pass, warm-started or not);
        - ``drift_reference`` — the frozen PSI/KS reference
          (:meth:`DriftReference.to_dict`, bit-exact round trip) built
          from the newest stored matches *with the candidate's own
          prediction heads*, so once promoted, a drift watch rebuilt
          from the manifest is the watch the in-process learner uses
          (a restarted process cannot otherwise tell promoted-past games
          from training data).

        The reference is built only under a ``drift`` config (it costs
        a replay dispatch); the manifest with the id list is written
        always.
        """
        cfg = self.config
        trained = sorted(self.store.game_ids(), key=str)
        manifest: Dict[str, Any] = {
            'format_version': 1,
            'created_unix': round(time.time(), 3),
            'model_name': cfg.model_name,
            'trained_game_ids': trained,
            'new_game_ids': sorted(list(new_ids), key=str),
            'drift_reference': None,
        }
        if cfg.drift is not None:
            ids = newest_game_ids(trained, cfg.drift.reference_games)
            if ids:
                reference = build_drift_reference(
                    candidate, self._pack_games(ids), cfg.drift
                )
                manifest['drift_reference'] = reference.to_dict()
                manifest['drift_reference_games'] = list(ids)
        return manifest

    def _pack_games(self, ids: Any) -> Any:
        """Pack the given stored games into one replay batch on the
        learner's device (the shared reference-batch construction of the
        manifest build and the legacy drift-reference fallback)."""
        home = self.store.home_team_ids()
        frames = [
            (self.store.get_actions(gid), home.get(gid)) for gid in ids
        ]
        return pack_replay_batch(
            frames, max_actions=self.config.max_actions, device=self.device
        )

    def _parity_stats(self) -> Optional[Dict[str, Any]]:
        """The serving layer's numeric-health stats for the gate.

        The fail-closed ``GateConfig(max_parity_err=)`` input: the
        service's parity probe's stats plus its drained nonfinite-event
        count (``serve_nonfinite_events``: a NaN that reached served values
        makes the captured window untrustworthy whatever the paths' parity).
        None when no service (or no probe and no detections) is attached —
        with the band set, that absence itself blocks promotion.
        """
        probe = getattr(self.service, 'parity', None)
        stats = probe.stats() if probe is not None else None
        nonfinite = int(getattr(self.service, 'nonfinite_events', 0) or 0)
        if stats is None and nonfinite:
            stats = {'evaluated': False, 'probes': 0}
        if stats is not None:
            stats['serve_nonfinite_events'] = nonfinite
        return stats

    @staticmethod
    def _train_health_reasons(candidate: Any) -> List[str]:
        """Divergence verdicts from the candidate's training-health telemetry.

        Each MLP head records a :attr:`train_health_` dict inside its
        epoch dispatches (:mod:`socceraction_tpu_torch.ml.mlp`); any head that
        saw a non-finite loss/gradient step — or ended on non-finite
        norms — makes the candidate unpromotable regardless of what the
        shadow calibration would say about it.
        """
        reasons: List[str] = []
        for col, head in getattr(candidate, '_models', {}).items():
            health = getattr(head, 'train_health_', None)
            if health is None or health.get('finite', True):
                continue
            reasons.append(
                f'{col}: training diverged — '
                f'{health.get("nonfinite_steps", 0)} non-finite '
                f'loss/grad step(s) over {health.get("epochs", 0)} '
                f'epoch(s); grad_norm {health.get("grad_norm_last")}, '
                f'weight_norm {health.get("weight_norm_last")}'
            )
        return reasons

    def _replay_frames(
        self, exclude: Any = ()
    ) -> Tuple[List[Tuple['pd.DataFrame', Any]], str]:
        """The traffic window plus its actual source.

        Capture ring first (genuinely served traffic — kept even when it
        overlaps the new games), stored games as the fallback. The
        source travels with the frames so the report can never claim
        ``'capture'`` for a window that was actually the fallback (the
        ring may fill concurrently with this call).

        ``exclude`` (the games this iteration just trained on) is
        dropped from the *fallback* window: scoring the candidate on its
        own fresh training data while the active model is out-of-sample
        would bias the gate toward promotion. When nothing else exists
        (the bootstrap store is only new games), the in-sample window is
        used anyway but labeled ``'store_fallback_in_sample'`` so the
        report carries the caveat.
        """
        if self.capture is not None:
            frames = self.capture.frames()
            if frames:
                return frames, 'capture'
        n = int(self.config.fallback_replay_games)
        if n <= 0:
            return [], 'store_fallback'
        exclude = set(exclude)
        # numeric-aware recency: the raw listing is key-string ordered,
        # whose tail is NOT the newest games once ids grow a digit
        all_ids = self.store.game_ids()
        game_ids = newest_game_ids(
            [g for g in all_ids if g not in exclude], n
        )
        source = 'store_fallback'
        if not game_ids and exclude:
            game_ids = newest_game_ids(all_ids, n)
            source = 'store_fallback_in_sample'
        home = self.store.home_team_ids()
        return [
            (self.store.get_actions(gid), home.get(gid))
            for gid in game_ids
        ], source

    def _replay_batch(self, exclude: Any = ()) -> Tuple[Optional[Any], str]:
        """The traffic window packed into one batch on the learner's
        device, and its source (:meth:`_replay_frames`); ``None`` when the
        window is empty. Candidate and active replay this one batch."""
        frames, source = self._replay_frames(exclude=exclude)
        if not frames:
            return None, source
        return pack_replay_batch(
            frames, max_actions=self.config.max_actions, device=self.device
        ), source

    def _drift_check(
        self,
        active_model: Any,
        active_version: Optional[str],
        pending_ids: Any = (),
    ) -> Optional[DriftResult]:
        """Score the capture ring against the active model's reference.

        Returns None when the watch cannot run (no ``drift`` config, no
        active model, no captured traffic) — with the gate's
        ``max_drift_psi`` band set, that absence itself fails closed.
        The reference comes from the active version's registry
        **training manifest** first (:meth:`DriftWatch.from_manifest`):
        the frozen statistics the promoting learner wrote at stage time
        travel with the checkpoint, so an in-process rebuild and a
        process restart reconstruct the *identical* watch. Versions that
        predate manifests
        (bootstrap publishes, old registries) fall back to rebuilding
        from the newest stored matches, EXCLUDING ``pending_ids``
        (games landed but not yet consumed by a retrain): the active
        model never trained on those, and folding a drifted fresh batch
        into its own reference would make the watch compare drift
        against drift and read PSI ~0.
        """
        cfg = self.config
        if cfg.drift is None or active_model is None:
            return None
        if self.capture is None:
            return None
        frames = self.capture.frames()
        if not frames:
            return None
        if (
            self._drift_watch is None
            or self._drift_version != active_version
        ):
            watch: Optional[DriftWatch] = None
            try:
                manifest = self.registry.load_manifest(
                    cfg.model_name, active_version
                )
            except OSError:
                manifest = None  # transient read failure: legacy rebuild
            except ValueError as e:
                # a CORRUPT manifest must surface (load_manifest's
                # contract), but a drift check must not wedge the loop:
                # flag it loudly, then fall back to the legacy rebuild
                manifest = None
                counter('learn/manifest_corrupt', unit='count').inc(1)
                payload = {
                    'model': cfg.model_name,
                    'version': active_version,
                    'error': f'{type(e).__name__}: {e}',
                }
                RECORDER.record('manifest_corrupt', **payload)
                try:
                    from ..obs.trace import current_runlog

                    log = current_runlog()
                    if log is not None:
                        log.event('manifest_corrupt', **payload)
                except Exception:
                    pass
            if manifest and manifest.get('drift_reference'):
                watch = DriftWatch.from_manifest(
                    manifest, cfg.drift, model_version=active_version
                )
            if watch is None:
                pending = set(pending_ids)
                ids = newest_game_ids(
                    [g for g in self.store.game_ids() if g not in pending],
                    cfg.drift.reference_games,
                )
                if not ids:
                    return None
                watch = DriftWatch.from_batch(
                    active_model, self._pack_games(ids), cfg.drift,
                    model_version=active_version,
                )
            self._drift_watch = watch
            self._drift_version = active_version
        batch = pack_replay_batch(
            frames, max_actions=cfg.max_actions, device=self.device
        )
        return self._drift_watch.check(active_model, batch)

    # -- the loop ----------------------------------------------------------

    def run_once(self) -> PromotionReport:
        """One full loop iteration; returns (and records) the report."""
        cfg = self.config
        gate_cfg = cfg.gate
        stage_s: Dict[str, float] = {}

        def timed_stage(stage: str):
            return _StageTimer(stage, stage_s)

        with span('learn/loop', model=cfg.model_name):
            active = self._active()
            active_version = active[1] if active else None
            active_model = active[2] if active else None

            with timed_stage('ingest'), span('learn/ingest'):
                new_ids = self.watcher.poll()
                if new_ids:
                    extend_packed(
                        self.store,
                        max_actions=cfg.max_actions,
                        float_dtype=cfg.float_dtype,
                        cache_dir=cfg.cache_dir,
                        family=cfg.family,
                    )
            # the drift watch runs every iteration — continuous
            # monitoring, not promotion-time-only — and doubles as the
            # early retrain trigger below
            drift_res: Optional[DriftResult] = None
            if cfg.drift is not None:
                with timed_stage('drift'):
                    drift_res = self._drift_check(
                        active_model, active_version, pending_ids=new_ids
                    )
            drift_triggered = bool(drift_res is not None and drift_res.triggered)
            if not new_ids or (
                len(new_ids) < cfg.min_new_games and not drift_triggered
            ):
                # nothing to train on — or not enough yet and the serving
                # distribution is stable, so waiting is free (the
                # uncommitted games stay pending for the next poll)
                reasons = (
                    ['no new matches since the last iteration']
                    if not new_ids
                    else [
                        f'waiting: {len(new_ids)} new game(s) < '
                        f'min_new_games={cfg.min_new_games} and drift is '
                        'below trigger'
                    ]
                )
                report = PromotionReport(
                    name=cfg.model_name,
                    verdict='no_new_data',
                    reasons=reasons,
                    active_version=active_version,
                    drift=drift_res.to_dict() if drift_res else {},
                    archs=_head_archs(active_model),
                    stage_seconds=dict(stage_s),
                )
                self._finish(report)
                return report
            if drift_triggered and len(new_ids) < cfg.min_new_games:
                # the early trigger: the distribution moved, so retrain
                # on whatever has landed instead of waiting out the floor
                counter('learn/early_trains', unit='count').inc(1)
                RECORDER.record(
                    'drift_early_train',
                    new_games=len(new_ids),
                    min_new_games=cfg.min_new_games,
                    max_psi=drift_res.max_psi,
                    feature=drift_res.max_psi_feature,
                )
            counter('learn/new_games', unit='count').inc(len(new_ids))

            with timed_stage('train'), span('learn/train', games=len(new_ids)):
                candidate = self._train_candidate(active_model)
                tag, _path = self.registry.stage_candidate(
                    cfg.model_name,
                    candidate,
                    manifest=self._build_manifest(candidate, new_ids),
                    aot=cfg.aot,
                )
            # the games are consumed once a candidate was trained over
            # them — a rejected candidate must not retrain the same data
            # forever, and a crash before this line retries it. The
            # journal entry is written AFTER the in-memory commit but is
            # the durable half: a restarted learner re-consumes from the
            # journal, never from memory
            self.watcher.commit(new_ids)
            self._journal_append('consumed', games=list(new_ids), tag=tag)

            # everything past the commit must end in a recorded report —
            # an exception here would otherwise consume the games with no
            # decision trail anywhere (same contract as the publish guard)
            try:
                # training-health gate first: a diverging incremental
                # retrain is a poisoned candidate — reject it with a
                # typed report before the shadow replay can score NaN
                # probabilities (the games stay committed: retraining
                # the same data would diverge again). Inside this try on
                # purpose: a raise out of the rejection bookkeeping
                # still records the 'error' report below.
                health_reasons = self._train_health_reasons(candidate)
                if health_reasons:
                    counter('learn/training_diverged', unit='count').inc(1)
                    self._journal_append(
                        'verdict', verdict='rejected', tag=tag
                    )
                    report = PromotionReport(
                        name=cfg.model_name,
                        verdict='rejected',
                        reasons=health_reasons,
                        active_version=active_version,
                        candidate_tag=tag,
                        new_games=list(new_ids),
                        drift=drift_res.to_dict() if drift_res else {},
                        archs=_head_archs(candidate),
                        stage_seconds=dict(stage_s),
                    )
                    self.registry.gc_candidates(
                        cfg.model_name, keep=cfg.retention_keep
                    )
                    try:
                        dump_debug_bundle(
                            self._debug_dir(),
                            reason='training_diverged',
                            trigger={
                                'type': 'training_diverged',
                                **report.to_dict(),
                            },
                        )
                    except Exception:
                        pass  # a failing dump must never unwind the verdict
                    self._finish(report)
                    return report

                act_res: Optional[ShadowResult] = None
                cand_res: Optional[ShadowResult] = None
                with timed_stage('shadow'), span('learn/shadow'):
                    batch, replay_source = self._replay_batch(exclude=new_ids)
                    if batch is not None:
                        # ONE packed batch replayed through both models:
                        # candidate and active see byte-identical inputs
                        # and labels
                        cand_res = shadow_replay(
                            candidate, batch=batch,
                            n_bins=gate_cfg.n_bins, n_boot=gate_cfg.n_boot,
                            seed=gate_cfg.seed, ci_level=gate_cfg.ci_level,
                        )
                        if active_model is not None:
                            act_res = shadow_replay(
                                active_model, batch=batch,
                                n_bins=gate_cfg.n_bins,
                                n_boot=gate_cfg.n_boot,
                                seed=gate_cfg.seed,
                                ci_level=gate_cfg.ci_level,
                            )
                if cand_res is None:
                    # fail CLOSED, but on the record: the candidate stays
                    # staged unevaluated and the decision is a typed
                    # report (built OUTSIDE the stage timer, so the
                    # shadow wall it just measured is included)
                    self._journal_append(
                        'verdict', verdict='rejected', tag=tag
                    )
                    report = PromotionReport(
                        name=cfg.model_name,
                        verdict='rejected',
                        reasons=[
                            'no replay traffic available (capture empty '
                            'and the store fallback is disabled)'
                        ],
                        active_version=active_version,
                        candidate_tag=tag,
                        new_games=list(new_ids),
                        drift=drift_res.to_dict() if drift_res else {},
                        archs=_head_archs(candidate),
                        stage_seconds=dict(stage_s),
                    )
                    self.registry.gc_candidates(
                        cfg.model_name, keep=cfg.retention_keep
                    )
                    self._finish(report)
                    return report

                with timed_stage('gate'), span('learn/gate'):
                    parity_stats = self._parity_stats()
                    passed, reasons = evaluate_gate(
                        act_res.summaries if act_res else None,
                        cand_res.summaries,
                        gate_cfg,
                        drift=drift_res,
                        parity=parity_stats,
                    )
            except Exception as e:
                self._journal_append('verdict', verdict='error', tag=tag)
                report = PromotionReport(
                    name=cfg.model_name,
                    verdict='error',
                    reasons=[
                        f'shadow/gate failed: {type(e).__name__}: {e}'
                    ],
                    active_version=active_version,
                    candidate_tag=tag,
                    new_games=list(new_ids),
                    archs=_head_archs(candidate),
                    stage_seconds=dict(stage_s),
                )
                self.registry.gc_candidates(
                    cfg.model_name, keep=cfg.retention_keep
                )
                self._finish(report)
                raise

            report = PromotionReport(
                name=cfg.model_name,
                verdict='promoted' if passed else 'rejected',
                reasons=reasons,
                active_version=active_version,
                candidate_tag=tag,
                new_games=list(new_ids),
                heads=compare_heads(
                    act_res.summaries if act_res else {}, cand_res.summaries
                ),
                replay={
                    'frames': cand_res.n_frames,
                    'actions': cand_res.n_actions,
                    'source': replay_source,
                },
                drift=drift_res.to_dict() if drift_res else {},
                parity=parity_stats or {},
                archs=_head_archs(candidate),
            )

            self._journal_append(
                'verdict',
                verdict='promoted' if passed else 'rejected',
                tag=tag,
            )
            if passed:
                try:
                    with timed_stage('publish'), span('learn/publish'):
                        version = self.registry.next_version(cfg.model_name)
                        # write-ahead intent: a crash between the atomic
                        # rename below and its 'published' entry is
                        # recoverable because the intended version is
                        # already durable (the restart checks whether
                        # the rename landed and resumes either way)
                        self._journal_append(
                            'intent_publish', version=version, tag=tag
                        )
                        fault_point('learn.publish', version=version)
                        self.registry.promote_candidate(
                            cfg.model_name, version, tag
                        )
                        self._journal_append(
                            'published', version=version, tag=tag
                        )
                        if self.service is not None:
                            self.service.swap_model(cfg.model_name, version)
                        else:
                            self.registry.activate(cfg.model_name, version)
                        self._journal_append(
                            'activated', version=version, tag=tag
                        )
                        report.candidate_version = version
                        self._transplant_opt_state(candidate)
                except Exception as e:
                    # an operational publish failure (version race, disk,
                    # swap validation) still gets a typed decision record
                    # before it surfaces — the report contract holds for
                    # every iteration that got past the commit
                    report.verdict = 'publish_failed'
                    report.reasons = [
                        f'publish failed: {type(e).__name__}: {e}'
                    ]
                    report.candidate_version = None
                    report.stage_seconds = dict(stage_s)
                    self._finish(report)
                    raise
            else:
                # the rejected candidate stays staged for post-mortems;
                # retention bounds the backlog, and the flight recorder
                # is dumped with the full decision attached
                self.registry.gc_candidates(
                    cfg.model_name, keep=cfg.retention_keep
                )
                try:
                    dump_debug_bundle(
                        self._debug_dir(),
                        reason='promotion_rejected',
                        trigger={
                            'type': 'promotion_rejected',
                            **report.to_dict(),
                        },
                    )
                except Exception:
                    pass  # a failing dump must never unwind the verdict

            report.stage_seconds = dict(stage_s)
            self._finish(report)
            return report

    def _transplant_opt_state(self, candidate: Any) -> None:
        """Carry the candidate's adam state onto the freshly *loaded* active.

        Promotion activates the checkpoint read back from disk —
        parameter-identical to the candidate (the checkpoint codec's round
        trip is exact) but with ``opt_state_ = None``, because checkpoints
        deliberately exclude optimizer state. Transplanting the
        in-process state keeps the next iteration's warm start a true
        optimizer continuation; across process restarts it degrades
        gracefully to a params-only warm start. Architecture-checked per
        head: both packed head kinds (MLP and the seq head) carry adam
        state, but state only transplants between heads of the SAME
        class — a cross-architecture promotion starts the next iteration
        cold, which is also what its warm-start path does.
        """
        from ..ml.mlp import MLPClassifier
        from ..seq.classifier import SeqClassifier

        try:
            active = self.registry.active()[2]
        except RuntimeError:
            return
        for col, head in getattr(active, '_models', {}).items():
            cand_head = candidate._models.get(col)
            if (
                isinstance(head, (MLPClassifier, SeqClassifier))
                and type(cand_head) is type(head)
                and cand_head.opt_state_ is not None
            ):
                head.opt_state_ = cand_head.opt_state_

    def _finish(self, report: PromotionReport) -> None:
        for stage, seconds in report.stage_seconds.items():
            histogram('learn/stage_seconds', unit='s').observe(
                seconds, stage=stage
            )
        record_report(report)
        self.last_report = report

    # -- rollback ----------------------------------------------------------

    def rollback(self) -> Tuple[str, str]:
        """Restore the previously active version (explicit escape hatch).

        Through the service when one is attached (ladder pre-warmed
        before the swap goes live), directly on the registry otherwise.
        Either way the swap is atomic and counted under
        ``serve/model_swaps{reason="rollback"}``.
        """
        if self.service is not None:
            name, version = self.service.rollback_model()
        else:
            name, version = self.registry.rollback()
        counter('learn/rollbacks', unit='count').inc(1)
        RECORDER.record('rollback', name=name, version=version)
        return name, version


class _StageTimer:
    """Record one stage's wall clock into a shared dict on exit."""

    def __init__(self, stage: str, sink: Dict[str, float]) -> None:
        self.stage = stage
        self.sink = sink

    def __enter__(self) -> '_StageTimer':
        self.t0 = time.perf_counter()
        return self

    def __exit__(self, *exc: Any) -> None:
        self.sink[self.stage] = (
            self.sink.get(self.stage, 0.0) + time.perf_counter() - self.t0
        )
