"""The learning loop's statistics: calibration, drift, shadow replay, the gate.

Port of the statistics of ``socceraction_tpu/learn``, the parts the
promotion gate reads:

- :mod:`.calibration`: reliability curves, ECE, the Brier decomposition
  and bootstrap intervals, binned through kernel B2 on the card;
- :mod:`.drift`: PSI and KS of a traffic window's fields and predictions
  against the active model's training reference (one B2 launch of masked
  histograms);
- :mod:`.shadow`: replay of captured traffic through a model, with its
  calibration per head;
- :mod:`.gate`: the calibration, drift and parity bands and the typed
  :class:`PromotionReport`;
- :mod:`.ingest`: :class:`SeasonWatcher` and :func:`extend_packed`, the
  incremental packed-cache build;
- :mod:`.loop`: :class:`ContinuousLearner`, the ingest → warm-started fit
  → shadow → gate → publish loop over the model registry, with the
  durable iteration journal; with ``service=`` a promotion swaps the
  serving model through ``service.swap_model`` and a rollback goes
  through ``service.rollback_model``.
"""

from .calibration import CalibrationSummary, calibration_summary, reliability_curve
from .drift import (
    DriftConfig,
    DriftReference,
    DriftResult,
    DriftWatch,
    build_drift_reference,
    drift_statistics,
)
from .gate import GateConfig, PromotionReport, compare_heads, evaluate_gate, record_report
from .ingest import SeasonWatcher, extend_packed, newest_game_ids
from .loop import ContinuousLearner, LearnConfig
from .shadow import ShadowResult, pack_replay_batch, replay_probs, shadow_replay

__all__ = [
    'CalibrationSummary',
    'ContinuousLearner',
    'DriftConfig',
    'DriftReference',
    'DriftResult',
    'DriftWatch',
    'GateConfig',
    'LearnConfig',
    'PromotionReport',
    'SeasonWatcher',
    'ShadowResult',
    'build_drift_reference',
    'calibration_summary',
    'compare_heads',
    'drift_statistics',
    'evaluate_gate',
    'extend_packed',
    'newest_game_ids',
    'pack_replay_batch',
    'record_report',
    'reliability_curve',
    'replay_probs',
    'shadow_replay',
]
