"""The promotion gate: calibration bands, typed reports, recording.

Port of ``socceraction_tpu/learn/gate.py`` (a copy on the port's
:mod:`~socceraction_tpu_torch.obs`). A candidate model is promoted only
when its calibration on the shadow replay does not regress beyond
configured bands: the deployment criterion is statistical (reliability,
uncertainty), not a marginally better loss. The gate compares candidate
and active per probability head and produces a typed
:class:`PromotionReport`, recorded in the active
:class:`~socceraction_tpu_torch.obs.trace.RunLog` (a ``promotion_report``
event), the flight recorder ring and the ``learn`` metrics
(``learn/promotions{verdict}``, per-head ``learn/ece``/``learn/brier``).
"""

from __future__ import annotations

import time
from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional, Tuple

from ..obs import RECORDER, counter, gauge
from ..obs.trace import current_runlog
from .calibration import CalibrationSummary

__all__ = ['GateConfig', 'PromotionReport', 'compare_heads', 'evaluate_gate', 'record_report']


@dataclass(frozen=True)
class GateConfig:
    """Calibration bands and replay parameters of the promotion gate.

    A candidate is **blocked** when, on any head, its expected
    calibration error exceeds the active model's by more than
    ``max_ece_regression`` or its Brier score by more than
    ``max_brier_regression``. Bands are absolute deltas on [0, 1]
    metrics; negative deltas (improvements) always pass. Bootstrap CIs
    ride along in the report as evidence — the verdict itself stays a
    deterministic function of the point estimates and bands, so the same
    replay always gates the same way.

    ``min_replay_actions`` refuses to promote on a traffic window too
    small to measure calibration at all (the gate fails *closed*: no
    evidence, no promotion).

    ``max_drift_psi``, when set, adds the drift watch as a second
    fail-closed input: a candidate is blocked when the serving traffic
    has drifted past the band from the active model's training reference
    (the calibration comparison is then answering the wrong question —
    both models are being scored on a distribution neither trained on),
    **and** when the drift statistics are unavailable (window too small,
    no watch configured): no evidence, no promotion, same direction as
    ``min_replay_actions``.

    ``max_parity_err``, when set, adds the serving layer's shadow-parity
    probe (:class:`socceraction_tpu_torch.obs.parity.ParityProbe`) as a third
    fail-closed input: a candidate is blocked when the probe's worst
    observed fused-vs-reference error exceeds the band — a numerically
    broken serving path makes every calibration number measured through
    it untrustworthy — when the serving service's in-dispatch guards
    detected non-finite values (``serve_nonfinite_events`` in the
    stats: the captured traffic window itself is suspect), and, in the
    same fail-closed direction, when no parity statistics exist at all
    (no probe attached, nothing sampled yet): no evidence, no
    promotion.
    """

    max_ece_regression: float = 0.01
    max_brier_regression: float = 0.005
    min_replay_actions: int = 64
    max_drift_psi: Optional[float] = None
    max_parity_err: Optional[float] = None
    n_bins: int = 10
    n_boot: int = 200
    seed: int = 0
    ci_level: float = 0.95


@dataclass
class PromotionReport:
    """One loop iteration's full decision record (JSON-ready via
    :meth:`to_dict`). ``verdict`` is one of ``'promoted'``,
    ``'rejected'``, ``'no_new_data'``, ``'publish_failed'`` (the gate
    passed but the registry publish / service swap raised), or
    ``'error'`` (the shadow/gate stages themselves raised). The two
    failure verdicts are recorded *before* the error surfaces to the
    caller — every iteration that consumed data leaves a decision
    trail."""

    name: str
    verdict: str
    reasons: List[str] = field(default_factory=list)
    active_version: Optional[str] = None
    candidate_tag: Optional[str] = None
    #: set only when the candidate was actually published
    candidate_version: Optional[str] = None
    new_games: List[Any] = field(default_factory=list)
    #: per-head metric comparison:
    #: ``{head: {'candidate': {...}, 'active': {...}, 'delta_ece': .,
    #: 'delta_brier': .}}`` (summaries are CalibrationSummary.to_dict())
    heads: Dict[str, Dict[str, Any]] = field(default_factory=dict)
    replay: Dict[str, Any] = field(default_factory=dict)
    #: the drift watch's statistics for this iteration's traffic window
    #: (``DriftResult.to_dict()``; empty when no watch is configured)
    drift: Dict[str, Any] = field(default_factory=dict)
    #: the serving parity probe's lifetime stats at gate time
    #: (``ParityProbe.stats()``; empty when no probe is attached)
    parity: Dict[str, Any] = field(default_factory=dict)
    #: the candidate's per-head architecture (``{head: 'mlp'|'seq'|...}``)
    #: so operators can tell which model KIND a verdict judged — an mlp
    #: and a seq candidate pass the same gates but are different programs
    archs: Dict[str, str] = field(default_factory=dict)
    stage_seconds: Dict[str, float] = field(default_factory=dict)
    time_unix: float = field(default_factory=time.time)

    @property
    def promoted(self) -> bool:
        """True iff this iteration published (and activated) the candidate."""
        return self.verdict == 'promoted'

    def to_dict(self) -> Dict[str, Any]:
        """JSON-ready rendering — the run-log/recorder event payload."""
        return {
            'name': self.name,
            'verdict': self.verdict,
            'reasons': list(self.reasons),
            'active_version': self.active_version,
            'candidate_tag': self.candidate_tag,
            'candidate_version': self.candidate_version,
            'new_games': [
                g.item() if hasattr(g, 'item') else g for g in self.new_games
            ],
            'heads': self.heads,
            'replay': dict(self.replay),
            'drift': dict(self.drift),
            'parity': dict(self.parity),
            'archs': dict(self.archs),
            'stage_seconds': {
                k: round(v, 6) for k, v in self.stage_seconds.items()
            },
            'time_unix': self.time_unix,
        }


def compare_heads(
    active: Dict[str, CalibrationSummary],
    candidate: Dict[str, CalibrationSummary],
) -> Dict[str, Dict[str, Any]]:
    """The report's per-head block: both summaries plus the deltas."""
    heads: Dict[str, Dict[str, Any]] = {}
    for col, cand in candidate.items():
        entry: Dict[str, Any] = {'candidate': cand.to_dict()}
        act = active.get(col) if active else None
        if act is not None:
            entry['active'] = act.to_dict()
            entry['delta_ece'] = cand.ece - act.ece
            entry['delta_brier'] = cand.brier - act.brier
        heads[col] = entry
    return heads


def evaluate_gate(
    active: Optional[Dict[str, CalibrationSummary]],
    candidate: Dict[str, CalibrationSummary],
    config: GateConfig,
    *,
    drift: Any = None,
    parity: Optional[Dict[str, Any]] = None,
) -> Tuple[bool, List[str]]:
    """Apply the calibration bands; returns ``(passed, reasons)``.

    ``active=None`` is the bootstrap case (no serving baseline yet): the
    candidate passes by default, with the reason recorded. Otherwise
    every head must stay within both bands; all violations are listed,
    not just the first.

    ``drift`` is the iteration's
    :class:`~socceraction_tpu_torch.learn.drift.DriftResult` (or None). With
    ``config.max_drift_psi`` set the drift check is fail-closed: absent
    or unevaluated statistics block exactly like a breach — the gate
    must not certify calibration measured on a distribution it cannot
    vouch for. Drift reasons apply even in the bootstrap case.

    ``parity`` is the serving parity probe's
    :meth:`~socceraction_tpu_torch.obs.parity.ParityProbe.stats` dict (or
    None). With ``config.max_parity_err`` set the check is fail-closed
    in the same way: no probe statistics, or a worst observed error past
    the band, both block — calibration measured through a numerically
    diverged serving path proves nothing. Parity reasons apply even in
    the bootstrap case.
    """
    reasons: List[str] = []
    if config.max_drift_psi is not None:
        if drift is None or not getattr(drift, 'evaluated', False):
            reasons.append(
                'drift: statistics unavailable for this replay window '
                '(fail closed; configure a drift watch or widen the '
                'capture window)'
            )
        elif drift.max_psi > config.max_drift_psi:
            reasons.append(
                f'drift: {drift.max_psi_feature} PSI {drift.max_psi:.4f} '
                f'> band {config.max_drift_psi:.4f} — the replay window '
                'no longer resembles the training reference'
            )
    if config.max_parity_err is not None:
        if parity and parity.get('serve_nonfinite_events'):
            reasons.append(
                'numerics: the serving service detected '
                f'{parity["serve_nonfinite_events"]} non-finite dispatch '
                'value(s) — traffic served (and captured) through a '
                'non-finite path is not promotion evidence (fail closed)'
            )
        if not parity or not parity.get('evaluated'):
            reasons.append(
                'parity: no shadow-parity probes observed (fail closed; '
                'attach a ParityProbe to the serving service so the '
                'fused path is measured against the reference)'
            )
        elif parity['max_abs_err'] > config.max_parity_err:
            reasons.append(
                'parity: fused-vs-reference max abs error '
                f'{parity["max_abs_err"]:.3e} > band '
                f'{config.max_parity_err:.3e} over {parity["probes"]} '
                'probe(s) — the serving path numerically diverged from '
                'the reference implementation'
            )
    if active is None:
        if reasons:
            return False, reasons
        return True, ['bootstrap: no active model to compare against']
    for col, cand in candidate.items():
        act = active.get(col)
        if act is None:
            reasons.append(f'{col}: active model has no such head')
            continue
        if cand.n < config.min_replay_actions:
            reasons.append(
                f'{col}: replay window too small '
                f'({cand.n:.0f} < {config.min_replay_actions} actions)'
            )
            continue
        ci_pct = f'{cand.ci_level:.0%}'
        d_ece = cand.ece - act.ece
        if d_ece > config.max_ece_regression:
            reasons.append(
                f'{col}: ECE regressed {act.ece:.4f} -> {cand.ece:.4f} '
                f'(+{d_ece:.4f} > band {config.max_ece_regression:.4f}; '
                f'candidate {ci_pct} CI '
                f'[{cand.ece_ci[0]:.4f}, {cand.ece_ci[1]:.4f}])'
            )
        d_brier = cand.brier - act.brier
        if d_brier > config.max_brier_regression:
            reasons.append(
                f'{col}: Brier regressed {act.brier:.4f} -> {cand.brier:.4f} '
                f'(+{d_brier:.4f} > band {config.max_brier_regression:.4f}; '
                f'candidate {ci_pct} CI '
                f'[{cand.brier_ci[0]:.4f}, {cand.brier_ci[1]:.4f}])'
            )
    return not reasons, reasons


def record_report(report: PromotionReport) -> None:
    """Land one report in the run log, the flight recorder and metrics.

    Call once per loop iteration, after the verdict is final (including
    the published version on promotion). Never raises — the decision has
    already been acted on; losing telemetry must not unwind it.
    """
    payload = report.to_dict()
    counter('learn/promotions', unit='count').inc(1, verdict=report.verdict)
    for col, entry in report.heads.items():
        for which in ('candidate', 'active'):
            metrics = entry.get(which)
            if metrics:
                gauge('learn/ece', unit='value').set(
                    metrics['ece'], head=col, model=which
                )
                gauge('learn/brier', unit='value').set(
                    metrics['brier'], head=col, model=which
                )
    try:
        RECORDER.record('promotion_report', **payload)
        log = current_runlog()
        if log is not None:
            log.event('promotion_report', **payload)
    except Exception:
        pass
