"""Drift watch: PSI and KS of live traffic against the training reference.

Port of ``socceraction_tpu/learn/drift.py``. Between promotions the
serving model runs blind: if the traffic moves (another league's pitch
geometry, a rule change shifting the shot mix, a provider re-mapping
action types) nothing notices until a retrain happens to catch it. This
module watches the serving distribution itself:

- :func:`build_drift_reference` fixes per-row bin edges and reference
  proportions from the active model's training data (a packed batch):
  raw packed action fields (locations, clock, type/result/bodypart ids)
  and each head's prediction distribution;
- :class:`DriftWatch` / :func:`drift_statistics` score a traffic window
  against it with the population stability index (PSI,
  ``Σ (p - q)·ln(p/q)``) and a binned Kolmogorov–Smirnov statistic per
  row.

The stacked ``(F, N)`` rows stay on the batch's device, and the ``F ×
n_bins`` masked histograms are one
:func:`~socceraction_tpu_torch.ops.segment.segment_sum` over ids ``row ·
n_bins + bin`` (kernel B2 on the card). A bin index is truncated toward
zero, then clipped, as in the JAX package, and weights are 0/1, so the
counts equal the JAX package's bitwise. A zero-weight (padding) row counts
in no bin.

Results land in ``drift/*`` gauges and counters, a ``drift_check`` event
in the run log and the flight recorder, and the typed
:class:`DriftResult` the promotion gate reads (``max_drift_psi``).
"""

from __future__ import annotations

from dataclasses import dataclass, field, replace
from typing import Any, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from ..obs import counter, gauge, span
from ..obs.recorder import RECORDER
from ..obs.trace import current_runlog
from ..ops.segment import segment_sum

__all__ = [
    'DriftConfig',
    'DriftReference',
    'DriftResult',
    'DriftWatch',
    'build_drift_reference',
    'drift_statistics',
]

#: Packed action fields monitored by default: the continuous geometry and
#: clock, and the categorical ids (binned by value).
DEFAULT_FIELDS: Tuple[str, ...] = (
    'start_x', 'start_y', 'end_x', 'end_y', 'time_seconds',
    'type_id', 'result_id', 'bodypart_id',
)

_EPS = 1e-6


@dataclass(frozen=True)
class DriftConfig:
    """Knobs of one drift watch.

    ``psi_trigger`` uses the classic banding (PSI < 0.1 stable, 0.1 to
    0.25 drifting, > 0.25 shifted). ``min_actions`` refuses to score a
    window too small to estimate proportions (the result then reports
    ``evaluated=False``, which the gate's ``max_drift_psi`` band treats
    as no evidence).
    """

    n_bins: int = 16
    psi_trigger: float = 0.25
    ks_trigger: Optional[float] = None
    min_actions: int = 256
    fields: Tuple[str, ...] = DEFAULT_FIELDS
    include_predictions: bool = True
    #: stored matches used to build the training reference (newest-first)
    reference_games: int = 16


@dataclass(frozen=True)
class DriftReference:
    """Frozen training-side distribution: bin edges and proportions.

    ``lo``/``hi`` fix the equal-width bin edges of each monitored row
    (prediction rows are pinned to [0, 1]); ``props`` is the ``(F,
    n_bins)`` reference proportion stack. Host numpy, float32.
    """

    names: Tuple[str, ...]
    lo: np.ndarray
    hi: np.ndarray
    props: np.ndarray
    n_bins: int
    n_actions: int
    model_version: Optional[str] = None

    def to_dict(self) -> Dict[str, Any]:
        """JSON-able form for a training manifest: every float32 as a
        Python float, which JSON round-trips exactly, so :meth:`from_dict`
        rebuilds the reference bit for bit."""
        return {
            'names': list(self.names),
            'lo': [float(v) for v in np.asarray(self.lo, np.float32)],
            'hi': [float(v) for v in np.asarray(self.hi, np.float32)],
            'props': [[float(v) for v in row] for row in np.asarray(self.props, np.float32)],
            'n_bins': int(self.n_bins),
            'n_actions': int(self.n_actions),
            'model_version': self.model_version,
        }

    @classmethod
    def from_dict(cls, d: Dict[str, Any]) -> 'DriftReference':
        """Rebuild a reference serialized with :meth:`to_dict` (exact)."""
        return cls(
            names=tuple(d['names']),
            lo=np.asarray(d['lo'], np.float32),
            hi=np.asarray(d['hi'], np.float32),
            props=np.asarray(d['props'], np.float32),
            n_bins=int(d['n_bins']),
            n_actions=int(d['n_actions']),
            model_version=d.get('model_version'),
        )


@dataclass
class DriftResult:
    """One window's drift statistics against the reference (JSON-ready)."""

    psi: Dict[str, float] = field(default_factory=dict)
    ks: Dict[str, float] = field(default_factory=dict)
    max_psi: float = 0.0
    max_psi_feature: Optional[str] = None
    max_ks: float = 0.0
    max_ks_feature: Optional[str] = None
    n_actions: int = 0
    reference_actions: int = 0
    #: False when the window was too small to score (no statistics)
    evaluated: bool = True
    triggered: bool = False
    reasons: List[str] = field(default_factory=list)

    def to_dict(self) -> Dict[str, Any]:
        """Flat rendering for reports, run-log events and ``obsctl``."""
        return {
            'psi': {k: round(v, 6) for k, v in self.psi.items()},
            'ks': {k: round(v, 6) for k, v in self.ks.items()},
            'max_psi': round(self.max_psi, 6),
            'max_psi_feature': self.max_psi_feature,
            'max_ks': round(self.max_ks, 6),
            'max_ks_feature': self.max_ks_feature,
            'n_actions': self.n_actions,
            'reference_actions': self.reference_actions,
            'evaluated': self.evaluated,
            'triggered': self.triggered,
            'reasons': list(self.reasons),
        }


def _stack_rows(
    batch: Any, fields: Sequence[str], probs: Optional[Dict[str, torch.Tensor]]
) -> Tuple[Tuple[str, ...], torch.Tensor, torch.Tensor]:
    """``(names, x (F, N) f32, w (N,) f32)`` on the batch's device: the
    monitored fields, then each head's predictions (heads sorted)."""
    rows = [getattr(batch, f).reshape(-1).to(torch.float32) for f in fields]
    names = list(fields)
    for head in sorted(probs or {}):
        rows.append(torch.as_tensor(probs[head], device=batch.device).reshape(-1).to(torch.float32))
        names.append(f'pred_{head}')
    w = batch.mask.reshape(-1).to(torch.float32)
    return tuple(names), torch.stack(rows), w


def _props(
    x: torch.Tensor, w: torch.Tensor, lo: np.ndarray, hi: np.ndarray, n_bins: int
) -> torch.Tensor:
    """``(F, n_bins)`` masked equal-width bin proportions of every row, in
    one segment sum over ids ``row · n_bins + bin``."""
    f = x.shape[0]
    lo_t = torch.as_tensor(np.asarray(lo, np.float32), device=x.device)[:, None]
    hi_t = torch.as_tensor(np.asarray(hi, np.float32), device=x.device)[:, None]
    width = torch.clamp(hi_t - lo_t, min=_EPS)
    t = (x - lo_t) / width
    bins = (t * n_bins).to(torch.int32).clamp(0, n_bins - 1)
    ids = bins + n_bins * torch.arange(f, dtype=torch.int32, device=x.device)[:, None]
    cnt = segment_sum(w.expand(f, -1), ids, f * n_bins).reshape(f, n_bins)
    return cnt / torch.clamp(cnt.sum(1, keepdim=True), min=_EPS)


def build_drift_reference(
    model: Any,
    batch: Any,
    config: Optional[DriftConfig] = None,
    *,
    model_version: Optional[str] = None,
) -> DriftReference:
    """Freeze the training-side distribution of ``model`` over ``batch``.

    ``batch`` is a packed batch of the matches the active model trained
    on, on the model's device. Bin edges are the reference's own masked
    min/max per field (a constant field gets a width of 1); prediction
    rows are pinned to [0, 1].
    """
    from .shadow import replay_probs

    cfg = config if config is not None else DriftConfig()
    probs = replay_probs(model, batch) if cfg.include_predictions else None
    names, x, w = _stack_rows(batch, cfg.fields, probs)
    n_actions = batch.total_actions
    if n_actions == 0:
        raise ValueError('cannot build a drift reference from an empty batch')
    valid = w > 0
    lo_hi = torch.stack([
        torch.where(valid, x, torch.inf).amin(1),
        torch.where(valid, x, -torch.inf).amax(1),
    ]).cpu().numpy()
    lo = lo_hi[0].astype(np.float32)
    hi = lo_hi[1].astype(np.float32)
    for i, name in enumerate(names):
        if name.startswith('pred_'):
            lo[i], hi[i] = 0.0, 1.0
        elif hi[i] <= lo[i]:
            hi[i] = lo[i] + 1.0  # a constant field still bins sanely
    props = _props(x, w, lo, hi, int(cfg.n_bins)).cpu().numpy()
    return DriftReference(
        names=names, lo=lo, hi=hi, props=props,
        n_bins=int(cfg.n_bins), n_actions=n_actions, model_version=model_version,
    )


def drift_statistics(
    reference: DriftReference,
    batch: Any,
    probs: Optional[Dict[str, torch.Tensor]] = None,
    *,
    fields: Optional[Sequence[str]] = None,
) -> Tuple[Dict[str, float], Dict[str, float], int]:
    """``(psi, ks, n_actions)`` of one window against the reference; the
    window's rows must be the reference's (same fields, same heads)."""
    use_fields = tuple(fields) if fields is not None else tuple(
        n for n in reference.names if not n.startswith('pred_')
    )
    names, x, w = _stack_rows(batch, use_fields, probs)
    if names != reference.names:
        raise ValueError(
            f'window rows {names} do not match the reference {reference.names}; '
            'rebuild the reference for this model'
        )
    p = _props(x, w, reference.lo, reference.hi, int(reference.n_bins))
    # clamp and renormalize both sides alike: PSI's log blows up on an
    # empty bin, and the clamp must not bias p against q
    p = torch.clamp(p, min=_EPS)
    p = p / p.sum(1, keepdim=True)
    q = torch.clamp(torch.as_tensor(np.asarray(reference.props, np.float32), device=p.device), min=_EPS)
    q = q / q.sum(1, keepdim=True)
    psi = ((p - q) * torch.log(p / q)).sum(1)
    ks = (torch.cumsum(p, 1) - torch.cumsum(q, 1)).abs().amax(1)
    psi_h, ks_h = torch.stack([psi, ks]).tolist()
    return dict(zip(names, psi_h)), dict(zip(names, ks_h)), batch.total_actions


class DriftWatch:
    """A frozen reference and the check that scores windows against it.

    Build once per active model (:meth:`from_batch`); each :meth:`check`
    lands its statistics in the ``drift/*`` gauges, the run log and the
    flight recorder, and returns the :class:`DriftResult`.
    """

    def __init__(self, reference: DriftReference, config: Optional[DriftConfig] = None) -> None:
        self.reference = reference
        self.config = config if config is not None else DriftConfig()

    @classmethod
    def from_batch(
        cls,
        model: Any,
        batch: Any,
        config: Optional[DriftConfig] = None,
        *,
        model_version: Optional[str] = None,
    ) -> 'DriftWatch':
        """Build the reference from ``model``'s training batch and wrap it."""
        cfg = config if config is not None else DriftConfig()
        return cls(build_drift_reference(model, batch, cfg, model_version=model_version), cfg)

    @classmethod
    def from_manifest(
        cls,
        manifest: Dict[str, Any],
        config: Optional[DriftConfig] = None,
        *,
        model_version: Optional[str] = None,
    ) -> 'DriftWatch':
        """Rebuild the watch from a training manifest's ``drift_reference``
        block, exactly; ``model_version`` stamps the version it serves."""
        ref = (manifest or {}).get('drift_reference')
        if not ref:
            raise ValueError(
                'manifest carries no drift_reference block (fall back to from_batch)'
            )
        reference = DriftReference.from_dict(ref)
        if model_version is not None:
            reference = replace(reference, model_version=model_version)
        return cls(reference, config)

    def check(self, model: Any, batch: Any) -> DriftResult:
        """Score one traffic window and record it. Errors of the statistics
        propagate (a broken check must not read as no drift); telemetry
        never raises."""
        from .shadow import replay_probs

        cfg = self.config
        with span('learn/drift_check'):
            probs = replay_probs(model, batch) if cfg.include_predictions else None
            # the window gate reads the batch's host count of valid actions
            n_actions = batch.total_actions
            if n_actions < cfg.min_actions:
                result = DriftResult(
                    n_actions=n_actions,
                    reference_actions=self.reference.n_actions,
                    evaluated=False,
                    triggered=False,
                    reasons=[
                        f'window too small to score drift ({n_actions} < '
                        f'{cfg.min_actions} actions)'
                    ],
                )
                self._record(result)
                return result
            psi, ks, n_actions = drift_statistics(self.reference, batch, probs)
        max_psi_feature = max(psi, key=psi.get)
        max_ks_feature = max(ks, key=ks.get)
        reasons: List[str] = []
        if psi[max_psi_feature] > cfg.psi_trigger:
            reasons.append(
                f'{max_psi_feature}: PSI {psi[max_psi_feature]:.4f} > '
                f'trigger {cfg.psi_trigger:.4f}'
            )
        if cfg.ks_trigger is not None and ks[max_ks_feature] > cfg.ks_trigger:
            reasons.append(
                f'{max_ks_feature}: KS {ks[max_ks_feature]:.4f} > trigger {cfg.ks_trigger:.4f}'
            )
        result = DriftResult(
            psi=psi,
            ks=ks,
            max_psi=psi[max_psi_feature],
            max_psi_feature=max_psi_feature,
            max_ks=ks[max_ks_feature],
            max_ks_feature=max_ks_feature,
            n_actions=n_actions,
            reference_actions=self.reference.n_actions,
            evaluated=True,
            triggered=bool(reasons),
            reasons=reasons,
        )
        self._record(result)
        return result

    def _record(self, result: DriftResult) -> None:
        """Gauges, counters and the run-log and recorder events."""
        counter('drift/checks', unit='count').inc(1)
        if result.evaluated:
            psi_g = gauge('drift/psi', unit='value')
            ks_g = gauge('drift/ks', unit='value')
            for name, v in result.psi.items():
                psi_g.set(v, feature=name)
            for name, v in result.ks.items():
                ks_g.set(v, feature=name)
            gauge('drift/max_psi', unit='value').set(result.max_psi)
        if result.triggered:
            counter('drift/triggers', unit='count').inc(1)
        try:
            payload = result.to_dict()
            payload['model_version'] = self.reference.model_version
            RECORDER.record('drift_check', **payload)
            log = current_runlog()
            if log is not None:
                log.event('drift_check', **payload)
        except Exception:
            pass
