"""Shadow evaluation: replay captured traffic through a model.

Port of ``socceraction_tpu/learn/shadow.py``. The promotion gate judges a
candidate on recent real traffic, not on a held-out split: captured
``(frame, home_team_id)`` units (one-shot requests, per-match session
streams) are packed into one batch and rated by both the candidate and
the active model, and their calibration is compared on the outcomes those
sequences produced (the family's label kernel over the same batch).

Both models are rated by the same function of the same batch (each head's
reference representation, :func:`replay_probs`), so a truncation that a
captured window imposes on the label lookahead affects both alike. With a
fixed model and window, :func:`shadow_replay` repeats bitwise on the CPU;
the only draws are the seeded bootstrap's.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import TYPE_CHECKING, Any, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from ..core.batch import ActionBatch, _from_numpy, pack_actions
from ..device import DeviceLike, resolve_device
from ..obs import counter, span
from .calibration import CalibrationSummary, calibration_summary

if TYPE_CHECKING:  # pandas is imported inside pack_replay_batch only
    import pandas as pd

__all__ = ['ShadowResult', 'pack_replay_batch', 'replay_probs', 'shadow_replay']


def pack_replay_batch(
    frames: Sequence[Tuple['pd.DataFrame', Any]],
    *,
    max_actions: int,
    device: DeviceLike = None,
) -> ActionBatch:
    """Pack captured ``(frame, home_team_id)`` traffic into one batch on
    ``device`` (default ``cuda``).

    Each unit becomes its own game row (game ids renumbered by position:
    captures from different sources may reuse them), packed to
    ``max_actions`` like a live request; a frame longer than the window
    keeps its last ``max_actions`` rows. The units' host staging batches
    are concatenated, then moved to the device once.
    """
    if not frames:
        raise ValueError('no captured traffic to replay')
    dev = resolve_device(device)
    stagings: List[ActionBatch] = []
    for i, (frame, home_team_id) in enumerate(frames):
        if len(frame) == 0:
            continue
        if len(frame) > max_actions:
            frame = frame.iloc[-max_actions:]
        staging, _ = pack_actions(
            frame.assign(game_id=i), home_team_id=home_team_id, max_actions=max_actions,
            as_numpy=True,
        )
        stagings.append(staging)
    if not stagings:
        raise ValueError('captured traffic is empty')
    cols = {
        name: np.concatenate([getattr(s, name) for s in stagings])
        for name in stagings[0].fields()
    }
    return _from_numpy(cols, dev)


def replay_probs(model: Any, batch: Any) -> Dict[str, torch.Tensor]:
    """Each head's ``(G, A)`` probabilities of ``model`` on ``batch``, on
    the batch's device.

    The same path for every model compared: each head's reference
    representation over one shared batch (an MLP head the feature tensor,
    built only when some head reads it; a seq head the packed rows).
    Values on padding rows are garbage by contract; mask with
    ``batch.mask``.
    """
    from ..seq.classifier import SeqClassifier

    need_feats = any(not isinstance(m, SeqClassifier) for m in model._models.values())
    feats = model.compute_features_batch(batch) if need_feats else None
    return model._estimate_probabilities_batch(feats, batch=batch)


@dataclass(frozen=True)
class ShadowResult:
    """One model's replay over one traffic window."""

    #: per-head calibration (key: label column, 'scores' / 'concedes')
    summaries: Dict[str, CalibrationSummary]
    #: per-head probability tensors on the batch's device (padding rows
    #: included), kept so a replay can be held to another bitwise
    probs: Dict[str, torch.Tensor] = field(repr=False, default_factory=dict)
    n_frames: int = 0
    n_actions: int = 0

    def to_dict(self) -> Dict[str, Any]:
        """JSON-ready per-head summary block (reports embed this)."""
        return {
            'n_frames': self.n_frames,
            'n_actions': self.n_actions,
            'heads': {c: s.to_dict() for c, s in self.summaries.items()},
        }


def shadow_replay(
    model: Any,
    frames: Optional[Sequence[Tuple['pd.DataFrame', Any]]] = None,
    *,
    batch: Optional[Any] = None,
    max_actions: int = 1664,
    n_bins: int = 10,
    n_boot: int = 200,
    seed: int = 0,
    ci_level: float = 0.95,
) -> ShadowResult:
    """Replay a traffic window through ``model``: calibration per head.

    Give either ``frames`` (captured ``(frame, home_team_id)`` pairs,
    packed here on the model's device) or a packed ``batch`` on it (a
    loop packs once and replays the same batch through candidate and
    active). Labels come from the family's label kernel over the same
    batch; padding rows carry zero weight.
    """
    if (frames is None) == (batch is None):
        raise ValueError('give exactly one of frames= or batch=')
    if batch is None:
        batch = pack_replay_batch(frames, max_actions=max_actions, device=model.device)
    n_frames = batch.n_games
    n_actions = batch.total_actions
    with span('learn/shadow_replay', frames=n_frames, actions=n_actions):
        probs = replay_probs(model, batch)
        labels = dict(zip(('scores', 'concedes'), model.compute_labels_batch(batch)))
        weights = batch.mask.to(torch.float32)
        summaries = {
            col: calibration_summary(
                probs[col], labels[col], weights,
                n_bins=n_bins, n_boot=n_boot, seed=seed, ci_level=ci_level,
            )
            for col in probs
        }
    counter('learn/replayed_actions', unit='actions').inc(n_actions)
    return ShadowResult(summaries=summaries, probs=probs, n_frames=n_frames, n_actions=n_actions)
