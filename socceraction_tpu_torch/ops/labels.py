"""The VAEP labels on packed batches (port of ``socceraction_tpu/ops/labels.py``).

The reference builds ``nr_actions - 1`` forward-shifted copies of a game
and OR-reduces them. Here the same windowed OR is a sequence of per-game
edge-clamped gathers on the packed ``(G, A)`` batch: step ``i`` reads row
``min(j + i, n_actions - 1)``, each game's last valid row, so many games
share one tensor and keep the reference's per-game tail backfill.
"""

from __future__ import annotations

from typing import Tuple

import torch

from ..config import LABEL_LOOKAHEAD
from ..core.batch import ActionBatch
from ..spadl import config as spadlconfig

__all__ = ['scores_concedes', 'goal_from_shot']


def _goal_masks(
    type_id: torch.Tensor, result_id: torch.Tensor
) -> Tuple[torch.Tensor, torch.Tensor]:
    """``(goal, owngoal)`` bool masks: a shot-like action that succeeded,
    or that ended in an own goal."""
    shot_like = (
        (type_id == spadlconfig.SHOT)
        | (type_id == spadlconfig.SHOT_PENALTY)
        | (type_id == spadlconfig.SHOT_FREEKICK)
    )
    goal = shot_like & (result_id == spadlconfig.SUCCESS)
    owngoal = shot_like & (result_id == spadlconfig.OWNGOAL)
    return goal, owngoal


def scores_concedes(
    batch: ActionBatch, *, nr_actions: int = LABEL_LOOKAHEAD
) -> Tuple[torch.Tensor, torch.Tensor]:
    """The ``scores`` and ``concedes`` labels, bool ``(G, A)`` each.

    An action scores when its team scores (or the other team puts the
    ball in its own net) within the next ``nr_actions`` actions of the
    game, itself included; concedes is the mirror. Padding rows carry
    arbitrary values: mask them.
    """
    goal, owngoal = _goal_masks(batch.type_id, batch.result_id)
    team = batch.is_home
    n_cols = goal.shape[1]
    # (G, 1) per-game clamp; a game with no actions (padding) reads row 0
    last = (batch.n_actions.long() - 1).clamp(min=0)[:, None]
    cols = torch.arange(n_cols, device=goal.device)
    scores = goal
    concedes = owngoal
    for i in range(1, nr_actions):
        idx = torch.minimum(cols + i, last)  # (G, A)
        goal_i = torch.gather(goal, 1, idx)
        owngoal_i = torch.gather(owngoal, 1, idx)
        same = torch.gather(team, 1, idx) == team
        scores = scores | (goal_i & same) | (owngoal_i & ~same)
        concedes = concedes | (goal_i & ~same) | (owngoal_i & same)
    return scores, concedes


def goal_from_shot(batch: ActionBatch) -> torch.Tensor:
    """The xG label, bool ``(G, A)``: a goal was scored from the action."""
    goal, _ = _goal_masks(batch.type_id, batch.result_id)
    return goal
