"""Goal predicates of the VAEP labels (port of ``socceraction_tpu/ops/labels.py``).

Only :func:`_goal_masks` is ported so far: the ``goalscore`` feature and
the value formula use it. ``scores_concedes`` comes with training.
"""

from __future__ import annotations

from typing import Tuple

import torch

from ..spadl import config as spadlconfig


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
