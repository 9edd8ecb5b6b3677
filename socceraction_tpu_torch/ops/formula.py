"""The VAEP value formula (port of ``socceraction_tpu/ops/formula.py``).

Lag-1 selects with team continuity, the same-phase time cutoff, the
previous-goal reset and the fixed penalty/corner priors, as ``where``
algebra on the packed ``(G, A)`` batch. The lag clamps at each game's
first row, which is exact because games are left-aligned.
"""

from __future__ import annotations

import functools
from typing import Tuple

import torch

from ..config import CORNER_PRIOR, PENALTY_PRIOR, SAMEPHASE_SECONDS
from ..core.batch import ActionBatch
from ..obs.dispatch import instrument
from ..spadl import config as spadlconfig
from .labels import _goal_masks

__all__ = ['vaep_values', 'vaep_core']


def vaep_core(
    type_id: torch.Tensor,
    time_seconds: torch.Tensor,
    p_scores: torch.Tensor,
    p_concedes: torch.Tensor,
    *,
    type_prev: torch.Tensor,
    result_prev: torch.Tensor,
    sameteam: torch.Tensor,
    time_prev: torch.Tensor,
    p_scores_prev: torch.Tensor,
    p_concedes_prev: torch.Tensor,
) -> torch.Tensor:
    """The formula given explicit lag-1 views -> ``(..., 3)`` values."""
    toolong = (time_seconds - time_prev).abs() > SAMEPHASE_SECONDS
    prevgoal, _ = _goal_masks(type_prev, result_prev)
    reset = toolong | prevgoal

    prev_scores = torch.where(sameteam, p_scores_prev, p_concedes_prev)
    prev_scores = torch.where(reset, 0.0, prev_scores)
    is_penalty = type_id == spadlconfig.SHOT_PENALTY
    is_corner = (type_id == spadlconfig.CORNER_CROSSED) | (
        type_id == spadlconfig.CORNER_SHORT
    )
    prev_scores = torch.where(is_penalty, PENALTY_PRIOR, prev_scores)
    prev_scores = torch.where(is_corner, CORNER_PRIOR, prev_scores)

    prev_concedes = torch.where(sameteam, p_concedes_prev, p_scores_prev)
    prev_concedes = torch.where(reset, 0.0, prev_concedes)

    offensive = p_scores - prev_scores
    defensive = -(p_concedes - prev_concedes)
    return torch.stack([offensive, defensive, offensive + defensive], dim=-1)


def _values_cost(
    batch: ActionBatch, p_scores: torch.Tensor, p_concedes: torch.Tensor
) -> Tuple[float, float]:
    """``(flops, bytes)`` of the formula: the two probability planes and
    the four batch fields it reads (type, result, side, time) read once,
    the ``(G, A, 3)`` f32 values written once; about ten operations a
    row."""
    n = batch.n_games * batch.max_actions
    read = sum(
        t.element_size() * n
        for t in (p_scores, p_concedes, batch.type_id, batch.result_id, batch.is_home,
                  batch.time_seconds)
    )
    return float(10 * n), float(read + 12 * n)


@functools.partial(instrument, name='vaep_values', cost=_values_cost)
def vaep_values(
    batch: ActionBatch, p_scores: torch.Tensor, p_concedes: torch.Tensor
) -> torch.Tensor:
    """``(G, A, 3)``: offensive, defensive and total VAEP values
    (instrumented as ``vaep_values``)."""
    A = batch.max_actions
    prev = (torch.arange(A, device=batch.device) - 1).clamp(min=0)
    t = batch.time_seconds
    return vaep_core(
        batch.type_id,
        t,
        p_scores,
        p_concedes,
        type_prev=batch.type_id[:, prev],
        result_prev=batch.result_id[:, prev],
        sameteam=batch.is_home[:, prev] == batch.is_home,
        time_prev=t[:, prev],
        p_scores_prev=p_scores[:, prev],
        p_concedes_prev=p_concedes[:, prev],
    )
