"""Atomic-VAEP features, labels and formula on packed batches.

Port of ``socceraction_tpu/ops/atomic.py``: the counterparts of
:mod:`.features`, :mod:`.labels` and :mod:`.formula` for an
:class:`~socceraction_tpu_torch.core.batch.AtomicActionBatch`. Game
states are the same edge-clamped gathers, and the left-to-right mirror
flips ``x, y`` about the pitch and negates ``dx, dy``.

The vocabulary's quirk (:mod:`~socceraction_tpu_torch.atomic.spadl.config`):
the name ``'interception'`` owns ids 10 and 24, so its one-hot column is
the OR of both and the one-hot block is 32 columns wide, the reference's
column set.
"""

from __future__ import annotations

from typing import Callable, Dict, List, Sequence, Tuple

import torch

from ..atomic.spadl import config as atomicconfig
from ..config import LABEL_LOOKAHEAD
from ..core.batch import AtomicActionBatch
from .features import _shift_gather, _stack

__all__ = [
    'ATOMIC_KERNELS',
    'ATOMIC_WIDTHS',
    'compute_features',
    'scores_concedes',
    'vaep_core',
    'vaep_values',
]

_N_BODYPARTS = len(atomicconfig.bodyparts)
_GOAL_X = atomicconfig.field_length
_GOAL_Y = atomicconfig.field_width / 2

#: Unique ``(name, ids)`` groups in first-occurrence order: 32 one-hot columns.
_ONEHOT_GROUPS: Tuple[Tuple[str, Tuple[int, ...]], ...] = tuple(
    (name, tuple(i for i, t in enumerate(atomicconfig.actiontypes) if t == name))
    for name in dict.fromkeys(atomicconfig.actiontypes)
)
#: Each type id's one-hot group, its index in :data:`_ONEHOT_GROUPS` (both
#: 'interception' ids share one).
GROUP_OF_TYPE: Tuple[int, ...] = tuple(
    next(g for g, (_, ids) in enumerate(_ONEHOT_GROUPS) if t in ids)
    for t in range(len(atomicconfig.actiontypes))
)


class _AtomicStates:
    """Per-state views of an atomic batch, with the left-to-right mirror
    applied."""

    def __init__(self, batch: AtomicActionBatch, k: int) -> None:
        self.k = k
        f = self.f = batch.time_seconds.dtype
        a0_home = self.a0_home = batch.is_home

        def states(a: torch.Tensor) -> List[torch.Tensor]:
            return [_shift_gather(a, i) for i in range(k)]

        L, W = atomicconfig.field_length, atomicconfig.field_width
        self.type_id = states(batch.type_id)
        self.bodypart_id = states(batch.bodypart_id)
        self.period_id = [v.to(f) for v in states(batch.period_id)]
        self.time_seconds = [v.to(f) for v in states(batch.time_seconds)]
        self.is_home = states(batch.is_home)
        self.x = [torch.where(a0_home, v.to(f), L - v.to(f)) for v in states(batch.x)]
        self.y = [torch.where(a0_home, v.to(f), W - v.to(f)) for v in states(batch.y)]
        self.dx = [torch.where(a0_home, v.to(f), -v.to(f)) for v in states(batch.dx)]
        self.dy = [torch.where(a0_home, v.to(f), -v.to(f)) for v in states(batch.dy)]


# --- per-transformer blocks (names match the pandas transformers) ----------


def _actiontype(s: _AtomicStates) -> torch.Tensor:
    return _stack(s.type_id, s.f)


def _actiontype_onehot(s: _AtomicStates) -> torch.Tensor:
    cols = []
    for t in s.type_id:
        for _, ids in _ONEHOT_GROUPS:
            col = t == ids[0]
            for other in ids[1:]:
                col = col | (t == other)
            cols.append(col)
    return _stack(cols, s.f)


def _bodypart(s: _AtomicStates) -> torch.Tensor:
    return _stack(s.bodypart_id, s.f)


def _bodypart_onehot(s: _AtomicStates) -> torch.Tensor:
    rows = torch.arange(_N_BODYPARTS, device=s.a0_home.device)
    return torch.cat([(b[..., None] == rows).to(s.f) for b in s.bodypart_id], dim=-1)


def _time(s: _AtomicStates) -> torch.Tensor:
    cols = []
    for period, t in zip(s.period_id, s.time_seconds):
        cols += [period, t, (period - 1) * 45 * 60 + t]
    return _stack(cols, s.f)


def _team(s: _AtomicStates) -> torch.Tensor:
    return _stack([s.is_home[i] == s.is_home[0] for i in range(1, s.k)], s.f, s.is_home[0])


def _time_delta(s: _AtomicStates) -> torch.Tensor:
    return _stack(
        [s.time_seconds[0] - s.time_seconds[i] for i in range(1, s.k)], s.f, s.is_home[0]
    )


def _location(s: _AtomicStates) -> torch.Tensor:
    cols = []
    for x, y in zip(s.x, s.y):
        cols += [x, y]
    return _stack(cols, s.f)


def _polar(s: _AtomicStates) -> torch.Tensor:
    cols = []
    for x, y in zip(s.x, s.y):
        dx = (_GOAL_X - x).abs()
        dy = (_GOAL_Y - y).abs()
        # x*x, not x**2: jax lowers x**2 to one multiply, and so does this
        cols.append(torch.sqrt(dx * dx + dy * dy))
        # dx = 0 gives ±π/2, 0/0 gives 0
        cols.append(torch.nan_to_num(torch.atan(dy / dx)))
    return _stack(cols, s.f)


def _movement_polar(s: _AtomicStates) -> torch.Tensor:
    cols = []
    for dx, dy in zip(s.dx, s.dy):
        cols.append(torch.sqrt(dx * dx + dy * dy))
        cols.append(torch.where(dy == 0, 0.0, torch.atan2(dy, dx)))
    return _stack(cols, s.f)


def _direction(s: _AtomicStates) -> torch.Tensor:
    cols = []
    for dx, dy in zip(s.dx, s.dy):
        total = torch.sqrt(dx * dx + dy * dy)
        moved = total > 0
        safe = torch.where(moved, total, 1.0)
        cols.append(torch.where(moved, dx / safe, dx))
        cols.append(torch.where(moved, dy / safe, dy))
    return _stack(cols, s.f)


def _goalscore(s: _AtomicStates) -> torch.Tensor:
    goals, owngoals = _goal_masks(s.type_id[0])
    # team "A" is the team of the game's first action; games are
    # left-aligned so that is column 0
    teamisA = s.is_home[0] == s.is_home[0][:, :1]
    goalsA = ((goals & teamisA) | (owngoals & ~teamisA)).to(s.f)
    goalsB = ((goals & ~teamisA) | (owngoals & teamisA)).to(s.f)
    scoreA = torch.cumsum(goalsA, dim=1) - goalsA
    scoreB = torch.cumsum(goalsB, dim=1) - goalsB
    team_score = torch.where(teamisA, scoreA, scoreB)
    opp_score = torch.where(teamisA, scoreB, scoreA)
    return _stack([team_score, opp_score, team_score - opp_score], s.f)


ATOMIC_KERNELS: Dict[str, Callable[[_AtomicStates], torch.Tensor]] = {
    'actiontype': _actiontype,
    'actiontype_onehot': _actiontype_onehot,
    'bodypart': _bodypart,
    'bodypart_onehot': _bodypart_onehot,
    'time': _time,
    'team': _team,
    'time_delta': _time_delta,
    'location': _location,
    'polar': _polar,
    'movement_polar': _movement_polar,
    'direction': _direction,
    'goalscore': _goalscore,
}

#: Columns each kernel emits, as ``(per state, per previous state, fixed)``
#: multipliers (see :data:`.features._WIDTHS`).
ATOMIC_WIDTHS: Dict[str, Tuple[int, int, int]] = {
    'actiontype': (1, 0, 0),
    'actiontype_onehot': (len(_ONEHOT_GROUPS), 0, 0),
    'bodypart': (1, 0, 0),
    'bodypart_onehot': (_N_BODYPARTS, 0, 0),
    'time': (3, 0, 0),
    'team': (0, 1, 0),
    'time_delta': (0, 1, 0),
    'location': (2, 0, 0),
    'polar': (2, 0, 0),
    'movement_polar': (2, 0, 0),
    'direction': (2, 0, 0),
    'goalscore': (0, 0, 3),
}


def compute_features(
    batch: AtomicActionBatch, *, names: Sequence[str], k: int
) -> torch.Tensor:
    """The concatenated ``(G, A, F)`` atomic feature tensor of kernels ``names``."""
    s = _AtomicStates(batch, k)
    return torch.cat([ATOMIC_KERNELS[n](s) for n in names], dim=-1)


def _goal_masks(type_id: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """``(goal, owngoal)`` bool masks: in Atomic-SPADL both are action types."""
    return type_id == atomicconfig.GOAL, type_id == atomicconfig.OWNGOAL


def scores_concedes(
    batch: AtomicActionBatch, *, nr_actions: int = LABEL_LOOKAHEAD
) -> Tuple[torch.Tensor, torch.Tensor]:
    """The atomic ``scores`` and ``concedes`` labels, bool ``(G, A)`` each.

    The windowed OR of :func:`.labels.scores_concedes`, with the lookahead
    clamped at each game's last valid row so padding never leaks in.
    Padding rows carry arbitrary values: mask them.
    """
    goal, owngoal = _goal_masks(batch.type_id)
    team = batch.is_home
    # (G, 1) per-game clamp; a game with no actions (padding) reads row 0
    last = (batch.n_actions.long() - 1).clamp(min=0)[:, None]
    cols = torch.arange(goal.shape[1], device=goal.device)
    scores = goal
    concedes = owngoal
    for i in range(1, nr_actions):
        idx = torch.minimum(cols + i, last)
        goal_i = torch.gather(goal, 1, idx)
        owngoal_i = torch.gather(owngoal, 1, idx)
        same = torch.gather(team, 1, idx) == team
        scores = scores | (goal_i & same) | (owngoal_i & ~same)
        concedes = concedes | (goal_i & ~same) | (owngoal_i & same)
    return scores, concedes


def vaep_core(
    p_scores: torch.Tensor,
    p_concedes: torch.Tensor,
    *,
    type_prev: torch.Tensor,
    sameteam: torch.Tensor,
    p_scores_prev: torch.Tensor,
    p_concedes_prev: torch.Tensor,
) -> torch.Tensor:
    """The atomic formula given explicit lag-1 views -> ``(..., 3)`` values:
    a previous goal or own goal resets, and there is no phase cutoff and
    no prior."""
    goal_prev, owngoal_prev = _goal_masks(type_prev)
    prevgoal = goal_prev | owngoal_prev
    prev_scores = torch.where(sameteam, p_scores_prev, p_concedes_prev)
    prev_scores = torch.where(prevgoal, 0.0, prev_scores)
    prev_concedes = torch.where(sameteam, p_concedes_prev, p_scores_prev)
    prev_concedes = torch.where(prevgoal, 0.0, prev_concedes)
    offensive = p_scores - prev_scores
    defensive = -(p_concedes - prev_concedes)
    return torch.stack([offensive, defensive, offensive + defensive], dim=-1)


def vaep_values(
    batch: AtomicActionBatch, p_scores: torch.Tensor, p_concedes: torch.Tensor
) -> torch.Tensor:
    """``(G, A, 3)``: offensive, defensive and total atomic VAEP values.
    The lag clamps at each game's first row (index ``max(a - 1, 0)``)."""
    prev = (torch.arange(batch.max_actions, device=batch.device) - 1).clamp(min=0)
    return vaep_core(
        p_scores,
        p_concedes,
        type_prev=batch.type_id[:, prev],
        sameteam=batch.is_home[:, prev] == batch.is_home,
        p_scores_prev=p_scores[:, prev],
        p_concedes_prev=p_concedes[:, prev],
    )
