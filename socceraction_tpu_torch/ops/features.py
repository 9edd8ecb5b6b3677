"""The VAEP game-state features on packed batches.

Port of ``socceraction_tpu/ops/features.py``: "game states" are
edge-clamped column gathers (``arr[:, max(j - i, 0)]``), one-hots are id
comparisons, the left-to-right mirror is a ``where`` on the current
action's home flag, and goalscore is a cumulative sum along the action
axis. Feature names and order match the JAX kernels block for block.
"""

from __future__ import annotations

from typing import Callable, Dict, List, Optional, Sequence, Tuple

import torch

from ..core.batch import ActionBatch
from ..spadl import config as spadlconfig
from .labels import _goal_masks

__all__ = ['compute_features', 'KERNELS', 'kernel_width']

_N_TYPES = len(spadlconfig.actiontypes)
_N_RESULTS = len(spadlconfig.results)
_N_BODYPARTS = len(spadlconfig.bodyparts)
_GOAL_X = spadlconfig.field_length
_GOAL_Y = spadlconfig.field_width / 2


def _shift_gather(arr: torch.Tensor, i: int) -> torch.Tensor:
    """State gather: row j sees row ``max(j - i, 0)`` (edge backfill)."""
    if i == 0:
        return arr
    idx = (torch.arange(arr.shape[1], device=arr.device) - i).clamp(min=0)
    return arr[:, idx]


class _States:
    """Per-state views of a batch, with the left-to-right mirror applied."""

    def __init__(self, batch: ActionBatch, k: int) -> None:
        self.k = k
        f = self.f = batch.time_seconds.dtype
        a0_home = self.a0_home = batch.is_home

        def ltr(x: torch.Tensor, extent: float) -> torch.Tensor:
            return torch.where(a0_home, x, extent - x)

        def states(a: torch.Tensor) -> List[torch.Tensor]:
            return [_shift_gather(a, i) for i in range(k)]

        L, W = spadlconfig.field_length, spadlconfig.field_width
        self.type_id = states(batch.type_id)
        self.result_id = states(batch.result_id)
        self.bodypart_id = states(batch.bodypart_id)
        self.period_id = [x.to(f) for x in states(batch.period_id)]
        self.time_seconds = [x.to(f) for x in states(batch.time_seconds)]
        self.is_home = states(batch.is_home)
        self.start_x = [ltr(x.to(f), L) for x in states(batch.start_x)]
        self.start_y = [ltr(x.to(f), W) for x in states(batch.start_y)]
        self.end_x = [ltr(x.to(f), L) for x in states(batch.end_x)]
        self.end_y = [ltr(x.to(f), W) for x in states(batch.end_y)]


def _stack(
    cols: Sequence[torch.Tensor], f: torch.dtype, like: Optional[torch.Tensor] = None
) -> torch.Tensor:
    """Stack ``(G, A)`` columns into a ``(G, A, F)`` block of dtype ``f``;
    an empty list gives a zero-width block shaped like ``like``."""
    if not cols:
        return torch.zeros((*like.shape, 0), dtype=f, device=like.device)
    return torch.stack([c.to(f) for c in cols], dim=-1)


def _one_hot(ids: torch.Tensor, n: int, f: torch.dtype) -> torch.Tensor:
    """``jax.nn.one_hot`` semantics: an id outside ``[0, n)`` is all zeros."""
    return (ids[..., None] == torch.arange(n, device=ids.device)).to(f)


# --- per-transformer blocks (names match the pandas transformers) ----------


def _actiontype(s: _States) -> torch.Tensor:
    return _stack(s.type_id, s.f)


def _actiontype_onehot(s: _States) -> torch.Tensor:
    return torch.cat([_one_hot(t, _N_TYPES, s.f) for t in s.type_id], dim=-1)


def _result(s: _States) -> torch.Tensor:
    return _stack(s.result_id, s.f)


def _result_onehot(s: _States) -> torch.Tensor:
    return torch.cat([_one_hot(r, _N_RESULTS, s.f) for r in s.result_id], dim=-1)


def _actiontype_result_onehot(s: _States) -> torch.Tensor:
    blocks = []
    for t, r in zip(s.type_id, s.result_id):
        ty = _one_hot(t, _N_TYPES, s.f)
        re = _one_hot(r, _N_RESULTS, s.f)
        # type-major flattening matches the reference's nested column loop
        blocks.append((ty[..., :, None] * re[..., None, :]).flatten(-2))
    return torch.cat(blocks, dim=-1)


def _bodypart(s: _States) -> torch.Tensor:
    return _stack(s.bodypart_id, s.f)


def _bodypart_onehot(s: _States) -> torch.Tensor:
    return torch.cat([_one_hot(b, _N_BODYPARTS, s.f) for b in s.bodypart_id], dim=-1)


def _time(s: _States) -> torch.Tensor:
    cols = []
    for period, t in zip(s.period_id, s.time_seconds):
        overall = (period - 1) * 45 * 60 + t
        cols += [period, t, overall]
    return _stack(cols, s.f)


def _startlocation(s: _States) -> torch.Tensor:
    cols = []
    for x, y in zip(s.start_x, s.start_y):
        cols += [x, y]
    return _stack(cols, s.f)


def _endlocation(s: _States) -> torch.Tensor:
    cols = []
    for x, y in zip(s.end_x, s.end_y):
        cols += [x, y]
    return _stack(cols, s.f)


def _polar(x: torch.Tensor, y: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    dx = (_GOAL_X - x).abs()
    dy = (_GOAL_Y - y).abs()
    # x*x, not x**2: jax lowers x**2 to one multiply, and so does this
    dist = torch.sqrt(dx * dx + dy * dy)
    angle = torch.nan_to_num(torch.atan(dy / dx))
    return dist, angle


def _startpolar(s: _States) -> torch.Tensor:
    cols = []
    for x, y in zip(s.start_x, s.start_y):
        cols += list(_polar(x, y))
    return _stack(cols, s.f)


def _endpolar(s: _States) -> torch.Tensor:
    cols = []
    for x, y in zip(s.end_x, s.end_y):
        cols += list(_polar(x, y))
    return _stack(cols, s.f)


def _movement(s: _States) -> torch.Tensor:
    cols = []
    for i in range(s.k):
        dx = s.end_x[i] - s.start_x[i]
        dy = s.end_y[i] - s.start_y[i]
        cols += [dx, dy, torch.sqrt(dx * dx + dy * dy)]
    return _stack(cols, s.f)


def _team(s: _States) -> torch.Tensor:
    return _stack(
        [s.is_home[i] == s.is_home[0] for i in range(1, s.k)], s.f, s.is_home[0]
    )


def _time_delta(s: _States) -> torch.Tensor:
    return _stack(
        [s.time_seconds[0] - s.time_seconds[i] for i in range(1, s.k)],
        s.f,
        s.is_home[0],
    )


def _space_delta(s: _States) -> torch.Tensor:
    cols = []
    for i in range(1, s.k):
        dx = s.end_x[i] - s.start_x[0]
        dy = s.end_y[i] - s.start_y[0]
        cols += [dx, dy, torch.sqrt(dx * dx + dy * dy)]
    return _stack(cols, s.f, s.is_home[0])


def _goalscore(s: _States) -> torch.Tensor:
    goals, owngoals = _goal_masks(s.type_id[0], s.result_id[0])
    # team "A" is the team of the game's first action (reference
    # features.py:521); games are left-aligned so that is column 0
    teamisA = s.is_home[0] == s.is_home[0][:, :1]
    goalsA = ((goals & teamisA) | (owngoals & ~teamisA)).to(s.f)
    goalsB = ((goals & ~teamisA) | (owngoals & teamisA)).to(s.f)
    scoreA = torch.cumsum(goalsA, dim=1) - goalsA
    scoreB = torch.cumsum(goalsB, dim=1) - goalsB
    team_score = torch.where(teamisA, scoreA, scoreB)
    opp_score = torch.where(teamisA, scoreB, scoreA)
    return _stack([team_score, opp_score, team_score - opp_score], s.f)


KERNELS: Dict[str, Callable[[_States], torch.Tensor]] = {
    'actiontype': _actiontype,
    'actiontype_onehot': _actiontype_onehot,
    'result': _result,
    'result_onehot': _result_onehot,
    'actiontype_result_onehot': _actiontype_result_onehot,
    'bodypart': _bodypart,
    'bodypart_onehot': _bodypart_onehot,
    'time': _time,
    'startlocation': _startlocation,
    'endlocation': _endlocation,
    'startpolar': _startpolar,
    'endpolar': _endpolar,
    'movement': _movement,
    'team': _team,
    'time_delta': _time_delta,
    'space_delta': _space_delta,
    'goalscore': _goalscore,
}

#: Columns each kernel emits, as ``(per state, per previous state, fixed)``
#: multipliers: ``width = a·k + b·(k - 1) + c``. Static, so a layout is
#: known without running a kernel.
_WIDTHS: Dict[str, Tuple[int, int, int]] = {
    'actiontype': (1, 0, 0),
    'actiontype_onehot': (_N_TYPES, 0, 0),
    'result': (1, 0, 0),
    'result_onehot': (_N_RESULTS, 0, 0),
    'actiontype_result_onehot': (_N_TYPES * _N_RESULTS, 0, 0),
    'bodypart': (1, 0, 0),
    'bodypart_onehot': (_N_BODYPARTS, 0, 0),
    'time': (3, 0, 0),
    'startlocation': (2, 0, 0),
    'endlocation': (2, 0, 0),
    'startpolar': (2, 0, 0),
    'endpolar': (2, 0, 0),
    'movement': (3, 0, 0),
    'team': (0, 1, 0),
    'time_delta': (0, 1, 0),
    'space_delta': (0, 3, 0),
    'goalscore': (0, 0, 3),
}


def kernel_width(
    name: str, k: int, widths: Optional[Dict[str, Tuple[int, int, int]]] = None
) -> int:
    """Number of feature columns kernel ``name`` emits at ``k`` states, by
    ``widths`` (default: the standard kernels' :data:`_WIDTHS`)."""
    a, b, c = (_WIDTHS if widths is None else widths)[name]
    return a * k + b * (k - 1) + c


def compute_features(
    batch: ActionBatch, *, names: Sequence[str], k: int
) -> torch.Tensor:
    """The concatenated ``(G, A, F)`` feature tensor of kernels ``names``."""
    s = _States(batch, k)
    return torch.cat([KERNELS[n](s) for n in names], dim=-1)
