"""Per-match streaming sessions: rate a live game in O(new actions) ticks.

Port of the JAX package's ``socceraction_tpu/serve/session.py``. A
:class:`MatchSession` accepts SPADL actions incrementally as the match is
played and rates only the new suffix per update. With
``nb_prev_actions = k``, an action's features read at most the ``k - 1``
actions before it, and the VAEP formula reads the previous action's
probabilities (whose features reach ``k`` actions back in total). So a
window of ``k`` context actions plus the new suffix reproduces the
full-game computation for every new row — except for one feature:

**goalscore** is a whole-match prefix sum (goals scored so far, anchored
to the team of the match's FIRST action), which a suffix window cannot
know. The session therefore carries the running score on the host — a
handful of integers — and injects the exact ``(team_score, opp_score,
diff)`` block for the window's rows via ``rate_batch``'s
``dense_overrides``. The injected values are small integer counts,
exactly representable in f32.

Each update packs its window with the owning service's fixed
``max_actions`` and submits it through the service's micro-batcher, so
concurrent live matches coalesce into the same bucketed device batches
as one-shot rating requests. :func:`score_prefix` and
:func:`goalscore_block` are numpy only; pandas is imported inside the
functions that take frames.
"""

from __future__ import annotations

from typing import Any, List, Optional

from typing import TYPE_CHECKING

import numpy as np

from ..core.batch import pack_actions
from ..spadl import config as spadlconfig

if TYPE_CHECKING:  # pandas is imported inside the functions that take frames
    import pandas as pd

__all__ = ['MatchSession']

#: Feature kernels whose value at action ``i`` depends only on actions
#: ``i-k+1 .. i`` (the game-state window) — safe to evaluate on a suffix
#: window as-is. Everything standard except ``goalscore``.
WINDOW_LOCAL_KERNELS = frozenset(
    {
        'actiontype', 'actiontype_onehot', 'result', 'result_onehot',
        'actiontype_result_onehot', 'bodypart', 'bodypart_onehot', 'time',
        'startlocation', 'endlocation', 'startpolar', 'endpolar', 'movement',
        'team', 'time_delta', 'space_delta',
    }
)

_GS_COLS = ('_gs_team', '_gs_opp')


def _goal_flags(
    type_id: np.ndarray, result_id: np.ndarray
) -> tuple[np.ndarray, np.ndarray]:
    """Host mirror of ``ops.labels._goal_masks`` (goal, owngoal) per row."""
    shot_like = (
        (type_id == spadlconfig.SHOT)
        | (type_id == spadlconfig.SHOT_PENALTY)
        | (type_id == spadlconfig.SHOT_FREEKICK)
    )
    return (
        shot_like & (result_id == spadlconfig.SUCCESS),
        shot_like & (result_id == spadlconfig.OWNGOAL),
    )


def score_prefix(
    type_id: np.ndarray,
    result_id: np.ndarray,
    team_is_a: np.ndarray,
    carry_a: int = 0,
    carry_b: int = 0,
) -> Any:
    """Per-row ``(team_score, opp_score)`` BEFORE each action, plus the
    advanced ``(carry_a, carry_b)`` totals.

    The ONE host mirror of ``ops.features._goalscore``'s exclusive prefix
    sums — shared by the session's running carry and the service's
    whole-frame block, so the two cannot drift. Pure: callers commit the
    returned carries when (and only when) the rating succeeds.
    """
    goal, owngoal = _goal_flags(type_id, result_id)
    goals_a = ((goal & team_is_a) | (owngoal & ~team_is_a)).astype(np.int64)
    goals_b = ((goal & ~team_is_a) | (owngoal & team_is_a)).astype(np.int64)
    before_a = carry_a + np.cumsum(goals_a) - goals_a
    before_b = carry_b + np.cumsum(goals_b) - goals_b
    team = np.where(team_is_a, before_a, before_b).astype(np.float32)
    opp = np.where(team_is_a, before_b, before_a).astype(np.float32)
    return team, opp, carry_a + int(goals_a.sum()), carry_b + int(goals_b.sum())


def goalscore_block(
    team: np.ndarray, opp: np.ndarray, max_actions: int
) -> np.ndarray:
    """Assemble the ``(1, A, 3)`` dense-override block (zeros on padding)."""
    gs = np.zeros((1, max_actions, 3), dtype=np.float32)
    n = len(team)
    gs[0, :n, 0] = team
    gs[0, :n, 1] = opp
    gs[0, :n, 2] = team - opp
    return gs


class MatchSession:
    """One live match's incremental rating state.

    Create via :meth:`socceraction_tpu_torch.serve.service.RatingService.open_session`.

    Parameters
    ----------
    service
        The owning :class:`~socceraction_tpu_torch.serve.service.RatingService`;
        window requests go through its micro-batcher.
    match_id
        Identifier used as the packed frame's ``game_id``.
    home_team_id
        The match's home side (SPADL team orientation).
    """

    def __init__(self, service: Any, match_id: Any, home_team_id: Any) -> None:
        self._service = service
        self.match_id = match_id
        self.home_team_id = home_team_id
        self.k = int(service.nb_prev_actions)
        #: last <= k actions (with their stored goalscore rows) — the
        #: game-state ring buffer the next window's context comes from
        self._tail: Optional['pd.DataFrame'] = None
        # running whole-match score state (goalscore's global carry)
        self._team_a_is_home: Optional[bool] = None
        self._score_a = 0
        self._score_b = 0
        self.n_actions = 0
        self._chunks: List['pd.DataFrame'] = []

    # -- the per-tick update ----------------------------------------------

    def add_actions(
        self, actions: 'pd.DataFrame', *, timeout: Optional[float] = None
    ) -> 'pd.DataFrame':
        """Rate the next slice of the match; returns the new rows' values.

        ``actions`` are the match's newest SPADL rows, in order,
        continuing from everything previously added. The update cost is
        O(len(actions)): a window of ``k`` buffered context actions plus
        the new rows is packed, rated through the service's shared
        micro-batcher, and only the new rows' ratings are kept.

        Returns a DataFrame with ``offensive_value`` / ``defensive_value``
        / ``vaep_value`` columns aligned to ``actions``' index.
        """
        import pandas as pd

        if len(actions) == 0:
            return pd.DataFrame(
                columns=['offensive_value', 'defensive_value', 'vaep_value']
            )
        # An oversized tick splits into window-sized parts, but ALL state
        # (goalscore carry, ring buffer, totals) commits exactly once,
        # after every part's future has resolved — a failure anywhere in
        # the tick leaves the session untouched, so the documented
        # retry-the-same-tick contract holds for ticks of any size. The
        # sub-windows depend only on the actions (never on each other's
        # ratings), so they are all submitted before the first wait and
        # coalesce into the same flushes.
        max_rows = self._service.max_actions - self.k
        gs_enabled = getattr(self._service, '_gs_enabled', True)
        tail = self._tail
        team_a = self._team_a_is_home
        score_a, score_b = self._score_a, self._score_b
        pending: List[Any] = []
        for i in range(0, len(actions), max_rows):
            part = actions.iloc[i : i + max_rows]
            if gs_enabled:
                is_home = part['team_id'].to_numpy() == self.home_team_id
                if team_a is None:
                    team_a = bool(is_home[0])
                team, opp, score_a, score_b = score_prefix(
                    part['type_id'].to_numpy(dtype=np.int64),
                    part['result_id'].to_numpy(dtype=np.int64),
                    is_home == team_a,
                    score_a,
                    score_b,
                )
                new = part.copy()
                new[_GS_COLS[0]] = team
                new[_GS_COLS[1]] = opp
            else:  # the model has no goalscore kernel: no carry to keep
                new = part
            context = 0 if tail is None else len(tail)
            window = new if context == 0 else pd.concat([tail, new])
            future = self._service._submit_window(
                window, context, len(new),
                match_id=self.match_id, home_team_id=self.home_team_id,
            )
            pending.append((future, part.index))
            tail = window.iloc[-self.k :]
        parts = [
            pd.DataFrame(
                future.result(timeout=timeout),
                columns=['offensive_value', 'defensive_value', 'vaep_value'],
                index=index,
            )
            for future, index in pending
        ]

        # commit ONLY on success: an Overloaded/timeout/flush failure
        # leaves the session exactly where it was, so the caller can
        # retry the same tick without corrupting the goalscore carry
        self._team_a_is_home = team_a
        self._score_a, self._score_b = score_a, score_b
        self._tail = tail
        self.n_actions += len(actions)
        # commit-time capture: a retried tick records its rows exactly
        # once, and the captured stream is the match as actually rated
        capture = getattr(self._service, 'capture', None)
        if capture is not None:
            capture.record_session(self.match_id, actions, self.home_team_id)
        out = parts[0] if len(parts) == 1 else pd.concat(parts)
        self._chunks.append(out)
        return out

    def ratings(self) -> 'pd.DataFrame':
        """All ratings produced so far, in arrival order."""
        import pandas as pd

        if not self._chunks:
            return pd.DataFrame(
                columns=['offensive_value', 'defensive_value', 'vaep_value']
            )
        return pd.concat(self._chunks)


def pack_window(
    window: 'pd.DataFrame', match_id: Any, home_team_id: Any, max_actions: int
) -> Any:
    """Pack one session window into a host staging batch + goalscore block.

    Returns ``(staging ActionBatch (1, A) numpy fields, gs (1, A, 3) f32)``
    where the goalscore block carries the stored whole-match
    ``(team_score, opp_score, diff)`` rows for the window's actions and
    zeros on padding — or ``gs = None`` when the window carries no score
    columns (the serving model has no ``goalscore`` kernel).
    """
    frame = window.drop(columns=list(_GS_COLS), errors='ignore')
    if 'game_id' not in frame.columns:
        frame = frame.assign(game_id=match_id)
    staging, _ids = pack_actions(
        frame, home_team_id=home_team_id, max_actions=max_actions,
        as_numpy=True,
    )
    if _GS_COLS[0] not in window.columns:
        return staging, None
    gs = goalscore_block(
        window[_GS_COLS[0]].to_numpy(dtype=np.float32),
        window[_GS_COLS[1]].to_numpy(dtype=np.float32),
        max_actions,
    )
    return staging, gs
