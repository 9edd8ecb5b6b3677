"""Expected Threat (xT) over raw Wyscout-v3 event frames.

Port of ``socceraction_tpu/xthreat_v3.py`` (reference
``socceraction/xthreat_v3.py``): xT on flat-column Wyscout v3 frames
(``type_primary`` strings, ``shot_is_goal``, 0/1 ``result``) with the move
set widened from {pass, dribble, cross} to {pass, carry, cross,
acceleration, dribble, take_on} (reference ``xthreat_v3.py:111-118``).
The JAX package implements the reference's intended semantics
(underscore columns throughout, success = ``result == 1``), and so does
this module.

The algorithm is :mod:`socceraction_tpu_torch.xthreat`'s: a v3 frame is
*encoded* into the SPADL id space (every move-set primary to a move type
id, shots with ``shot_is_goal`` to successful shots) and handed to it, on
either backend. pandas is imported inside the functions.
"""

from __future__ import annotations

from typing import TYPE_CHECKING, Tuple

import numpy as np

from . import xthreat as _xt
from .device import DeviceLike
from .spadl import config as spadlconfig

if TYPE_CHECKING:
    import pandas as pd

__all__ = [
    'MOVE_PRIMARIES',
    'ExpectedThreat',
    'ExpectedThreatV3',
    'encode_v3_actions',
    'get_move_actions',
    'get_successful_move_actions',
    'scoring_prob',
    'action_prob',
    'move_transition_matrix',
    'load_model',
]

M: int = _xt.M
N: int = _xt.N

#: The widened ball-progressing action set (reference xthreat_v3.py:111-118).
MOVE_PRIMARIES: Tuple[str, ...] = (
    'pass', 'carry', 'cross', 'acceleration', 'dribble', 'take_on',
)


def encode_v3_actions(events: 'pd.DataFrame') -> 'pd.DataFrame':
    """Encode a Wyscout-v3 frame into the SPADL id space for the xT engine.

    - ``type_primary`` in :data:`MOVE_PRIMARIES` becomes the SPADL
      ``pass`` id (the engine only tests membership in its move set),
      ``'shot'`` the SPADL ``shot`` id, anything else ``non_action``;
    - ``result_id`` is success for moves with ``result == 1`` and for
      shots with ``shot_is_goal == 1`` (``result`` when that column is
      absent), else fail.

    Needs ``start_x/start_y/end_x/end_y`` in meters.
    """
    import pandas as pd

    primary = events['type_primary'].astype(str)
    is_move = primary.isin(MOVE_PRIMARIES)
    is_shot = primary == 'shot'
    type_id = np.where(
        is_move, spadlconfig.PASS, np.where(is_shot, spadlconfig.SHOT, spadlconfig.NON_ACTION)
    )
    result = pd.to_numeric(
        events.get('result', pd.Series(np.nan, index=events.index)), errors='coerce'
    )
    if 'shot_is_goal' in events.columns:
        goal = pd.to_numeric(events['shot_is_goal'], errors='coerce') == 1
    else:
        goal = result == 1
    success = np.where(is_shot, goal, result == 1)
    encoded = pd.DataFrame(
        {
            'type_id': type_id.astype(np.int64),
            'result_id': np.where(success, spadlconfig.SUCCESS, spadlconfig.FAIL).astype(np.int64),
            'start_x': events['start_x'].astype(float),
            'start_y': events['start_y'].astype(float),
            'end_x': events['end_x'].astype(float),
            'end_y': events['end_y'].astype(float),
        },
        index=events.index,
    )
    for passthrough in ('game_id', 'team_id', 'period_id', 'time_seconds'):
        if passthrough in events.columns:
            encoded[passthrough] = events[passthrough]
    return encoded


def get_move_actions(events: 'pd.DataFrame') -> 'pd.DataFrame':
    """All ball-progressing v3 events (the widened move set)."""
    return events[events['type_primary'].astype(str).isin(MOVE_PRIMARIES)]


def get_successful_move_actions(events: 'pd.DataFrame') -> 'pd.DataFrame':
    """All successful ball-progressing v3 events (``result == 1``)."""
    import pandas as pd

    moves = get_move_actions(events)
    return moves[pd.to_numeric(moves['result'], errors='coerce') == 1]


def scoring_prob(events: 'pd.DataFrame', l: int = N, w: int = M) -> np.ndarray:
    """P(goal | shot from cell) from v3 ``shot``/``shot_is_goal`` columns."""
    return _xt.scoring_prob(encode_v3_actions(events), l, w)


def action_prob(
    events: 'pd.DataFrame', l: int = N, w: int = M
) -> Tuple[np.ndarray, np.ndarray]:
    """P(choose shot) and P(choose move) per cell, widened move set."""
    return _xt.action_prob(encode_v3_actions(events), l, w)


def move_transition_matrix(events: 'pd.DataFrame', l: int = N, w: int = M) -> np.ndarray:
    """Successful-move transition matrix over the widened move set."""
    return _xt.move_transition_matrix(encode_v3_actions(events), l, w)


class ExpectedThreatV3(_xt.ExpectedThreat):
    """xT fitted on raw Wyscout-v3 event frames.

    The engine, grid, solvers, backends and device of
    :class:`socceraction_tpu_torch.xthreat.ExpectedThreat`; its inputs are
    v3 frames, encoded on entry to ``fit`` and ``rate``.
    """

    def fit(self, events: 'pd.DataFrame') -> 'ExpectedThreatV3':
        """Fit on a v3 event frame (metered coordinates)."""
        super().fit(encode_v3_actions(events))
        return self

    def rate(
        self, events: 'pd.DataFrame', use_interpolation: bool = False
    ) -> np.ndarray:
        """Rate successful widened-set move events; NaN elsewhere."""
        return super().rate(encode_v3_actions(events), use_interpolation)


#: The reference's name: its ``xthreat_v3.py`` exports the class as
#: ``ExpectedThreat``.
ExpectedThreat = ExpectedThreatV3


def load_model(path: str, backend: str = 'torch', device: DeviceLike = None) -> ExpectedThreatV3:
    """A v3 model from a saved xT value surface (JSON 2-D matrix)."""
    base = _xt.load_model(path, backend=backend, device=device)
    model = ExpectedThreatV3(backend=base.backend, device=base.device)
    model.xT = base.xT
    model.w, model.l = base.w, base.l
    return model
