"""The VAEP value formula (the pandas oracle).

Port of ``socceraction_tpu/vaep/formula.py`` (reference
``socceraction/vaep/formula.py``: ``offensive_value:17``,
``defensive_value:71``, ``value:116``), the pandas twin of
:func:`socceraction_tpu_torch.ops.formula.vaep_values`: the 10-second
same-phase cutoff, the goal reset and the fixed penalty and corner priors.
"""

from __future__ import annotations

from typing import TYPE_CHECKING, Tuple

import numpy as np

from ..config import CORNER_PRIOR, PENALTY_PRIOR, SAMEPHASE_SECONDS

if TYPE_CHECKING:
    import pandas as pd

_samephase_nb: float = SAMEPHASE_SECONDS

_shotlike_names = ('shot', 'shot_freekick', 'shot_penalty')
_corner_names = ('corner_crossed', 'corner_short')


def _prev_idx(n: int) -> np.ndarray:
    return np.maximum(np.arange(n) - 1, 0)


def _common(
    actions: 'pd.DataFrame', scores: 'pd.Series', concedes: 'pd.Series'
) -> Tuple[np.ndarray, np.ndarray, np.ndarray, np.ndarray, np.ndarray]:
    n = len(actions)
    p = _prev_idx(n)
    team = actions['team_id'].to_numpy()
    sameteam = team[p] == team
    prev_scores = np.asarray(scores, dtype=float)[p]
    prev_concedes = np.asarray(concedes, dtype=float)[p]

    t = actions['time_seconds'].to_numpy(dtype=float)
    toolong = np.abs(t - t[p]) > _samephase_nb

    type_name = actions['type_name'].to_numpy()
    result_name = actions['result_name'].to_numpy()
    prevgoal = np.isin(type_name[p], _shotlike_names) & (result_name[p] == 'success')
    return sameteam, prev_scores, prev_concedes, toolong, prevgoal


def offensive_value(
    actions: 'pd.DataFrame', scores: 'pd.Series', concedes: 'pd.Series'
) -> 'pd.Series':
    """Change in scoring probability produced by each action.

    The pre-action scoring probability is the previous state's scoring
    probability for the acting team (its *conceding* probability if
    possession changed hands), zeroed when more than 10 s elapsed or the
    previous action was a goal, and replaced by fixed priors for penalties
    and corners.
    """
    import pandas as pd

    sameteam, prev_scores_raw, prev_concedes_raw, toolong, prevgoal = _common(
        actions, scores, concedes
    )
    prev_scores = prev_scores_raw * sameteam + prev_concedes_raw * (~sameteam)
    prev_scores[toolong] = 0
    prev_scores[prevgoal] = 0

    type_name = actions['type_name'].to_numpy()
    prev_scores[type_name == 'shot_penalty'] = PENALTY_PRIOR
    prev_scores[np.isin(type_name, _corner_names)] = CORNER_PRIOR

    return pd.Series(np.asarray(scores, dtype=float) - prev_scores, index=actions.index)


def defensive_value(
    actions: 'pd.DataFrame', scores: 'pd.Series', concedes: 'pd.Series'
) -> 'pd.Series':
    """Change in conceding probability produced by each action (negated)."""
    import pandas as pd

    sameteam, prev_scores_raw, prev_concedes_raw, toolong, prevgoal = _common(
        actions, scores, concedes
    )
    prev_concedes = prev_concedes_raw * sameteam + prev_scores_raw * (~sameteam)
    prev_concedes[toolong] = 0
    prev_concedes[prevgoal] = 0

    return pd.Series(-(np.asarray(concedes, dtype=float) - prev_concedes), index=actions.index)


def value(actions: 'pd.DataFrame', Pscores: 'pd.Series', Pconcedes: 'pd.Series') -> 'pd.DataFrame':
    """Offensive, defensive and total VAEP value of each action."""
    import pandas as pd

    v = pd.DataFrame(index=actions.index)
    v['offensive_value'] = offensive_value(actions, Pscores, Pconcedes)
    v['defensive_value'] = defensive_value(actions, Pscores, Pconcedes)
    v['vaep_value'] = v['offensive_value'] + v['defensive_value']
    return v
