"""Value formula of the Atomic-VAEP framework (the pandas oracle).

Port of ``socceraction_tpu/atomic/vaep/formula.py`` (reference
``socceraction/atomic/vaep/formula.py``). Unlike the VAEP formula it has
no 10-second same-phase cutoff and no penalty or corner priors (the
reference comments both out), and the previous-goal reset keys on the
``goal``/``owngoal`` action *types*.
"""

from __future__ import annotations

from typing import TYPE_CHECKING

if TYPE_CHECKING:
    import pandas as pd


def _prev(x: 'pd.Series') -> 'pd.Series':
    prev_x = x.shift(1)
    prev_x.iloc[:1] = x.values[0]
    return prev_x


def offensive_value(
    actions: 'pd.DataFrame', scores: 'pd.Series', concedes: 'pd.Series'
) -> 'pd.Series':
    """Change in scoring probability produced by each action."""
    sameteam = _prev(actions['team_id']) == actions['team_id']
    prev_scores = _prev(scores) * sameteam + _prev(concedes) * (~sameteam)
    prevgoal = _prev(actions['type_name']).isin(['goal', 'owngoal'])
    prev_scores = prev_scores.mask(prevgoal, 0)
    return scores - prev_scores


def defensive_value(
    actions: 'pd.DataFrame', scores: 'pd.Series', concedes: 'pd.Series'
) -> 'pd.Series':
    """Change in conceding probability produced by each action."""
    sameteam = _prev(actions['team_id']) == actions['team_id']
    prev_concedes = _prev(concedes) * sameteam + _prev(scores) * (~sameteam)
    prevgoal = _prev(actions['type_name']).isin(['goal', 'owngoal'])
    prev_concedes = prev_concedes.mask(prevgoal, 0)
    return -(concedes - prev_concedes)


def value(actions: 'pd.DataFrame', Pscores: 'pd.Series', Pconcedes: 'pd.Series') -> 'pd.DataFrame':
    """Offensive, defensive and total VAEP value of each atomic action."""
    import pandas as pd

    v = pd.DataFrame(index=actions.index)
    v['offensive_value'] = offensive_value(actions, Pscores, Pconcedes)
    v['defensive_value'] = defensive_value(actions, Pscores, Pconcedes)
    v['vaep_value'] = v['offensive_value'] + v['defensive_value']
    return v
