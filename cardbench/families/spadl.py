"""The SPADL action language: the seeded season draw and the plain VAEP reference.

The vocabulary, the feature transformers and the value formula are frozen
copies of socceraction's definitions (``socceraction/spadl/config.py``,
``socceraction/vaep/features.py``, ``socceraction/vaep/formula.py``;
Decroos et al., KDD 2019), written as plain PyTorch over ``(G, A)`` tensors
of left-aligned games. They import nothing of the program under test.

- :func:`draw` makes a season's raw columns on a device from a
  ``torch.Generator``: the marginals of the port's synthetic batch (passes
  dominate, then dribbles, then a tail of the other types; sorted periods
  and clocks; end points as noisy displacements of start points).
- :func:`features` is the ``(G, A, F)`` feature tensor of the named
  transformers at ``k`` game states, in socceraction's column order, in the
  dtype of the float fields it is given.
- :func:`values` is the offensive, defensive and total VAEP value.
"""

from __future__ import annotations

from typing import Callable, Dict, List, Sequence, Tuple

import torch

FIELD_LENGTH = 105.0
FIELD_WIDTH = 68.0
BODYPARTS = ['foot', 'head', 'other', 'head/other']
RESULTS = ['fail', 'success', 'offside', 'owngoal', 'yellow_card', 'red_card']
ACTIONTYPES = [
    'pass', 'cross', 'throw_in', 'freekick_crossed', 'freekick_short', 'corner_crossed',
    'corner_short', 'take_on', 'foul', 'tackle', 'interception', 'shot', 'shot_penalty',
    'shot_freekick', 'keeper_save', 'keeper_claim', 'keeper_punch', 'keeper_pick_up',
    'clearance', 'bad_touch', 'non_action', 'dribble', 'goalkick',
]
SHOT_LIKE = [ACTIONTYPES.index(t) for t in ('shot', 'shot_penalty', 'shot_freekick')]
SUCCESS = RESULTS.index('success')
OWNGOAL = RESULTS.index('owngoal')
SHOT_PENALTY = ACTIONTYPES.index('shot_penalty')
CORNERS = [ACTIONTYPES.index(t) for t in ('corner_crossed', 'corner_short')]
#: socceraction's fixed odds and same-phase window (``vaep/formula.py``).
PENALTY_PRIOR = 0.792453
CORNER_PRIOR = 0.046500
SAMEPHASE_SECONDS = 10.0

#: The batch fields of one SPADL action and their dtypes.
FIELDS: Dict[str, torch.dtype] = {
    'type_id': torch.int32, 'result_id': torch.int32, 'bodypart_id': torch.int32,
    'period_id': torch.int32, 'is_home': torch.bool, 'time_seconds': torch.float32,
    'start_x': torch.float32, 'start_y': torch.float32, 'end_x': torch.float32,
    'end_y': torch.float32,
}


def categorical(gen: torch.Generator, probs: Sequence[float], shape: Tuple[int, ...],
                device: torch.device) -> torch.Tensor:
    """int32 draws of ``shape`` from the categorical ``probs`` (inverse CDF)."""
    p = torch.tensor(probs, dtype=torch.float64)
    cdf = (torch.cumsum(p, 0) / p.sum()).to(device)
    u = torch.rand(shape, generator=gen, device=device, dtype=torch.float64)
    return torch.searchsorted(cdf, u).clamp(max=len(probs) - 1).to(torch.int32)


def draw(gen: torch.Generator, n_games: int, n_actions: int,
         device: torch.device) -> Dict[str, torch.Tensor]:
    """A ``(G, A)`` season of raw SPADL columns, every slot filled."""
    shape = (n_games, n_actions)
    types = [0.02] * len(ACTIONTYPES)
    types[ACTIONTYPES.index('pass')] = 0.45
    types[ACTIONTYPES.index('dribble')] = 0.25
    types[ACTIONTYPES.index('shot')] = 0.03

    def uniform(lo: float, hi: float) -> torch.Tensor:
        return lo + (hi - lo) * torch.rand(shape, generator=gen, device=device)

    def normal(scale: float) -> torch.Tensor:
        return scale * torch.randn(shape, generator=gen, device=device)

    start_x = uniform(0.0, FIELD_LENGTH)
    start_y = uniform(0.0, FIELD_WIDTH)
    return {
        'type_id': categorical(gen, types, shape, device),
        'result_id': categorical(gen, [0.25, 0.68, 0.02, 0.02, 0.02, 0.01], shape, device),
        'bodypart_id': categorical(gen, [0.85, 0.08, 0.05, 0.02], shape, device),
        'period_id': torch.sort(
            torch.randint(1, 5, shape, generator=gen, device=device), dim=1
        ).values.to(torch.int32),
        'is_home': torch.randint(0, 2, shape, generator=gen, device=device).bool(),
        'time_seconds': torch.sort(uniform(0.0, 3000.0), dim=1).values,
        'start_x': start_x,
        'start_y': start_y,
        'end_x': (start_x + normal(12.0)).clamp(0.0, FIELD_LENGTH),
        'end_y': (start_y + normal(8.0)).clamp(0.0, FIELD_WIDTH),
    }


def end_location(nx: int, ny: int) -> Dict[str, List[float]]:
    """The field values of an ``nx × ny`` end-location sweep: perturbation
    ``p = iy·nx + ix`` moves every end point to the center of cell
    ``(ix, iy)`` of the pitch."""
    xs = [(ix + 0.5) * FIELD_LENGTH / nx for ix in range(nx)]
    ys = [(iy + 0.5) * FIELD_WIDTH / ny for iy in range(ny)]
    return {'end_x': [x for _ in ys for x in xs], 'end_y': [y for y in ys for _ in xs]}


# -- features ---------------------------------------------------------------


def shift(a: torch.Tensor, i: int) -> torch.Tensor:
    """Game state ``i``: row ``j`` sees row ``max(j - i, 0)`` of its game."""
    idx = (torch.arange(a.shape[1], device=a.device) - i).clamp(min=0)
    return a[:, idx]


def onehot(ids: torch.Tensor, n: int, dtype: torch.dtype) -> torch.Tensor:
    return (ids[..., None] == torch.arange(n, device=ids.device)).to(dtype)


def polar(x: torch.Tensor, y: torch.Tensor) -> List[torch.Tensor]:
    """Distance and angle to the opponent's goal (socceraction's ``_polar``)."""
    dx = (FIELD_LENGTH - x).abs()
    dy = (FIELD_WIDTH / 2 - y).abs()
    return [torch.sqrt(dx * dx + dy * dy), torch.nan_to_num(torch.atan(dy / dx))]


def goal_masks(type_id: torch.Tensor, result_id: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    shot = torch.isin(type_id, torch.tensor(SHOT_LIKE, device=type_id.device))
    return shot & (result_id == SUCCESS), shot & (result_id == OWNGOAL)


def goalscore(a0: Dict[str, torch.Tensor], goals: torch.Tensor, owngoals: torch.Tensor,
              dtype: torch.dtype) -> List[torch.Tensor]:
    """Score of the acting team, of its opponent and the difference, before
    each action; team A is the team of the game's first action."""
    team_a = a0['is_home'] == a0['is_home'][:, :1]
    goals_a = ((goals & team_a) | (owngoals & ~team_a)).to(dtype)
    goals_b = ((goals & ~team_a) | (owngoals & team_a)).to(dtype)
    score_a = torch.cumsum(goals_a, 1) - goals_a
    score_b = torch.cumsum(goals_b, 1) - goals_b
    team = torch.where(team_a, score_a, score_b)
    opponent = torch.where(team_a, score_b, score_a)
    return [team, opponent, team - opponent]


States = List[Dict[str, torch.Tensor]]
#: Each transformer: ``(states, dtype) -> (columns or blocks, one-hot?)``.
Transformer = Callable[[States, torch.dtype], Tuple[List[torch.Tensor], bool]]


def _per_state(fn: Callable[[Dict[str, torch.Tensor], torch.dtype], List[torch.Tensor]],
               is_onehot: bool = False) -> Transformer:
    """socceraction's ``@simple``: the transformer on each state in turn."""
    return lambda s, dt: ([c for a in s for c in fn(a, dt)], is_onehot)


def _type_result(a: Dict[str, torch.Tensor], dt: torch.dtype) -> List[torch.Tensor]:
    t = onehot(a['type_id'], len(ACTIONTYPES), dt)
    r = onehot(a['result_id'], len(RESULTS), dt)
    return [(t[..., :, None] * r[..., None, :]).flatten(-2)]  # type-major


def _movement(a: Dict[str, torch.Tensor], dt: torch.dtype) -> List[torch.Tensor]:
    dx = a['end_x'] - a['start_x']
    dy = a['end_y'] - a['start_y']
    return [dx, dy, torch.sqrt(dx * dx + dy * dy)]


def _space_delta(s: States, dt: torch.dtype) -> Tuple[List[torch.Tensor], bool]:
    cols = []
    for a in s[1:]:
        dx = a['end_x'] - s[0]['start_x']
        dy = a['end_y'] - s[0]['start_y']
        cols += [dx, dy, torch.sqrt(dx * dx + dy * dy)]
    return cols, False


def _goalscore(s: States, dt: torch.dtype) -> Tuple[List[torch.Tensor], bool]:
    return goalscore(s[0], *goal_masks(s[0]['type_id'], s[0]['result_id']), dt), False


def _time(a: Dict[str, torch.Tensor], dt: torch.dtype) -> List[torch.Tensor]:
    period = a['period_id'].to(dt)
    return [period, a['time_seconds'], (period - 1) * 45 * 60 + a['time_seconds']]


TRANSFORMERS: Dict[str, Transformer] = {
    'actiontype_onehot': _per_state(lambda a, dt: [onehot(a['type_id'], len(ACTIONTYPES), dt)], True),
    'result_onehot': _per_state(lambda a, dt: [onehot(a['result_id'], len(RESULTS), dt)], True),
    'actiontype_result_onehot': _per_state(_type_result, True),
    'bodypart_onehot': _per_state(lambda a, dt: [onehot(a['bodypart_id'], len(BODYPARTS), dt)], True),
    'time': _per_state(_time),
    'startlocation': _per_state(lambda a, dt: [a['start_x'], a['start_y']]),
    'endlocation': _per_state(lambda a, dt: [a['end_x'], a['end_y']]),
    'startpolar': _per_state(lambda a, dt: polar(a['start_x'], a['start_y'])),
    'endpolar': _per_state(lambda a, dt: polar(a['end_x'], a['end_y'])),
    'movement': _per_state(_movement),
    'team': lambda s, dt: ([(a['is_home'] == s[0]['is_home']).to(dt) for a in s[1:]], False),
    'time_delta': lambda s, dt: ([s[0]['time_seconds'] - a['time_seconds'] for a in s[1:]], False),
    'space_delta': _space_delta,
    'goalscore': _goalscore,
}


def states(f: Dict[str, torch.Tensor], k: int) -> States:
    """The ``k`` game states, played left to right: every state is mirrored
    where the current action's team is the away team."""
    home = f['is_home']
    out = []
    for i in range(k):
        a = {n: shift(t, i) for n, t in f.items()}
        for col, extent in (('start_x', FIELD_LENGTH), ('end_x', FIELD_LENGTH),
                            ('start_y', FIELD_WIDTH), ('end_y', FIELD_WIDTH)):
            a[col] = torch.where(home, a[col], extent - a[col])
        out.append(a)
    return out


def _as_block(cols: List[torch.Tensor], dt: torch.dtype) -> torch.Tensor:
    return torch.cat([c.to(dt) if c.dim() == 3 else c.to(dt)[..., None] for c in cols], -1)


def features(f: Dict[str, torch.Tensor], xfns: Sequence[str], k: int,
             transformers: Dict[str, Transformer] = TRANSFORMERS,
             state_fn: Callable[[Dict[str, torch.Tensor], int], States] = states,
             ) -> Tuple[torch.Tensor, torch.Tensor]:
    """``(G, A, F)`` features in the dtype of ``f['time_seconds']``, and the
    ``(F,)`` bool mask of one-hot columns."""
    dt = f['time_seconds'].dtype
    s = state_fn(f, k)
    blocks, kinds = [], []
    for name in xfns:
        cols, is_onehot = transformers[name](s, dt)
        block = _as_block(cols, dt)
        blocks.append(block)
        kinds.append(torch.full((block.shape[-1],), is_onehot, dtype=torch.bool))
    return torch.cat(blocks, -1), torch.cat(kinds)


# -- values -----------------------------------------------------------------


def prev(a: torch.Tensor) -> torch.Tensor:
    """socceraction's ``_prev``: the previous action, the first its own."""
    return shift(a, 1)


def values(f: Dict[str, torch.Tensor], p_scores: torch.Tensor,
           p_concedes: torch.Tensor) -> torch.Tensor:
    """``(G, A, 3)``: offensive, defensive and total VAEP value."""
    sameteam = prev(f['is_home']) == f['is_home']
    toolong = (f['time_seconds'] - prev(f['time_seconds'])).abs() > SAMEPHASE_SECONDS
    prevgoal, _ = goal_masks(prev(f['type_id']), prev(f['result_id']))
    reset = toolong | prevgoal
    zero = torch.zeros((), dtype=p_scores.dtype, device=p_scores.device)
    prev_scores = torch.where(sameteam, prev(p_scores), prev(p_concedes))
    prev_scores = torch.where(reset, zero, prev_scores)
    prev_scores = torch.where(f['type_id'] == SHOT_PENALTY, zero + PENALTY_PRIOR, prev_scores)
    is_corner = torch.isin(f['type_id'], torch.tensor(CORNERS, device=p_scores.device))
    prev_scores = torch.where(is_corner, zero + CORNER_PRIOR, prev_scores)
    prev_concedes = torch.where(sameteam, prev(p_concedes), prev(p_scores))
    prev_concedes = torch.where(reset, zero, prev_concedes)
    offensive = p_scores - prev_scores
    defensive = -(p_concedes - prev_concedes)
    return torch.stack([offensive, defensive, offensive + defensive], -1)
