"""The Atomic-SPADL action language: the seeded season draw and the plain
Atomic-VAEP reference.

Frozen copies of socceraction's definitions (``socceraction/atomic/spadl/
config.py``, ``atomic/vaep/features.py``, ``atomic/vaep/formula.py``) as
plain PyTorch over ``(G, A)`` tensors; they import nothing of the program
under test. Atomic rows carry a location and a displacement ``(x, y, dx,
dy)`` and no result. The vocabulary keeps socceraction's quirk: the name
``'interception'`` owns ids 10 and 24, so its one-hot column is the OR of
both and the one-hot block is 32 columns wide.
"""

from __future__ import annotations

from typing import Dict, List, Tuple

import torch

from . import spadl
from .spadl import FIELD_LENGTH, FIELD_WIDTH, categorical, onehot, shift

ACTIONTYPES = spadl.ACTIONTYPES + [
    'receival', 'interception', 'out', 'offside', 'goal', 'owngoal', 'yellow_card',
    'red_card', 'corner', 'freekick',
]
BODYPARTS = spadl.BODYPARTS
GOAL = ACTIONTYPES.index('goal')
OWNGOAL = ACTIONTYPES.index('owngoal')
#: ``(name, ids)`` of each one-hot column, in first-occurrence order.
ONEHOT_GROUPS = [
    (name, [i for i, t in enumerate(ACTIONTYPES) if t == name])
    for name in dict.fromkeys(ACTIONTYPES)
]

FIELDS: Dict[str, torch.dtype] = {
    'type_id': torch.int32, 'bodypart_id': torch.int32, 'period_id': torch.int32,
    'is_home': torch.bool, 'time_seconds': torch.float32, 'x': torch.float32,
    'y': torch.float32, 'dx': torch.float32, 'dy': torch.float32,
}


def draw(gen: torch.Generator, n_games: int, n_actions: int,
         device: torch.device) -> Dict[str, torch.Tensor]:
    """A ``(G, A)`` season of raw Atomic-SPADL columns (the draw of the port's
    smoke run: passes, dribbles and receivals eight times as likely as each
    other type; displacements with some exact zeros), every slot filled."""
    shape = (n_games, n_actions)
    p = [1.0] * len(ACTIONTYPES)
    for t in ('pass', 'dribble', 'receival'):
        p[ACTIONTYPES.index(t)] = 8.0

    def uniform(lo: float, hi: float) -> torch.Tensor:
        return lo + (hi - lo) * torch.rand(shape, generator=gen, device=device)

    def moved(scale: float) -> torch.Tensor:
        d = scale * torch.randn(shape, generator=gen, device=device)
        return torch.where(torch.rand(shape, generator=gen, device=device) < 0.1, 0.0, d)

    return {
        'type_id': categorical(gen, p, shape, device),
        'bodypart_id': torch.randint(0, len(BODYPARTS), shape, generator=gen,
                                     device=device).to(torch.int32),
        'period_id': torch.sort(
            torch.randint(1, 3, shape, generator=gen, device=device), dim=1
        ).values.to(torch.int32),
        'is_home': torch.randint(0, 2, shape, generator=gen, device=device).bool(),
        'time_seconds': torch.sort(uniform(0.0, 2700.0), dim=1).values,
        'x': uniform(0.0, FIELD_LENGTH),
        'y': uniform(0.0, FIELD_WIDTH),
        'dx': moved(10.0),
        'dy': moved(6.0),
    }


def states(f: Dict[str, torch.Tensor], k: int) -> spadl.States:
    """The ``k`` game states played left to right: where the current action's
    team is away, ``x, y`` flip about the pitch and ``dx, dy`` change sign."""
    home = f['is_home']
    out = []
    for i in range(k):
        a = {n: shift(t, i) for n, t in f.items()}
        a['x'] = torch.where(home, a['x'], FIELD_LENGTH - a['x'])
        a['y'] = torch.where(home, a['y'], FIELD_WIDTH - a['y'])
        a['dx'] = torch.where(home, a['dx'], -a['dx'])
        a['dy'] = torch.where(home, a['dy'], -a['dy'])
        out.append(a)
    return out


def goal_masks(type_id: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    return type_id == GOAL, type_id == OWNGOAL


def _actiontype_onehot(a: Dict[str, torch.Tensor], dt: torch.dtype) -> List[torch.Tensor]:
    t = a['type_id']
    return [torch.isin(t, torch.tensor(ids, device=t.device)).to(dt) for _, ids in ONEHOT_GROUPS]


def _movement_polar(a: Dict[str, torch.Tensor], dt: torch.dtype) -> List[torch.Tensor]:
    dx, dy = a['dx'], a['dy']
    angle = torch.where(dy == 0, torch.zeros_like(dy), torch.atan2(dy, dx))
    return [torch.sqrt(dx * dx + dy * dy), angle]


def _direction(a: Dict[str, torch.Tensor], dt: torch.dtype) -> List[torch.Tensor]:
    dx, dy = a['dx'], a['dy']
    total = torch.sqrt(dx * dx + dy * dy)
    moved = total > 0
    safe = torch.where(moved, total, torch.ones_like(total))
    return [torch.where(moved, dx / safe, dx), torch.where(moved, dy / safe, dy)]


def _time(a: Dict[str, torch.Tensor], dt: torch.dtype) -> List[torch.Tensor]:
    period = a['period_id'].to(dt)
    return [period, a['time_seconds'], (period - 1) * 45 * 60 + a['time_seconds']]


per_state = spadl._per_state
TRANSFORMERS: Dict[str, spadl.Transformer] = {
    'actiontype': per_state(lambda a, dt: [a['type_id'].to(dt)]),
    'actiontype_onehot': per_state(_actiontype_onehot, True),
    'bodypart': per_state(lambda a, dt: [a['bodypart_id'].to(dt)]),
    'bodypart_onehot': per_state(lambda a, dt: [onehot(a['bodypart_id'], len(BODYPARTS), dt)], True),
    'time': per_state(_time),
    'team': spadl.TRANSFORMERS['team'],
    'time_delta': spadl.TRANSFORMERS['time_delta'],
    'location': per_state(lambda a, dt: [a['x'], a['y']]),
    'polar': per_state(lambda a, dt: spadl.polar(a['x'], a['y'])),
    'movement_polar': per_state(_movement_polar),
    'direction': per_state(_direction),
    'goalscore': lambda s, dt: (spadl.goalscore(s[0], *goal_masks(s[0]['type_id']), dt), False),
}


def features(f: Dict[str, torch.Tensor], xfns: List[str], k: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """``(G, A, F)`` atomic features and the one-hot column mask
    (:func:`.spadl.features` over this language's transformers)."""
    return spadl.features(f, xfns, k, transformers=TRANSFORMERS, state_fn=states)


def values(f: Dict[str, torch.Tensor], p_scores: torch.Tensor,
           p_concedes: torch.Tensor) -> torch.Tensor:
    """``(G, A, 3)`` atomic VAEP values: a previous goal or own goal resets;
    there is no same-phase cutoff and no prior."""
    sameteam = spadl.prev(f['is_home']) == f['is_home']
    goal_prev, owngoal_prev = goal_masks(spadl.prev(f['type_id']))
    reset = goal_prev | owngoal_prev
    zero = torch.zeros((), dtype=p_scores.dtype, device=p_scores.device)
    prev_scores = torch.where(sameteam, spadl.prev(p_scores), spadl.prev(p_concedes))
    prev_scores = torch.where(reset, zero, prev_scores)
    prev_concedes = torch.where(sameteam, spadl.prev(p_concedes), spadl.prev(p_scores))
    prev_concedes = torch.where(reset, zero, prev_concedes)
    offensive = p_scores - prev_scores
    defensive = -(p_concedes - prev_concedes)
    return torch.stack([offensive, defensive, offensive + defensive], -1)
