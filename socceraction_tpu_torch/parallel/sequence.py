"""Sequence parallelism: the action axis split over ranks, with halo exchange.

Port of ``socceraction_tpu/parallel/sequence.py``. The default scale-out
keeps each game's actions on one rank; for streams too long for one
device, or more devices than games, a ``(G, A)`` batch is split over a
``('games', 'seq')`` mesh and every kernel runs on its shard, extended by
a few columns of its neighbours. Both action families run, dispatched on
the batch class (:class:`~..core.batch.ActionBatch` or
:class:`~..core.batch.AtomicActionBatch`).

Every cross-action dependence of the valuation is bounded:

- features look back ``k - 1`` actions (edge-clamped shifts);
- labels look ahead ``nr_actions - 1`` actions (clamped at each game's
  last valid row);
- the VAEP formula lags one action;
- the one global dependence, goalscore's running score, is a prefix sum:
  a shard's own cumulative sum plus the goals of the shards before it.

So a shard receives ``k - 1`` columns from its left neighbour and
``nr_actions - 1`` from its right one (:mod:`.collectives`: one
point-to-point exchange carries every field), the stateless kernels of
the unsharded path run unchanged on the extended view, and goalscore
takes one all-gather of five numbers per game and shard (the team of its
first action and four goal counts). The shard at an edge fills its halo
the way the kernels clamp: column 0 on the left, the last column on the
right.

Every rank calls these with the same global batch (or its shard from
:func:`shard_batch_seq`) and gets back its own ``(G/games, A/seq, ...)``
shard of the result.
"""

from __future__ import annotations

import dataclasses
import functools
from typing import Any, Callable, Dict, List, NamedTuple, Sequence, Tuple

import torch

from ..core.batch import ActionBatch, AtomicActionBatch
from .collectives import all_gather, group_rank, group_size, shift_to_next, shift_to_previous
from .mesh import _take, axis_group, axis_index, axis_size, is_shard, mark_shard, pad_games, shard_games

__all__ = [
    'make_sequence_mesh',
    'shard_batch_seq',
    'sequence_features',
    'sequence_labels',
    'sequence_values',
    'sequence_rate',
]


# ------------------------------------------------------------- families ----


class _Family(NamedTuple):
    """What the sequence kernels need of one action family.

    ``formula(get, lag, ps, pc, psp, pcp)`` takes ``get(field)``, the local
    column, and ``lag(field)``, its lag-1 view, and flows through the
    family's ``vaep_core``, so the sharded and unsharded formulas cannot
    drift apart; ``lag_fields`` are the fields it lags.
    """

    name: str
    batch_cls: type
    seq_fields: Tuple[str, ...]  # every (G, A) field of the batch
    state_fields: Tuple[str, ...]  # the subset the state views read
    lag_fields: Tuple[str, ...]
    make_states: Callable[[Any, int], Any]
    kernels: Dict[str, Callable]
    goal_masks: Callable[[Any], Tuple[torch.Tensor, torch.Tensor]]
    formula: Callable


def _standard_formula(get: Callable, lag: Callable, ps: Any, pc: Any, psp: Any, pcp: Any) -> Any:
    from ..ops.formula import vaep_core

    return vaep_core(
        get('type_id'), get('time_seconds'), ps, pc,
        type_prev=lag('type_id'),
        result_prev=lag('result_id'),
        sameteam=lag('is_home') == get('is_home'),
        time_prev=lag('time_seconds'),
        p_scores_prev=psp,
        p_concedes_prev=pcp,
    )


def _atomic_formula(get: Callable, lag: Callable, ps: Any, pc: Any, psp: Any, pcp: Any) -> Any:
    from ..ops.atomic import vaep_core

    return vaep_core(
        ps, pc,
        type_prev=lag('type_id'),
        sameteam=lag('is_home') == get('is_home'),
        p_scores_prev=psp,
        p_concedes_prev=pcp,
    )


@functools.cache
def _standard_family() -> _Family:
    from ..ops.features import KERNELS, _States
    from ..ops.labels import _goal_masks

    seq = (
        'type_id', 'result_id', 'bodypart_id', 'period_id', 'is_home',
        'time_seconds', 'start_x', 'start_y', 'end_x', 'end_y', 'mask', 'row_index',
    )
    return _Family(
        name='standard',
        batch_cls=ActionBatch,
        seq_fields=seq,
        state_fields=tuple(f for f in seq if f not in ('mask', 'row_index')),
        lag_fields=('type_id', 'result_id', 'is_home', 'time_seconds'),
        make_states=_States,
        kernels=KERNELS,
        goal_masks=lambda b: _goal_masks(b.type_id, b.result_id),
        formula=_standard_formula,
    )


@functools.cache
def _atomic_family() -> _Family:
    from ..ops.atomic import ATOMIC_KERNELS, _AtomicStates, _goal_masks

    seq = (
        'type_id', 'bodypart_id', 'period_id', 'is_home', 'time_seconds',
        'x', 'y', 'dx', 'dy', 'mask', 'row_index',
    )
    return _Family(
        name='atomic',
        batch_cls=AtomicActionBatch,
        seq_fields=seq,
        state_fields=tuple(f for f in seq if f not in ('mask', 'row_index')),
        lag_fields=('type_id', 'is_home'),
        make_states=_AtomicStates,
        kernels=ATOMIC_KERNELS,
        goal_masks=lambda b: _goal_masks(b.type_id),
        formula=_atomic_formula,
    )


def _family_of(batch: Any) -> _Family:
    if isinstance(batch, AtomicActionBatch):
        return _atomic_family()
    if isinstance(batch, ActionBatch):
        return _standard_family()
    raise TypeError(f'not an action batch: {type(batch).__name__}')


# ----------------------------------------------------------------- mesh ----


def make_sequence_mesh(
    n_devices: int = None, seq_parallel: int = 2, *, device_type: str = 'cuda'
) -> Any:
    """A ``('games', 'seq')`` mesh over every rank of the default group:
    data-parallel games by ``seq_parallel`` sequence shards, which must
    divide the world size (``n_devices``, if given, must equal it)."""
    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh

    if not dist.is_initialized():
        raise RuntimeError('no process group: call utils.env.init_distributed() first')
    n = dist.get_world_size()
    if n_devices is not None and n_devices != n:
        raise ValueError(f'n_devices={n_devices} differs from the world size {n}')
    if seq_parallel < 1 or n % seq_parallel != 0:
        raise ValueError(f'seq_parallel={seq_parallel} does not divide {n} devices')
    return init_device_mesh(
        device_type, (n // seq_parallel, seq_parallel), mesh_dim_names=('games', 'seq')
    )


def _shard_seq(x: torch.Tensor, mesh: Any) -> torch.Tensor:
    """This rank's ``(games, seq)`` block of a ``(G, A, ...)`` array laid
    out like the global batch."""
    return _take(shard_games(x, mesh), 1, axis_index(mesh, 'seq'), axis_size(mesh, 'seq'))


def shard_batch_seq(batch: Any, mesh: Any) -> Any:
    """This rank's shard of a global batch: games over ``'games'`` (padded
    with inert games, as :func:`~.mesh.shard_batch` pads) and actions over
    ``'seq'``.

    Either family. The action axis must divide over ``'seq'`` (pack with a
    divisible ``max_actions``). A shard passed back in is returned as it is.
    """
    if is_shard(batch, mesh):
        return batch
    fam = _family_of(batch)
    n_seq = axis_size(mesh, 'seq')
    if batch.max_actions % n_seq != 0:
        raise ValueError(
            f'action axis {batch.max_actions} does not divide over seq={n_seq} '
            'shards; pack with a divisible max_actions'
        )
    padded = pad_games(batch, axis_size(mesh, 'games'))
    fields = {
        name: _shard_seq(t, mesh) if name in fam.seq_fields else shard_games(t, mesh)
        for name, t in padded.fields().items()
    }
    return mark_shard(fam.batch_cls(**fields), mesh)


# ---------------------------------------------------------------- halos ----


def _check_halo(h: int, local_width: int) -> None:
    if h > local_width:
        raise ValueError(
            f'halo width {h} exceeds the local shard width {local_width}; a shard '
            'holds its neighbour-adjacent columns only once: use fewer seq shards '
            'or a larger max_actions at pack time'
        )


def _dense(t: torch.Tensor) -> torch.Tensor:
    """``t``'s elements in fresh, densely packed 1-D storage (a dtype view
    needs unit stride and an aligned start, which a slice may lack)."""
    return torch.empty(t.numel(), dtype=t.dtype, device=t.device).copy_(t.reshape(-1))


def _to_wire(t: torch.Tensor) -> torch.Tensor:
    """A ``(G, h)`` array as its ``(G, bytes)`` rows (bools as 0/1 bytes)."""
    flat = _dense(t.to(torch.uint8) if t.dtype == torch.bool else t).view(torch.uint8)
    return flat.reshape(t.shape[0], -1)


def _from_wire(w: torch.Tensor, like: torch.Tensor) -> torch.Tensor:
    """The inverse of :func:`_to_wire` for an array of ``like``'s dtype."""
    flat = _dense(w)
    flat = flat.to(torch.bool) if like.dtype == torch.bool else flat.view(like.dtype)
    return flat.reshape(w.shape[0], -1)


def _halo(xs: Sequence[torch.Tensor], h: int, group: Any, left: bool) -> List[torch.Tensor]:
    """The ``(G, h)`` halo of each ``(G, A_loc)`` array from the left (or
    right) neighbour, all in one exchange; the edge shard fills with its
    own first (last) column, the kernels' clamp. Every rank of the group
    takes part: the edge shard still sends to its one neighbour."""
    _check_halo(h, xs[0].shape[1])
    wires = [_to_wire(x[:, -h:] if left else x[:, :h]) for x in xs]
    packed = torch.cat(wires, dim=1)
    got = shift_to_next(packed, group) if left else shift_to_previous(packed, group)
    n, i = group_size(group), group_rank(group)
    if (left and i == 0) or (not left and i == n - 1):
        return [(x[:, :1] if left else x[:, -1:]).expand(-1, h) for x in xs]
    out, off = [], 0
    for x, w in zip(xs, wires):
        out.append(_from_wire(got[:, off : off + w.shape[1]], x))
        off += w.shape[1]
    return out


def _extend(xs: Sequence[torch.Tensor], hl: int, hr: int, group: Any) -> List[torch.Tensor]:
    """Each array with ``hl`` halo columns before it and ``hr`` after."""
    xs = list(xs)
    lefts = _halo(xs, hl, group, True) if hl else [x[:, :0] for x in xs]
    rights = _halo(xs, hr, group, False) if hr else [x[:, :0] for x in xs]
    return [torch.cat([a, x, b], dim=1) for a, x, b in zip(lefts, xs, rights)]


def _extended_batch(fam: _Family, batch: Any, hl: int, hr: int, group: Any) -> Any:
    """The local batch whose state fields carry ``hl``/``hr`` halo columns
    (``mask`` and ``row_index`` are never read from an extended view)."""
    ext = _extend([getattr(batch, f) for f in fam.state_fields], hl, hr, group)
    return dataclasses.replace(batch, **dict(zip(fam.state_fields, ext)))


# ----------------------------------------------------------- goalscore ----


def _goalscore_seq(fam: _Family, batch: Any, group: Any) -> torch.Tensor:
    """The family's goalscore block on a shard: its own cumulative sum plus
    the goals of the shards before it.

    One all-gather carries, per game and shard, the team of the shard's
    first action (shard 0's is the game's, which names team "A") and the
    shard's goals and own goals by each side.
    """
    team = batch.is_home
    goals, owngoals = fam.goal_masks(batch)
    f = batch.time_seconds.dtype
    stats = torch.stack([
        team[:, 0].to(f),
        (goals & team).sum(1).to(f), (goals & ~team).sum(1).to(f),
        (owngoals & team).sum(1).to(f), (owngoals & ~team).sum(1).to(f),
    ])
    every = all_gather(stats, group)  # (n_seq, 5, G)
    first = every[0, 0] > 0.5
    teamisA = team == first[:, None]
    goalsA = ((goals & teamisA) | (owngoals & ~teamisA)).to(f)
    goalsB = ((goals & ~teamisA) | (owngoals & teamisA)).to(f)
    # goals for team A / B in each shard: a goal of A's side or an own goal of B's
    g_home, g_away, o_home, o_away = every[:, 1], every[:, 2], every[:, 3], every[:, 4]
    countA = torch.where(first, g_home + o_away, g_away + o_home)
    countB = torch.where(first, g_away + o_home, g_home + o_away)
    i = group_rank(group)
    scoreA = torch.cumsum(goalsA, dim=1) - goalsA + countA[:i].sum(0)[:, None]
    scoreB = torch.cumsum(goalsB, dim=1) - goalsB + countB[:i].sum(0)[:, None]
    team_score = torch.where(teamisA, scoreA, scoreB)
    opp_score = torch.where(teamisA, scoreB, scoreA)
    return torch.stack([team_score, opp_score, team_score - opp_score], dim=-1)


# ------------------------------------------------------------- kernels ----


def sequence_features(batch: Any, mesh: Any, *, names: Tuple[str, ...], k: int) -> torch.Tensor:
    """This rank's ``(G, A, F)`` feature block, the action axis split over
    ``'seq'``: the family's ``compute_features`` values, from one
    ``k - 1``-column halo exchange and goalscore's all-gather."""
    fam = _family_of(batch)
    local = shard_batch_seq(batch, mesh)
    group = axis_group(mesh, 'seq')
    hl = max(k - 1, 0)
    s = fam.make_states(_extended_batch(fam, local, hl, 0, group), k)
    blocks = [
        _goalscore_seq(fam, local, group) if name == 'goalscore' else fam.kernels[name](s)[:, hl:]
        for name in names
    ]
    return torch.cat(blocks, dim=-1)


def sequence_labels(
    batch: Any, mesh: Any, *, nr_actions: int = 10
) -> Tuple[torch.Tensor, torch.Tensor]:
    """This rank's ``scores``/``concedes`` label blocks, the action axis
    split over ``'seq'``.

    The family's ``scores_concedes`` values on valid rows (padding rows
    are arbitrary on both paths). The per-game tail clamp
    ``min(j + i, last valid row)`` is taken in local coordinates: shards
    left of the clamp read true neighbour values from the right halo, the
    shard holding it clamps exactly, and shards past it hold padding.
    """
    fam = _family_of(batch)
    local = shard_batch_seq(batch, mesh)
    group = axis_group(mesh, 'seq')
    hr = nr_actions - 1
    goal, owngoal = fam.goal_masks(local)
    team = local.is_home
    goal_e, owngoal_e, team_e = _extend([goal, owngoal, team], 0, hr, group)
    A_loc = goal.shape[1]
    offset = axis_index(mesh, 'seq') * A_loc
    # per-game last valid row in local coordinates (negative on shards of
    # padding only, whose rows are masked downstream)
    last = (local.n_actions.long() - 1 - offset)[:, None]
    cols = torch.arange(A_loc, device=goal.device)
    scores, concedes = goal, owngoal
    for i in range(1, nr_actions):
        idx = torch.minimum(cols + i, last).clamp(0, A_loc + hr - 1)
        goal_i = torch.gather(goal_e, 1, idx)
        owngoal_i = torch.gather(owngoal_e, 1, idx)
        same = torch.gather(team_e, 1, idx) == team
        scores = scores | (goal_i & same) | (owngoal_i & ~same)
        concedes = concedes | (goal_i & ~same) | (owngoal_i & same)
    return scores, concedes


def sequence_values(
    batch: Any, p_scores: torch.Tensor, p_concedes: torch.Tensor, mesh: Any
) -> torch.Tensor:
    """This rank's ``(G, A, 3)`` VAEP value block, the action axis split
    over ``'seq'``: the family's ``vaep_values``, whose lag-1 needs one
    column of left halo. ``p_scores``/``p_concedes`` are laid out like
    ``batch``: global arrays with a global batch, shards with a shard."""
    fam = _family_of(batch)
    if not is_shard(batch, mesh):
        p_scores, p_concedes = _shard_seq(p_scores, mesh), _shard_seq(p_concedes, mesh)
    local = shard_batch_seq(batch, mesh)
    group = axis_group(mesh, 'seq')
    cur = [getattr(local, f) for f in fam.lag_fields] + [p_scores, p_concedes]
    halo = _halo(cur, 1, group, True)
    lagged = [torch.cat([h, x[:, :-1]], dim=1) for h, x in zip(halo, cur)]
    lag = dict(zip(fam.lag_fields, lagged))
    return fam.formula(
        lambda f: getattr(local, f), lag.__getitem__, p_scores, p_concedes, lagged[-2], lagged[-1]
    )


@torch.no_grad()
def sequence_rate(model: Any, batch: Any, mesh: Any) -> torch.Tensor:
    """This rank's ``(G, A, 3)`` VAEP value block, rated end to end with
    the action axis split over ``'seq'``.

    The sequence-parallel twin of ``VAEP.rate_batch`` for both families:
    each shard's halo-extended view goes through
    :func:`~..ops.fused.fused_pair_logits` (one launch of kernel B1 on the
    card), with goalscore's cross-shard block injected as a dense
    override; the halo columns' probabilities come out of the same
    launch, so the formula's lag needs no second exchange. ``model`` is a
    fitted VAEP or AtomicVAEP with MLP heads, on the batch's device.
    """
    from ..ops.fused import REGISTRIES, fused_pair_logits

    fam = _family_of(batch)
    if not model._can_fuse():
        raise ValueError("sequence_rate needs fitted on-device MLP heads (learner='mlp')")
    if model._fused_registry != fam.name:
        raise ValueError(
            f'model feature family {model._fused_registry!r} does not match '
            f'the batch family {fam.name!r}'
        )
    clf_s, clf_c = model._heads()
    names, k = model.xfns, model.nb_prev_actions
    local = shard_batch_seq(batch, mesh)
    group = axis_group(mesh, 'seq')
    # the formula lags one action, whose own forward needs its k - 1
    # lookback states: the halo is k columns wide
    hl = k
    ext = _extended_batch(fam, local, hl, 0, group)
    overrides = None
    if 'goalscore' in names:
        gs = _goalscore_seq(fam, local, group)
        overrides = {'goalscore': torch.stack(_extend(gs.unbind(-1), hl, 0, group), dim=-1)}
    logit_s, logit_c = fused_pair_logits(
        clf_s.module, clf_c.module, ext, names=names, k=k,
        mean_a=clf_s.mean_, std_a=clf_s.std_, mean_b=clf_c.mean_, std_b=clf_c.std_,
        registry=REGISTRIES[model._fused_registry], dense_overrides=overrides,
    )
    ps_e, pc_e = torch.sigmoid(logit_s), torch.sigmoid(logit_c)
    A_loc = local.max_actions

    def lag_ext(x: torch.Tensor) -> torch.Tensor:
        # local column j's predecessor is extended column hl + j - 1
        return x[:, hl - 1 : hl - 1 + A_loc]

    return fam.formula(
        lambda f: getattr(local, f),
        lambda f: lag_ext(getattr(ext, f)),
        ps_e[:, hl:], pc_e[:, hl:], lag_ext(ps_e), lag_ext(pc_e),
    )
