"""Expected Threat (xT) kernels: counts, probabilities, value iteration, rating.

Port of ``socceraction_tpu/ops/xt.py`` with the same semantics:

- grid binning: elementwise divide/truncate/clip, in f32 and in the JAX
  package's order of operations, so cells match bit for bit;
- every count vector and count matrix is one :func:`~.segment.segment_sum`
  over flat cell indexes (kernel B2 on the card), masked for padding;
- the value iteration ``xT <- p_shot * p_score + p_move * reshape(T @ vec(xT))``,
  dense (one mat-vec per sweep) or matrix-free (one gather plus one segment
  sum over the successful-move stream per sweep);
- rating: a masked gather of grid values.

Grid layout: cell ``(xi, yj)`` has flat index ``(w - 1 - yj) * l + xi``
(row 0 of the ``(w, l)`` grid is the top of the pitch).

Every entry point also takes a fleet of grids: a per-action ``group_id``
gives ``(G, ...)`` count stacks from one segment sum over
``group * w * l + cell``, and a stacked ``(G, w, l)`` probability set is
solved by one loop with per-grid convergence masking.

Each solve is a host loop that reads its exit test once per sweep (the
JAX package runs one ``lax.while_loop``): Picard tests the signed
``max(new - old) > eps``, the accelerated variants ``max|f - x|``, the
fleet loop ``any(~done)``, all in f32 as the JAX loop compares them, so
iteration counts and certificates mean what they mean there.

The counts and the matrix-free solve also run on a game shard of a
larger batch (the JAX package's ``axis_name``): with ``group=`` (a
``torch.distributed`` process group) every count and every sweep's payoff
is summed over the group's ranks before it is used. Every rank then holds
the same bits after each sum, so every rank's host loop reads the same
residual and leaves at the same sweep; the ranks stay in step.
"""

from __future__ import annotations

import contextlib
import functools
from typing import Any, Callable, Iterator, NamedTuple, Optional, Tuple

import numpy as np
import torch

from ..obs.dispatch import instrument
from ..spadl import config as spadlconfig
from .segment import segment_sum, segment_sum_2d, segment_sum_cost

__all__ = [
    'cell_indexes',
    'flat_indexes',
    'XTCounts',
    'xt_counts',
    'XTProbabilities',
    'xt_probabilities',
    'XTSolution',
    'SOLVERS',
    'solve_xt',
    'solve_xt_matrix_free',
    'rate_actions',
    'interpolate_grid',
]

_MOVE_TYPES = (spadlconfig.PASS, spadlconfig.DRIBBLE, spadlconfig.CROSS)

Sweep = Callable[[torch.Tensor], torch.Tensor]


def _f32(v: float) -> float:
    """``v`` rounded to f32: the JAX loops compare f32 residuals against
    ``eps`` as a weakly typed f32 scalar."""
    return float(np.float32(v))


def _scalar(v: float, like: torch.Tensor) -> torch.Tensor:
    return torch.full((), v, dtype=like.dtype, device=like.device)


@contextlib.contextmanager
def _full_f32() -> Iterator[None]:
    """Matmuls in full f32 (TF32 off) while a solve runs: the sweep's
    mat-vec and Anderson's small products are held to 1e-5 of the JAX
    package's ``Precision.HIGHEST``. The previous setting comes back after."""
    prev = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32 = prev


def cell_indexes(
    x: torch.Tensor, y: torch.Tensor, l: int, w: int
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Bin pitch coordinates into int32 grid cell indexes.

    ``x / field_length * l`` in f32, truncated toward zero, then clipped.
    The pitch size is a 0-dim tensor on ``x``'s device, not a Python
    scalar: PyTorch's CUDA division by a host scalar multiplies by its
    reciprocal, which rounds differently and would move cells.
    """
    length = _scalar(spadlconfig.field_length, x)
    width = _scalar(spadlconfig.field_width, y)
    xi = (x / length * l).to(torch.int32)
    yj = (y / width * w).to(torch.int32)
    return xi.clamp(0, l - 1), yj.clamp(0, w - 1)


def flat_indexes(x: torch.Tensor, y: torch.Tensor, l: int, w: int) -> torch.Tensor:
    """Flatten cell indexes with the top-left origin layout (int32)."""
    xi, yj = cell_indexes(x, y, l, w)
    return (w - 1 - yj) * l + xi


class XTCounts(NamedTuple):
    """Raw event counts on the grid (a leading ``(G,)`` axis when grouped)."""

    shots: torch.Tensor  # (w*l,) shot count per cell
    goals: torch.Tensor  # (w*l,) goal count per cell
    moves: torch.Tensor  # (w*l,) move-action count per start cell
    trans: torch.Tensor  # (w*l, w*l) successful-move count per (start, end) cell


def _is_move(type_id: torch.Tensor) -> torch.Tensor:
    m = type_id == _MOVE_TYPES[0]
    for t in _MOVE_TYPES[1:]:
        m = m | (type_id == t)
    return m


class _ActionStream(NamedTuple):
    """Flattened, validity-masked view of an action batch."""

    start_flat: torch.Tensor  # (n,) flat start cell (junk where ~start_ok)
    end_flat: torch.Tensor  # (n,) flat end cell (junk where ~end_ok)
    is_shot: torch.Tensor
    is_goal: torch.Tensor
    is_move: torch.Tensor
    is_success_move: torch.Tensor


def _action_stream(
    type_id: torch.Tensor,
    result_id: torch.Tensor,
    start_x: torch.Tensor,
    start_y: torch.Tensor,
    end_x: torch.Tensor,
    end_y: torch.Tensor,
    mask: torch.Tensor,
    l: int,
    w: int,
) -> _ActionStream:
    """Flatten a batch and derive the masked xT event predicates.

    NaN start coordinates exclude an action; transition pairs also need a
    valid end location.
    """
    type_id = type_id.reshape(-1)
    result_id = result_id.reshape(-1)
    mask = mask.reshape(-1)
    start_x, start_y = start_x.reshape(-1), start_y.reshape(-1)
    end_x, end_y = end_x.reshape(-1), end_y.reshape(-1)

    start_ok = ~(torch.isnan(start_x) | torch.isnan(start_y))
    end_ok = start_ok & ~(torch.isnan(end_x) | torch.isnan(end_y))
    start_flat = flat_indexes(torch.nan_to_num(start_x), torch.nan_to_num(start_y), l, w)
    end_flat = flat_indexes(torch.nan_to_num(end_x), torch.nan_to_num(end_y), l, w)

    is_shot = mask & start_ok & (type_id == spadlconfig.SHOT)
    is_goal = is_shot & (result_id == spadlconfig.SUCCESS)
    is_move = mask & start_ok & _is_move(type_id)
    is_success_move = is_move & end_ok & (result_id == spadlconfig.SUCCESS)
    return _ActionStream(start_flat, end_flat, is_shot, is_goal, is_move, is_success_move)


def _safe_divide(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """``a / b`` with 0 where ``b == 0``."""
    nz = b != 0
    return torch.where(nz, a / torch.where(nz, b, 1.0), 0.0)


def _cell_probabilities(
    shots: torch.Tensor, goals: torch.Tensor, moves: torch.Tensor, l: int, w: int
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """(p_score, p_shot, p_move) grids; ``(G, w*l)`` stacks give ``(G, w, l)``."""
    shape = tuple(shots.shape[:-1]) + (w, l)
    p_score = _safe_divide(goals, shots).reshape(shape)
    total = shots + moves
    p_shot = _safe_divide(shots, total).reshape(shape)
    p_move = _safe_divide(moves, total).reshape(shape)
    return p_score, p_shot, p_move


class XTSolution(NamedTuple):
    """Convergence certificate of one xT solve (any solver).

    ``grid`` is ``sweep(p)`` for the solver's last tested point ``p`` and
    ``residual`` is the residual the loop tested for it before exiting.
    For a fleet every field has a leading ``(G,)`` axis; otherwise
    ``residual``, ``iterations`` and ``converged`` are 0-dim tensors.
    """

    grid: torch.Tensor
    residual: torch.Tensor
    iterations: torch.Tensor
    converged: torch.Tensor


#: The solver family behind ``solver=``; ``'plain'`` is an alias of ``'picard'``.
SOLVERS: Tuple[str, ...] = ('picard', 'anderson', 'anchored', 'momentum')


def _resolve_solver(solver: Optional[str], accelerate: bool) -> str:
    """Normalize the ``solver=`` flag (and the deprecated ``accelerate``)."""
    if solver == 'plain':
        solver = 'picard'
    if solver is None:
        return 'anderson' if accelerate else 'picard'
    if solver not in SOLVERS:
        raise ValueError(f'unknown solver {solver!r} (want one of {SOLVERS})')
    if accelerate and solver != 'anderson':
        raise ValueError(
            "accelerate=True is a deprecated alias of solver='anderson' "
            f'and conflicts with solver={solver!r}'
        )
    return solver


_Loop = Tuple[torch.Tensor, int, float]


def _value_iteration(sweep: Sweep, gs: torch.Tensor, eps: float, max_iter: int) -> _Loop:
    """Picard: ``xT <- sweep(xT)`` while ``max(new - old) > eps``.

    The signed test is the reference's (xT is non-decreasing under plain
    iteration). Returns ``(xT, n_iter, resid)``, ``resid`` the last tested
    ``max(new - old)``.
    """
    eps = _f32(eps)
    x = torch.zeros_like(gs)
    resid, it = float('inf'), 0
    while resid > eps and it < max_iter:
        new = sweep(x)
        resid = float((new - x).max())
        x, it = new, it + 1
    return x, it, resid


_ANDERSON_MEMORY = 3  # history depth m


def _value_iteration_anderson(
    sweep: Sweep, gs: torch.Tensor, eps: float, max_iter: int
) -> _Loop:
    """Anderson-accelerated fixed-point iteration over the last ``m`` residuals.

    Each step solves a ridge-regularized ``m × m`` system for the mixing
    weights over the valid history rows (cold rows are masked, so early
    steps are plain sweeps), and tests ``max|f(x) - x|``. Returns the last
    plain sweep result ``f(x_prev)``, whose residual the loop tested.
    """
    eps = _f32(eps)
    m = _ANDERSON_MEMORY
    shape = gs.shape
    n = gs.numel()
    dt, dev = gs.dtype, gs.device
    eye = torch.eye(m, dtype=dt, device=dev)
    lanes = torch.arange(m, device=dev)
    x = torch.zeros(n, dtype=dt, device=dev)
    Fb = torch.zeros((m + 1, n), dtype=dt, device=dev)
    Rb = torch.zeros_like(Fb)
    resid, it = float('inf'), 0
    while resid > eps and it < max_iter:
        f = sweep(x.reshape(shape)).reshape(-1)
        r = f - x
        Fb = torch.cat([Fb[1:], f[None]])
        Rb = torch.cat([Rb[1:], r[None]])
        it += 1
        v = min(it, m + 1)  # real entries in Rb/Fb
        row_valid = (lanes >= m - (v - 1)).to(dt)
        dR = (Rb[1:] - Rb[:-1]) * row_valid[:, None]
        dF = (Fb[1:] - Fb[:-1]) * row_valid[:, None]
        A = dR @ dR.T
        ridge = 1e-10 * (torch.trace(A) + 1.0)
        gamma = torch.linalg.solve(A + ridge * eye, dR @ r) * row_valid
        x = f - gamma @ dF
        resid = float(r.abs().max())
    return Fb[-1].reshape(shape), it, resid


#: Floor on the squared contraction-modulus estimate (a grid with no
#: successful moves has modulus 0, and the anchor recursion divides by it).
_MIN_GAMMA_SQ = 1e-12

#: Power sweeps of the accelerated solvers' contraction-modulus estimate.
_MODULUS_POWER_SWEEPS = 8


def _contraction_modulus(sweep: Sweep, gs: torch.Tensor) -> torch.Tensor:
    """Estimate the sweep's effective contraction factor, per grid.

    Runs :data:`_MODULUS_POWER_SWEEPS` power sweeps ``v <- M v`` from
    ``gs`` (``sweep(0) == gs``, so ``sweep(v) - gs`` is exactly ``M v``) and
    returns ``(||M^s gs||_∞ / ||gs||_∞)^{1/s}`` clipped to ``[0, 1]``; 0 for
    a grid with no shots. Reduces over the two trailing (cell) axes.
    """
    v = gs
    for _ in range(_MODULUS_POWER_SWEEPS):
        v = sweep(v) - gs
    num = v.amax(dim=(-2, -1))
    den = gs.amax(dim=(-2, -1))
    est = torch.where(
        den > 0,
        (num / den.clamp_min(_MIN_GAMMA_SQ)) ** (1.0 / _MODULUS_POWER_SWEEPS),
        0.0,
    )
    return est.clamp(0.0, 1.0)


def _nesterov_cap(gamma: torch.Tensor) -> torch.Tensor:
    """γ-optimal momentum coefficient ``(1 - √(1-γ²)) / γ`` (``γ/2`` near 0)."""
    g = gamma.clamp(0.0, 1.0)
    return torch.where(
        g > 1e-6,
        (1.0 - torch.sqrt((1.0 - g * g).clamp(0.0, 1.0))) / g.clamp_min(1e-6),
        g / 2.0,
    )


def _value_iteration_anchored(
    sweep: Sweep, gs: torch.Tensor, eps: float, max_iter: int
) -> _Loop:
    """Halpern-anchored value iteration (Anc-VI, arXiv 2305.16569).

    ``x^{k+1} = (1 - β_{k+1}) f(x^k)`` (the anchor ``x^0`` is 0) with
    ``β_{k+1} = β_k / (β_k + γ^{-2})`` from the estimated modulus ``γ``;
    the modulus's power sweeps are not counted. Returns the last plain
    sweep result and its tested ``max|f(x) - x|``.
    """
    eps = _f32(eps)
    gamma = _contraction_modulus(sweep, gs)
    inv_g2 = 1.0 / (gamma * gamma).clamp_min(_MIN_GAMMA_SQ)
    x = torch.zeros_like(gs)
    out = x
    beta = _scalar(1.0, gs)
    resid, it = float('inf'), 0
    while resid > eps and it < max_iter:
        f = sweep(x)
        r = (f - x).abs().max()
        beta = beta / (beta + inv_g2)
        x, out = (1.0 - beta) * f, f
        resid, it = float(r), it + 1
    return out, it, resid


def _value_iteration_momentum(
    sweep: Sweep, gs: torch.Tensor, eps: float, max_iter: int
) -> _Loop:
    """Nesterov-momentum value iteration with adaptive restart.

    ``x^{k+1} = f(y^k)``, ``y^{k+1} = x^{k+1} + m_k (x^{k+1} - x^k)`` with
    ``m_k = min(a/(a+3), cap(γ))`` for momentum age ``a``; the age resets
    whenever the tested residual grows. Returns ``f(y)`` for the last
    extrapolated ``y`` and its tested ``max|f(y) - y|``.
    """
    eps = _f32(eps)
    m_cap = _nesterov_cap(_contraction_modulus(sweep, gs))
    y = torch.zeros_like(gs)
    x = out = y
    r_prev, age = float('inf'), 0
    resid, it = float('inf'), 0
    while resid > eps and it < max_iter:
        f = sweep(y)
        r = float((f - y).abs().max())
        if r > r_prev:
            age = 0
        a = np.float32(age)
        m = torch.minimum(_scalar(float(a / (a + np.float32(3.0))), gs), m_cap)
        y = f + m * (f - x)
        x = out = f
        r_prev, age = r, age + 1
        resid, it = r, it + 1
    return out, it, resid


_SINGLE_GRID_LOOPS = {
    'picard': _value_iteration,
    'anderson': _value_iteration_anderson,
    'anchored': _value_iteration_anchored,
    'momentum': _value_iteration_momentum,
}


def _batched_value_iteration(
    sweep: Sweep, gs: torch.Tensor, eps: float, max_iter: int, solver: str
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Solve a ``(G, w, l)`` fleet of grids in one loop.

    Every sweep advances all grids at once (one batched mat-vec, or one
    ``G·n``-segment sum). Each grid carries its own state: once its
    residual is at most ``eps`` it is frozen (its certificate iterate, its
    iteration count and its solver state stop changing) while the rest
    keep sweeping; the loop exits when every grid is done or ``max_iter``
    cuts it. Returns ``(out, it, resid)`` with per-grid ``(G,)`` counts and
    residuals.
    """
    eps = _f32(eps)
    G = gs.shape[0]
    grid_shape = gs.shape
    n = gs[0].numel()
    dt, dev = gs.dtype, gs.device

    def gmax(a: torch.Tensor) -> torch.Tensor:
        return a.reshape(G, -1).amax(dim=1)

    def where_lead(active: torch.Tensor, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
        return torch.where(active.reshape((G,) + (1,) * (a.dim() - 1)), a, b)

    extra: Tuple[torch.Tensor, ...] = ()
    if solver == 'anderson':
        m = _ANDERSON_MEMORY
        zeros_h = torch.zeros((G, m + 1, n), dtype=dt, device=dev)
        extra = (zeros_h, zeros_h)
        eye = torch.eye(m, dtype=dt, device=dev)
        lanes = torch.arange(m, device=dev)
    elif solver == 'anchored':
        gamma = _contraction_modulus(sweep, gs)
        inv_g2 = 1.0 / (gamma * gamma).clamp_min(_MIN_GAMMA_SQ)
        extra = (torch.ones((G,), dtype=dt, device=dev),)  # per-grid anchor weight β
    elif solver == 'momentum':
        m_cap = _nesterov_cap(_contraction_modulus(sweep, gs))  # (G,)
        extra = (torch.zeros_like(gs), torch.zeros((G,), dtype=torch.int32, device=dev))

    x = torch.zeros_like(gs)
    out = torch.zeros_like(gs)
    resid = torch.full((G,), float('inf'), dtype=dt, device=dev)
    it_g = torch.zeros((G,), dtype=torch.int32, device=dev)
    done = torch.zeros((G,), dtype=torch.bool, device=dev)
    k = 0
    while k < max_iter and bool((~done).any()):
        f = sweep(x)
        diff = f - x
        # picard keeps the reference's signed test; the accelerated
        # variants are non-monotone and test |f - x|
        r = gmax(diff) if solver == 'picard' else gmax(diff.abs())

        if solver == 'picard':
            x_new, extra_new = f, extra
        elif solver == 'anderson':
            Fb, Rb = extra
            fv = f.reshape(G, n)
            rv = fv - x.reshape(G, n)
            Fb = torch.cat([Fb[:, 1:], fv[:, None]], dim=1)
            Rb = torch.cat([Rb[:, 1:], rv[:, None]], dim=1)
            # history validity follows the global sweep counter: every
            # active grid has seen exactly k + 1 sweeps
            v = min(k + 1, m + 1)
            row_valid = (lanes >= m - (v - 1)).to(dt)
            dR = (Rb[:, 1:] - Rb[:, :-1]) * row_valid[None, :, None]
            dF = (Fb[:, 1:] - Fb[:, :-1]) * row_valid[None, :, None]
            A = torch.einsum('gmn,gkn->gmk', dR, dR)
            ridge = 1e-10 * (torch.diagonal(A, dim1=1, dim2=2).sum(-1) + 1.0)
            gamma_w = torch.linalg.solve(
                A + ridge[:, None, None] * eye,
                torch.einsum('gmn,gn->gm', dR, rv)[..., None],
            )[..., 0] * row_valid[None, :]
            x_new = (fv - torch.einsum('gm,gmn->gn', gamma_w, dF)).reshape(grid_shape)
            extra_new = (Fb, Rb)
        elif solver == 'anchored':
            (beta,) = extra
            beta_new = beta / (beta + inv_g2)
            x_new = (1.0 - beta_new)[:, None, None] * f
            extra_new = (beta_new,)
        else:  # momentum
            x_prev, age = extra
            age = torch.where(r > resid, 0, age)
            a = age.to(dt)
            mom = torch.minimum(a / (a + 3.0), m_cap)
            x_new = f + mom[:, None, None] * (f - x_prev)
            extra_new = (f, age + 1)

        active = ~done
        out = where_lead(active, f, out)
        resid = torch.where(active, r, resid)
        it_g = it_g + active.to(torch.int32)
        done = done | (active & (r <= eps))
        x = where_lead(active, x_new, x)
        extra = tuple(where_lead(active, a, b) for a, b in zip(extra_new, extra))
        k += 1
    return out, it_g, resid


def _certificate(
    grid: torch.Tensor, it: int, resid: float, eps: float
) -> XTSolution:
    dev = grid.device
    r = torch.tensor(resid, dtype=grid.dtype, device=dev)
    return XTSolution(
        grid, r, torch.tensor(it, dtype=torch.int32, device=dev), r <= _f32(eps)
    )


def _reducer(group: Any) -> Callable[..., Tuple[torch.Tensor, ...]]:
    """``psum`` over a process group: its tensors summed over the group's
    ranks in one collective (returned as they are for ``group=None``)."""
    if group is None:
        return lambda *ts: ts
    from ..parallel.collectives import all_reduce_sum

    return lambda *ts: tuple(all_reduce_sum(ts, group))


def _check_groups(group_id: Optional[torch.Tensor], n_groups: Optional[int]) -> None:
    if (group_id is None) != (n_groups is None):
        raise ValueError('group_id and n_groups must be passed together')


def xt_counts(
    type_id: torch.Tensor,
    result_id: torch.Tensor,
    start_x: torch.Tensor,
    start_y: torch.Tensor,
    end_x: torch.Tensor,
    end_y: torch.Tensor,
    mask: torch.Tensor,
    *,
    l: int,
    w: int,
    group_id: Optional[torch.Tensor] = None,
    n_groups: Optional[int] = None,
    group: Any = None,
) -> XTCounts:
    """All xT count matrices in one pass over a flat action stream.

    Inputs are ``(G, A)`` batch fields (or any shape, flattened alike);
    rows with ``mask == False`` contribute nothing. With ``group_id`` (a
    per-action id in ``[0, n_groups)``, given with ``n_groups``) every
    field comes out stacked: ``(G, w*l)`` vectors and a
    ``(G, w*l, w*l)`` transition stack, each from one segment sum over
    ``group * w*l + cell``. Out-of-range group ids (``-1``) add nothing.
    Every count is one :func:`~.segment.segment_sum` (kernel B2 on the card).
    With ``group`` (a process group whose ranks each hold a game shard)
    the four counts are summed over its ranks in one all-reduce.
    """
    _check_groups(group_id, n_groups)
    reduce = _reducer(group)
    s = _action_stream(type_id, result_id, start_x, start_y, end_x, end_y, mask, l, w)
    n_cells = w * l
    f32 = torch.float32
    pair = s.start_flat * n_cells + s.end_flat

    if group_id is not None:
        g = group_id.reshape(-1).to(torch.int32)
        shots = segment_sum_2d(s.is_shot.to(f32), g, s.start_flat, n_groups, n_cells)
        goals = segment_sum_2d(s.is_goal.to(f32), g, s.start_flat, n_groups, n_cells)
        moves = segment_sum_2d(s.is_move.to(f32), g, s.start_flat, n_groups, n_cells)
        trans = segment_sum_2d(
            s.is_success_move.to(f32), g, pair, n_groups, n_cells * n_cells
        ).reshape(n_groups, n_cells, n_cells)
        return XTCounts(*reduce(shots, goals, moves, trans))

    shots = segment_sum(s.is_shot.to(f32), s.start_flat, n_cells)
    goals = segment_sum(s.is_goal.to(f32), s.start_flat, n_cells)
    moves = segment_sum(s.is_move.to(f32), s.start_flat, n_cells)
    trans = segment_sum(s.is_success_move.to(f32), pair, n_cells * n_cells)
    return XTCounts(*reduce(shots, goals, moves, trans.reshape(n_cells, n_cells)))


class XTProbabilities(NamedTuple):
    """The four probability matrices of the xT Markov model.

    Stacked (grouped) probabilities carry a leading ``(G,)`` axis. On the
    matrix-free path ``transition`` is ``None``: the dense matrix is never
    built.
    """

    p_score: torch.Tensor  # (w, l) P(goal | shot from cell)
    p_shot: torch.Tensor  # (w, l) P(choose shot | in cell)
    p_move: torch.Tensor  # (w, l) P(choose move | in cell)
    transition: Optional[torch.Tensor]  # (w*l, w*l) P(successful move start -> end)


def xt_probabilities(counts: XTCounts, *, l: int, w: int) -> XTProbabilities:
    """Turn counts (optionally stacked) into the model's probabilities."""
    p_score, p_shot, p_move = _cell_probabilities(
        counts.shots, counts.goals, counts.moves, l, w
    )
    transition = _safe_divide(counts.trans, counts.moves[..., :, None])
    return XTProbabilities(p_score=p_score, p_shot=p_shot, p_move=p_move, transition=transition)


def _solve_xt_cost(probs: 'XTProbabilities', *args: Any, **kwargs: Any) -> Tuple[float, float]:
    """``(flops, bytes)`` of one sweep of the dense solve (XLA's cost
    analysis, which the JAX package's roofline reads, counts a loop body
    once too): each grid's ``(n, n)`` transition matrix and its three
    probability planes read, the surface read and written; ``2·n²`` plus
    three operations a cell."""
    n = probs.p_shot.shape[-1] * probs.p_shot.shape[-2]
    grids = probs.p_shot.numel() // n
    return float(grids * (2 * n * n + 3 * n)), float(4 * grids * (n * n + 5 * n))


@functools.partial(instrument, name='solve_xt', cost=_solve_xt_cost)
@_full_f32()
def solve_xt(
    probs: XTProbabilities,
    eps: float = 1e-5,
    max_iter: int = 1000,
    *,
    solver: Optional[str] = None,
    accelerate: bool = False,
) -> XTSolution:
    """Run the dense xT value iteration to convergence.

    One sweep is one mat-vec, ``xT <- p_shot * p_score + p_move *
    reshape(T @ vec(xT))`` (a library product: the JAX package leaves it
    to XLA too). ``solver`` picks the variant (:data:`SOLVERS`, default
    Picard); ``accelerate`` is a deprecated alias of ``'anderson'``. A
    stacked ``(G, w, l)`` probability set is solved as one fleet with
    per-grid convergence masking.
    """
    solver = _resolve_solver(solver, accelerate)
    gs = probs.p_score * probs.p_shot
    T = probs.transition

    if probs.p_shot.dim() == 3:
        G, w, l = probs.p_shot.shape

        def sweep(xT: torch.Tensor) -> torch.Tensor:
            payoff = torch.einsum('gij,gj->gi', T, xT.reshape(G, -1))
            return gs + probs.p_move * payoff.reshape(G, w, l)

        xT, it, resid = _batched_value_iteration(sweep, gs, eps, max_iter, solver)
        return XTSolution(xT, resid, it, resid <= _f32(eps))

    w, l = probs.p_shot.shape

    def sweep(xT: torch.Tensor) -> torch.Tensor:
        payoff = (T @ xT.reshape(-1)).reshape(w, l)
        return gs + probs.p_move * payoff

    xT, it, resid = _SINGLE_GRID_LOOPS[solver](sweep, gs, eps, max_iter)
    return _certificate(xT, it, resid, eps)


def _solve_matrix_free_cost(type_id: torch.Tensor, *args: Any, l: int, w: int, **kwargs: Any) -> Tuple[float, float]:
    """``(flops, bytes)`` of the counting pass and one sweep of the
    matrix-free solve (a loop body counted once, as XLA counts it): the
    seven batch fields read, three segment sums of the action stream
    (:func:`~.segment.segment_sum_cost`), then one sweep's gather
    (int64 index and f32 weight and value per action) and segment sum,
    and the surface's planes."""
    n = type_id.numel()
    cells = l * w * (kwargs.get('n_groups') or 1)
    seg_flops, seg_bytes = segment_sum_cost(n, cells)
    flops = 4 * seg_flops + 2 * n + 3 * cells
    nbytes = n * (4 * 4 + 4 + 4 + 1) + 4 * seg_bytes + n * 16 + 5 * 4 * cells
    return float(flops), float(nbytes)


@functools.partial(instrument, name='solve_xt_matrix_free', cost=_solve_matrix_free_cost)
@_full_f32()
def solve_xt_matrix_free(
    type_id: torch.Tensor,
    result_id: torch.Tensor,
    start_x: torch.Tensor,
    start_y: torch.Tensor,
    end_x: torch.Tensor,
    end_y: torch.Tensor,
    mask: torch.Tensor,
    *,
    l: int,
    w: int,
    eps: float = 1e-5,
    max_iter: int = 1000,
    solver: Optional[str] = None,
    accelerate: bool = False,
    group_id: Optional[torch.Tensor] = None,
    n_groups: Optional[int] = None,
    group: Any = None,
) -> Tuple[XTSolution, XTProbabilities]:
    """Value iteration without materializing the transition matrix.

    The sweep ``payoff[i] = Σ_j T[i, j] · xT[j]`` with
    ``T[i, j] = C[i, j] / starts[i]`` is summed over the successful-move
    action stream instead: one gather of ``xT`` at each move's end cell,
    weighted by ``1 / starts[start cell]``, and one segment sum by start
    cell (kernel B2 on the card). ``O(actions)`` work and ``O(w·l)``
    memory per sweep. The counts are three more segment sums, so an
    ungrouped Picard solve launches B2 ``3 + iterations`` times.

    With ``group_id``/``n_groups`` the fleet is counted with one
    :func:`~.segment.segment_sum_2d` per vector, every action gathers from
    its own group's surface, each sweep is one ``G·w·l``-segment sum, and
    the ``(G, w, l)`` grids are solved in one loop with per-grid masking.

    With ``group`` (a process group whose ranks each hold a game shard of
    the batch) the counts and every sweep's payoff are summed over its
    ranks, so every rank iterates the surface of the whole batch and stops
    at the same sweep: one all-reduce for the counts and one a sweep,
    each after the rank's own segment sums.

    Returns ``(XTSolution, XTProbabilities)`` with ``transition=None``.
    """
    solver = _resolve_solver(solver, accelerate)
    _check_groups(group_id, n_groups)
    reduce = _reducer(group)
    s = _action_stream(type_id, result_id, start_x, start_y, end_x, end_y, mask, l, w)
    n_cells = w * l
    f32 = torch.float32

    if group_id is not None:
        G = n_groups
        g = group_id.reshape(-1).to(torch.int32)
        g_ok = (g >= 0) & (g < G)
        g_safe = g.clamp(0, G - 1)

        shots, goals, moves = reduce(
            segment_sum_2d(s.is_shot.to(f32), g, s.start_flat, G, n_cells),
            segment_sum_2d(s.is_goal.to(f32), g, s.start_flat, G, n_cells),
            segment_sum_2d(s.is_move.to(f32), g, s.start_flat, G, n_cells),
        )
        p_score, p_shot, p_move = _cell_probabilities(shots, goals, moves, l, w)

        # per-action weight against the action's own group's start counts
        start_idx = (g_safe * n_cells + s.start_flat).long()
        starts_at = moves.reshape(-1)[start_idx]
        wgt = torch.where(
            s.is_success_move & g_ok, 1.0 / starts_at.clamp_min(1.0), 0.0
        ).to(f32)
        end_idx = (g_safe * n_cells + s.end_flat).long()
        # the flat (group, start cell) segment of each action, as
        # segment_sum_2d forms it, built once for every sweep
        seg = torch.where(g_ok, g_safe * n_cells + s.start_flat, -1)
        gs = p_score * p_shot

        def sweep(xT: torch.Tensor) -> torch.Tensor:
            contrib = xT.reshape(-1)[end_idx] * wgt
            (payoff,) = reduce(segment_sum(contrib, seg, G * n_cells))
            return gs + p_move * payoff.reshape(G, w, l)

        xT, it, resid = _batched_value_iteration(sweep, gs, eps, max_iter, solver)
        sol = XTSolution(xT, resid, it, resid <= _f32(eps))
        return sol, XTProbabilities(p_score, p_shot, p_move, None)

    shots, goals, moves = reduce(
        segment_sum(s.is_shot.to(f32), s.start_flat, n_cells),
        segment_sum(s.is_goal.to(f32), s.start_flat, n_cells),
        segment_sum(s.is_move.to(f32), s.start_flat, n_cells),
    )
    p_score, p_shot, p_move = _cell_probabilities(shots, goals, moves, l, w)

    # 1/starts[start cell] for successful moves: every successful move is
    # itself counted in moves, so the masked denominator is at least 1
    starts_at = moves[s.start_flat.long()]
    wgt = torch.where(s.is_success_move, 1.0 / starts_at.clamp_min(1.0), 0.0).to(f32)
    end_idx = s.end_flat.long()
    gs = p_score * p_shot

    def sweep(xT: torch.Tensor) -> torch.Tensor:
        contrib = xT.reshape(-1)[end_idx] * wgt
        (payoff,) = reduce(segment_sum(contrib, s.start_flat, n_cells))
        return gs + p_move * payoff.reshape(w, l)

    xT, it, resid = _SINGLE_GRID_LOOPS[solver](sweep, gs, eps, max_iter)
    return _certificate(xT, it, resid, eps), XTProbabilities(p_score, p_shot, p_move, None)


def rate_actions(
    grid: torch.Tensor,
    type_id: torch.Tensor,
    result_id: torch.Tensor,
    start_x: torch.Tensor,
    start_y: torch.Tensor,
    end_x: torch.Tensor,
    end_y: torch.Tensor,
    mask: torch.Tensor,
    *,
    l: int,
    w: int,
    group_id: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """xT deltas ``grid[end cell] - grid[start cell]`` for successful moves; NaN elsewhere.

    A ``(G, w, l)`` surface stack needs a per-action ``group_id``: every
    action gathers from its own group's grid, and an out-of-range group
    id rates NaN.
    """
    rated = mask & _is_move(type_id) & (result_id == spadlconfig.SUCCESS)
    sxi, syj = cell_indexes(torch.nan_to_num(start_x), torch.nan_to_num(start_y), l, w)
    exi, eyj = cell_indexes(torch.nan_to_num(end_x), torch.nan_to_num(end_y), l, w)
    sxi, syj, exi, eyj = (t.long() for t in (sxi, syj, exi, eyj))
    if grid.dim() == 3:
        if group_id is None:
            raise ValueError('a (G, w, l) surface stack requires group_id')
        G = grid.shape[0]
        g = group_id.to(torch.int32)
        rated = rated & (g >= 0) & (g < G)
        g_safe = g.clamp(0, G - 1).long()
        xt_start = grid[g_safe, w - 1 - syj, sxi]
        xt_end = grid[g_safe, w - 1 - eyj, exi]
    else:
        xt_start = grid[w - 1 - syj, sxi]
        xt_end = grid[w - 1 - eyj, exi]
    return torch.where(rated, xt_end - xt_start, float('nan'))


def interpolate_grid(grid: torch.Tensor, l_out: int, w_out: int) -> torch.Tensor:
    """Bilinearly upsample a cell-centered ``(..., w, l)`` grid to ``(..., w_out, l_out)``.

    Sample points are ``linspace(0, field_length, l_out)`` by
    ``linspace(0, field_width, w_out)``, interpolated between cell centers;
    samples outside the cell-center hull are clamped to the edge centers
    (the reference's FITPACK-backed ``interp2d`` behavior). Leading axes
    pass through, so a fleet upsamples in the same gathers.
    """
    w, l = grid.shape[-2:]
    dt, dev = grid.dtype, grid.device
    cell_l = spadlconfig.field_length / l
    cell_w = spadlconfig.field_width / w
    xs = torch.linspace(0.0, spadlconfig.field_length, l_out, dtype=dt, device=dev)
    ys = torch.linspace(0.0, spadlconfig.field_width, w_out, dtype=dt, device=dev)
    # divide by 0-dim tensors, not host scalars (see cell_indexes)
    fx = (xs - 0.5 * cell_l) / _scalar(cell_l, xs)
    fy = (ys - 0.5 * cell_w) / _scalar(cell_w, ys)

    def sample_axis(f: torch.Tensor, n: int) -> Tuple[torch.Tensor, torch.Tensor]:
        i0 = torch.floor(f).to(torch.int64).clamp(0, n - 2)
        return i0, (f - i0).clamp(0.0, 1.0)

    ix, tx = sample_axis(fx, l)
    iy, ty = sample_axis(fy, w)
    # grid row 0 is the top of the pitch: row index = w - 1 - y-cell
    r0 = (w - 1 - iy)[:, None]
    r1 = (w - 2 - iy)[:, None]
    c0 = ix[None, :]
    g00 = grid[..., r0, c0]
    g01 = grid[..., r0, c0 + 1]
    g10 = grid[..., r1, c0]
    g11 = grid[..., r1, c0 + 1]
    ty_ = ty[:, None]
    tx_ = tx[None, :]
    top = g00 * (1 - tx_) + g01 * tx_
    bot = g10 * (1 - tx_) + g11 * tx_
    fine = top * (1 - ty_) + bot * ty_
    # back to the top-left-origin layout of the coarse grid
    return torch.flip(fine, dims=(-2,))
