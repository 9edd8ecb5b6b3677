"""Sharded xT training: per-shard counts and one all-reduce (port of
``socceraction_tpu/parallel/xt.py``).

The xT counts are plain sums over actions, so each rank segment-sums its
game shard (kernel B2 on the card) and one all-reduce over the
``'games'`` axis sums them; the small value iteration then runs the same
on every rank. The matrix-free solve all-reduces every sweep's payoff as
well, so every rank iterates the surface of the whole batch. Ranks that
differ only along ``'model'`` hold the same games and reduce with their
own ``'games'`` line.

Every rank calls these with the same global batch (or its shard from
:func:`~.mesh.shard_batch`); every result is replicated: each rank
returns the same grid, probabilities and iteration count.
"""

from __future__ import annotations

from typing import Any, Optional, Tuple

import torch

from ..ops.xt import XTCounts, XTProbabilities, solve_xt, solve_xt_matrix_free, xt_counts, xt_probabilities
from .mesh import axis_group, shard_batch, shard_games

__all__ = ['sharded_xt_counts', 'sharded_xt_fit', 'sharded_xt_fit_matrix_free']


def _xt_fields(b: Any) -> Tuple[torch.Tensor, ...]:
    return b.type_id, b.result_id, b.start_x, b.start_y, b.end_x, b.end_y, b.mask


def sharded_xt_counts(batch: Any, mesh: Any, *, l: int, w: int) -> XTCounts:
    """The xT counts of the whole batch, replicated on every rank: this
    rank's shard counted, then summed over ``'games'``."""
    local = shard_batch(batch, mesh)
    return xt_counts(*_xt_fields(local), l=l, w=w, group=axis_group(mesh, 'games'))


def sharded_xt_fit(
    batch: Any,
    mesh: Any,
    *,
    l: int = 16,
    w: int = 12,
    eps: float = 1e-5,
    max_iter: int = 1000,
    accelerate: bool = False,
    solver: Optional[str] = None,
) -> Tuple[torch.Tensor, XTProbabilities, torch.Tensor]:
    """Fit xT on a game-sharded batch: summed counts, then the dense solve
    on every rank -> ``(grid, probabilities, n_iterations)``, replicated.

    ``solver`` selects the value-iteration variant
    (:data:`~socceraction_tpu_torch.ops.xt.SOLVERS`; ``accelerate`` is the
    deprecated Anderson alias). Counts are integers and sum exactly, so
    the result is the single-device fit's.
    """
    counts = sharded_xt_counts(batch, mesh, l=l, w=w)
    probs = xt_probabilities(counts, l=l, w=w)
    sol = solve_xt(probs, eps=eps, max_iter=max_iter, solver=solver, accelerate=accelerate)
    return sol.grid, probs, sol.iterations


def sharded_xt_fit_matrix_free(
    batch: Any,
    mesh: Any,
    *,
    l: int,
    w: int,
    eps: float = 1e-5,
    max_iter: int = 1000,
    accelerate: bool = False,
    solver: Optional[str] = None,
    group_id: Optional[torch.Tensor] = None,
    n_groups: Optional[int] = None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Fine-grid sharded xT fit: per-shard segment sums, all-reduced sweeps.

    The matrix-free twin of :func:`sharded_xt_fit` for grids whose dense
    transition matrix is too large (192 x 125). Each rank segment-sums its
    shard; the counts and every sweep's payoff are summed over
    ``'games'`` (:func:`~socceraction_tpu_torch.ops.xt.solve_xt_matrix_free`
    with ``group=``), so every rank iterates the same surface.

    A per-action ``group_id`` laid out like the global batch (``(G, A)``,
    ``-1`` for no group) with ``n_groups`` solves a ``(n_groups, w, l)``
    fleet the same way; its padding games get ``-1``. Returns ``(grid,
    n_iterations)``, replicated (per grid for a fleet).
    """
    local = shard_batch(batch, mesh)
    gid = None if group_id is None else shard_games(group_id, mesh, fill=-1)
    sol, _ = solve_xt_matrix_free(
        *_xt_fields(local), l=l, w=w, eps=eps, max_iter=max_iter, accelerate=accelerate,
        solver=solver, group_id=gid, n_groups=n_groups, group=axis_group(mesh, 'games'),
    )
    return sol.grid, sol.iterations
