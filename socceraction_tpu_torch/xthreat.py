"""The Expected Threat (xT) model on PyTorch.

Port of ``socceraction_tpu/xthreat.py`` (``ExpectedThreat`` and
``load_model``) on the kernels of :mod:`socceraction_tpu_torch.ops.xt`.
xT values ball-progressing actions as the difference in long-term scoring
probability between an action's start and end cell of an ``l x w`` pitch
grid; the value surface solves a Markov possession model by value
iteration (Karun Singh, 2019).

Two backends, as in the JAX package:

- ``backend='torch'`` (default): the model runs on ``device`` (``cuda``
  unless the caller passes ``'cpu'``); ``fit`` takes the port's
  :class:`~.core.batch.ActionBatch` or a SPADL DataFrame, packs it and
  runs the kernels (segment-sum counts, the value iteration on the card);
- ``backend='pandas'``: the numpy oracle with the reference's semantics
  (``bincount`` scatters for its ``value_counts``, the value iteration as
  the mat-vec its quadruple loop computes, reference ``xthreat.py:306-312``),
  on SPADL DataFrames; it touches no device and needs none.

The module-level oracle functions (``scoring_prob``, ``action_prob``,
``move_transition_matrix``, ``get_move_actions``,
``get_successful_move_actions``) are the reference's. pandas is imported
only by code that takes frames. Fitted surfaces and probability matrices
are float64 numpy arrays, as in the JAX package, so a surface saved by
either package loads into the other.
"""

from __future__ import annotations

import json
import math
import os
import time
from typing import TYPE_CHECKING, Any, Callable, List, Optional, Sequence, Tuple, Union

import numpy as np
import torch

from .core.batch import ActionBatch, pack_actions, pack_row_values, unpack_values
from .device import DeviceLike, resolve_device
from .obs import gauge, histogram, span
from .obs.numerics import record_nonfinite
from .obs.perf import record_dispatch
from .obs.residency import claim_bytes
from .ops import xt as _xtops
from .spadl import config as spadlconfig

if TYPE_CHECKING:  # pandas is imported inside the functions that take frames
    import pandas as pd

__all__ = [
    'ExpectedThreat', 'NotFittedError', 'VARIANTS', 'action_prob', 'get_move_actions',
    'get_successful_move_actions', 'load_model', 'move_transition_matrix', 'scoring_prob',
]


class NotFittedError(ValueError):
    """Raised when ``rate``/``save_model`` is called before ``fit``."""


M: int = 12
N: int = 16

Actions = Union['pd.DataFrame', ActionBatch]

#: ``group_by`` spec: a frame column name or a per-action key array.
GroupBy = Union[str, Sequence[Any], np.ndarray]

#: Value-iteration variants accepted by ``ExpectedThreat(variant=)``.
VARIANTS = _xtops.SOLVERS


def _get_cell_indexes(
    x: np.ndarray, y: np.ndarray, l: int = N, w: int = M
) -> Tuple[np.ndarray, np.ndarray]:
    """Bin coordinates in float64 on the host: truncate toward zero, clip."""
    xi = np.asarray(x, dtype=np.float64) / spadlconfig.field_length * l
    yj = np.asarray(y, dtype=np.float64) / spadlconfig.field_width * w
    xi = np.clip(xi.astype(np.int64), 0, l - 1)
    yj = np.clip(yj.astype(np.int64), 0, w - 1)
    return xi, yj


def _get_flat_indexes(x: np.ndarray, y: np.ndarray, l: int = N, w: int = M) -> np.ndarray:
    xi, yj = _get_cell_indexes(x, y, l, w)
    return (w - 1 - yj) * l + xi


def _count(x: np.ndarray, y: np.ndarray, l: int = N, w: int = M) -> np.ndarray:
    """Actions per grid cell, as a ``(w, l)`` matrix with its origin at the
    top left; rows with a NaN coordinate are left out."""
    x = np.asarray(x, dtype=np.float64)
    y = np.asarray(y, dtype=np.float64)
    ok = ~np.isnan(x) & ~np.isnan(y)
    flat = _get_flat_indexes(x[ok], y[ok], l, w)
    return np.bincount(flat, minlength=w * l).astype(np.float64).reshape(w, l)


def _safe_divide(a: np.ndarray, b: np.ndarray) -> np.ndarray:
    return np.divide(a, b, out=np.zeros_like(a, dtype=np.float64), where=b != 0)


def scoring_prob(actions: 'pd.DataFrame', l: int = N, w: int = M) -> np.ndarray:
    """P(goal | shot from cell) for each grid cell."""
    shots = actions[actions['type_id'] == spadlconfig.SHOT]
    goals = shots[shots['result_id'] == spadlconfig.SUCCESS]
    shotmatrix = _count(shots['start_x'].to_numpy(), shots['start_y'].to_numpy(), l, w)
    goalmatrix = _count(goals['start_x'].to_numpy(), goals['start_y'].to_numpy(), l, w)
    return _safe_divide(goalmatrix, shotmatrix)


def get_move_actions(actions: 'pd.DataFrame') -> 'pd.DataFrame':
    """All ball-progressing actions: passes, dribbles and crosses."""
    t = actions['type_id']
    return actions[
        (t == spadlconfig.PASS) | (t == spadlconfig.DRIBBLE) | (t == spadlconfig.CROSS)
    ]


def get_successful_move_actions(actions: 'pd.DataFrame') -> 'pd.DataFrame':
    """All successful ball-progressing actions."""
    moves = get_move_actions(actions)
    return moves[moves['result_id'] == spadlconfig.SUCCESS]


def action_prob(
    actions: 'pd.DataFrame', l: int = N, w: int = M
) -> Tuple[np.ndarray, np.ndarray]:
    """P(choose shot) and P(choose move) for each grid cell."""
    moves = get_move_actions(actions)
    shots = actions[actions['type_id'] == spadlconfig.SHOT]
    movematrix = _count(moves['start_x'].to_numpy(), moves['start_y'].to_numpy(), l, w)
    shotmatrix = _count(shots['start_x'].to_numpy(), shots['start_y'].to_numpy(), l, w)
    total = movematrix + shotmatrix
    return _safe_divide(shotmatrix, total), _safe_divide(movematrix, total)


def _successful_move_pairs(
    actions: 'pd.DataFrame', l: int, w: int
) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """``(start_counts, pair_start, pair_end)`` of the move stream.

    ``start_counts`` counts every move with a valid start, successful or
    not (reference ``xthreat.py:206-216``); the pairs are the flat start
    and end cells of the successful moves with valid end points. Moves
    with NaN coordinates are left out, as ``_count`` leaves them out.
    Shared by the dense transition matrix and the matrix-free sweeps.
    """
    moves = get_move_actions(actions)
    sx = moves['start_x'].to_numpy(dtype=np.float64)
    sy = moves['start_y'].to_numpy(dtype=np.float64)
    ex = moves['end_x'].to_numpy(dtype=np.float64)
    ey = moves['end_y'].to_numpy(dtype=np.float64)
    start_ok = ~np.isnan(sx) & ~np.isnan(sy)
    end_ok = start_ok & ~np.isnan(ex) & ~np.isnan(ey)
    success = (moves['result_id'] == spadlconfig.SUCCESS).to_numpy() & end_ok

    start = _get_flat_indexes(sx[start_ok], sy[start_ok], l, w)
    start_counts = np.bincount(start, minlength=w * l).astype(np.float64)
    pair_start = _get_flat_indexes(sx[success], sy[success], l, w)
    pair_end = _get_flat_indexes(ex[success], ey[success], l, w)
    return start_counts, pair_start, pair_end


def move_transition_matrix(actions: 'pd.DataFrame', l: int = N, w: int = M) -> np.ndarray:
    """P(successful move from cell i ends in cell j), normalized by the
    count of *all* moves started in cell i (reference ``xthreat.py:206-216``)."""
    n_cells = w * l
    start_counts, pair_start, pair_end = _successful_move_pairs(actions, l, w)
    pair = pair_start * n_cells + pair_end
    counts = np.bincount(pair, minlength=n_cells * n_cells).reshape(n_cells, n_cells)
    return _safe_divide(counts.astype(np.float64), start_counts[:, None])


def _preview_keys(keys: Any, limit: int = 8) -> str:
    """A bounded, readable preview of a grouped fit's key set for errors."""
    items = list(keys)
    shown = ', '.join(repr(k) for k in items[:limit])
    if len(items) > limit:
        shown += f', ... ({len(items) - limit} more)'
    return f'[{shown}]'


def _resolve_variant(
    variant: Optional[str], accelerate: bool, backend: str, keep_heatmaps: bool
) -> str:
    """Validate and normalize the solver variant (``__init__`` and ``fit``)."""
    if variant == 'plain':
        variant = 'picard'
    if variant is None:
        variant = 'anderson' if accelerate else 'picard'
    elif variant not in VARIANTS:
        raise ValueError(f'unknown variant {variant!r} (want one of {VARIANTS})')
    elif accelerate and variant != 'anderson':
        raise ValueError(
            "accelerate=True is a deprecated alias of variant='anderson' "
            f'and conflicts with variant={variant!r}'
        )
    if variant == 'picard':
        return variant
    if backend != 'torch':
        raise ValueError(
            f'variant={variant!r} (accelerated value iteration) is a device-backend '
            "feature; the pandas backend keeps the reference's plain iteration"
        )
    if keep_heatmaps:
        raise ValueError(
            'keep_heatmaps records the plain Picard iterate sequence; '
            f'{variant} iterates are a different (non-monotone) sequence'
        )
    return variant


def _pow2_bucket(n: int) -> int:
    """Round a grid count up to a power of two (the ``n_grids`` metric
    label stays cardinality-bounded at ``log2(max fleet size)`` values)."""
    return 1 << max(n - 1, 0).bit_length()


def _host(t: torch.Tensor) -> np.ndarray:
    return t.detach().cpu().numpy().astype(np.float64)


class ExpectedThreat:
    """The Expected Threat model.

    Parameters
    ----------
    l, w : int
        Grid cells along the pitch length (x) and width (y). Default 16 x 12.
    eps : float
        Convergence threshold of the value iteration. Default 1e-5.
    backend : {'torch', 'pandas'}
        ``'torch'`` (default) fits and rates with the kernels on
        ``device``; ``'pandas'`` is the numpy oracle on SPADL DataFrames,
        which needs no device (``device`` must be left unset).
    max_iter : int
        Cap on value-iteration sweeps. Default 1000.
    keep_heatmaps : bool
        Store the value surface after every sweep in ``self.heatmaps``
        (host-stepped Picard on the dense path; leave False for large grids).
    solver : {'dense', 'matrix-free'}, optional
        ``'dense'`` builds the ``(w*l, w*l)`` transition matrix and sweeps
        with a mat-vec; ``'matrix-free'`` sweeps with a gather + segment
        sum over the successful-move stream. Default: dense up to
        :attr:`DENSE_CELL_LIMIT` cells (the fleet size folded in), else
        matrix-free.
    accelerate : bool
        Deprecated alias of ``variant='anderson'``.
    variant : {'picard', 'anderson', 'anchored', 'momentum'}, optional
        Value-iteration schedule (``'plain'`` aliases ``'picard'``, the
        default). All share the fixed point and the certificate
        (``solve_residual``, ``converged``, ``n_iter``).
    device
        Where the ``'torch'`` backend fits and rates: ``cuda`` (default)
        or ``'cpu'``.
    """

    #: Cell count above which the auto solver goes matrix-free.
    DENSE_CELL_LIMIT = 4096

    def __init__(
        self,
        l: int = N,
        w: int = M,
        eps: float = 1e-5,
        backend: str = 'torch',
        max_iter: int = 1000,
        keep_heatmaps: bool = False,
        solver: Optional[str] = None,
        accelerate: bool = False,
        variant: Optional[str] = None,
        *,
        device: DeviceLike = None,
    ) -> None:
        if backend not in ('torch', 'pandas'):
            raise ValueError(f'unknown backend {backend!r}')
        if solver is not None and solver not in ('dense', 'matrix-free'):
            raise ValueError(f'unknown solver {solver!r}')
        _resolve_variant(variant, accelerate, backend, keep_heatmaps)
        if backend == 'pandas' and device is not None:
            raise ValueError("backend='pandas' runs on the host; leave device unset")
        # the oracle touches no device: only the device backend resolves one
        self.device = resolve_device(device) if backend == 'torch' else None
        self.backend = backend
        self.l = l
        self.w = w
        self.eps = eps
        self.max_iter = max_iter
        self.keep_heatmaps = keep_heatmaps
        self._solver = solver
        self.accelerate = accelerate
        self.variant = variant
        self.n_iter: int = 0
        #: Residual the solver last tested (the worst grid's for a fleet),
        #: ``None`` before fitting.
        self.solve_residual: Optional[float] = None
        #: Whether the last fit met ``eps`` (every grid, for a fleet).
        self.converged: Optional[bool] = None
        self.heatmaps: List[np.ndarray] = []
        self.xT: np.ndarray = np.zeros((w, l))
        self.scoring_prob_matrix: Optional[np.ndarray] = None
        self.shot_prob_matrix: Optional[np.ndarray] = None
        self.move_prob_matrix: Optional[np.ndarray] = None
        self.transition_matrix: Optional[np.ndarray] = None
        # grouped-fit state (fit(..., group_by=)); None on single-grid fits
        self.grids_: Optional[np.ndarray] = None
        self.group_keys_: Optional[np.ndarray] = None
        self.group_by_: Optional[str] = None
        self.n_iter_per_grid_: Optional[np.ndarray] = None
        self.solve_residual_per_grid_: Optional[np.ndarray] = None
        self.converged_per_grid_: Optional[np.ndarray] = None
        self.scoring_prob_matrices_: Optional[np.ndarray] = None
        self.shot_prob_matrices_: Optional[np.ndarray] = None
        self.move_prob_matrices_: Optional[np.ndarray] = None
        self.transition_matrices_: Optional[np.ndarray] = None

    @property
    def solver(self) -> str:
        """Active solver: as requested, else auto by the current grid size."""
        return self._effective_solver(1)

    def _effective_solver(self, n_grids: int) -> str:
        """Auto solver with the fleet size folded in: dense while the
        ``(G, w·l, w·l)`` transition stack has at most
        ``DENSE_CELL_LIMIT²`` entries."""
        if self._solver is not None:
            return self._solver
        n_cells = self.w * self.l
        dense_ok = n_grids * n_cells * n_cells <= self.DENSE_CELL_LIMIT ** 2
        return 'dense' if dense_ok else 'matrix-free'

    # -- fitting -----------------------------------------------------------

    def _value_iteration(self, sweep: Callable[[np.ndarray], np.ndarray]) -> None:
        """Host Picard sweeps ``xT <- sweep(xT)`` in float64 until no cell
        moves by more than ``eps``, keeping every surface with
        ``keep_heatmaps``."""
        xT = np.zeros((self.w, self.l))
        if self.keep_heatmaps:
            self.heatmaps.append(xT.copy())
        it = 0
        resid = None
        while it < self.max_iter:
            new = sweep(xT)
            diff = new - xT
            xT = new
            it += 1
            resid = float(np.max(diff))
            if self.keep_heatmaps:
                self.heatmaps.append(xT.copy())
            if not np.any(diff > self.eps):
                break
        self.xT = xT
        self.n_iter = it
        self.solve_residual = resid
        self.converged = resid is not None and resid <= self.eps

    def _solve_numpy(self) -> None:
        """The value iteration over the fitted probability matrices, one
        dense mat-vec a sweep (the oracle's dense solver)."""
        gs = self.scoring_prob_matrix * self.shot_prob_matrix
        T = self.transition_matrix

        def sweep(xT: np.ndarray) -> np.ndarray:
            payoff = (T @ xT.reshape(-1)).reshape(self.w, self.l)
            return gs + self.move_prob_matrix * payoff

        self._value_iteration(sweep)

    def _solve_numpy_matrix_free(self, actions: 'pd.DataFrame') -> None:
        """The value iteration with a gather and a weighted ``bincount``
        over the successful moves a sweep, without the dense matrix."""
        n_cells = self.w * self.l
        start_counts, pair_start, pair_end = _successful_move_pairs(actions, self.l, self.w)
        # every successful move counts in start_counts: the denominator is >= 1
        wgt = 1.0 / start_counts[pair_start]
        gs = self.scoring_prob_matrix * self.shot_prob_matrix

        def sweep(xT: np.ndarray) -> np.ndarray:
            payoff = np.bincount(
                pair_start, weights=xT.reshape(-1)[pair_end] * wgt, minlength=n_cells
            )
            return gs + self.move_prob_matrix * payoff.reshape(self.w, self.l)

        self._value_iteration(sweep)

    def _fit_pandas(self, actions: 'pd.DataFrame') -> None:
        """The numpy oracle's fit of one surface from a SPADL frame."""
        self.scoring_prob_matrix = scoring_prob(actions, self.l, self.w)
        self.shot_prob_matrix, self.move_prob_matrix = action_prob(actions, self.l, self.w)
        if self.solver == 'matrix-free':
            self.transition_matrix = None
            self._solve_numpy_matrix_free(actions)
        else:
            self.transition_matrix = move_transition_matrix(actions, self.l, self.w)
            self._solve_numpy()

    def _take_solution(self, sol: _xtops.XTSolution) -> None:
        """Adopt a single-grid solution."""
        self.xT = _host(sol.grid)
        self.n_iter = int(sol.iterations)
        r = float(sol.residual)
        self.solve_residual = r if math.isfinite(r) else None
        self.converged = bool(sol.converged)
        # numeric guard on the certificate the fit already brought to the
        # host: a non-finite surface or residual counts into num/*
        record_nonfinite('solve_xt', 'grid', int(np.sum(~np.isfinite(self.xT))))
        record_nonfinite('solve_xt', 'residual', int(not math.isfinite(r)))

    def _take_probabilities(self, probs: _xtops.XTProbabilities) -> None:
        self.scoring_prob_matrix = _host(probs.p_score)
        self.shot_prob_matrix = _host(probs.p_shot)
        self.move_prob_matrix = _host(probs.p_move)
        self.transition_matrix = (
            None if probs.transition is None else _host(probs.transition)
        )

    @staticmethod
    def _fields(batch: ActionBatch) -> Tuple[torch.Tensor, ...]:
        return (
            batch.type_id, batch.result_id,
            batch.start_x, batch.start_y, batch.end_x, batch.end_y,
            batch.mask,
        )

    def _fit_torch(self, batch: ActionBatch, variant: str) -> None:
        fields = self._fields(batch)
        if self.solver == 'matrix-free':
            if self.keep_heatmaps:
                raise ValueError("keep_heatmaps requires solver='dense'")
            sol, probs = _xtops.solve_xt_matrix_free(
                *fields, l=self.l, w=self.w, eps=self.eps,
                max_iter=self.max_iter, solver=variant,
            )
            self._take_probabilities(probs)
            self._take_solution(sol)
            return
        counts = _xtops.xt_counts(*fields, l=self.l, w=self.w)
        probs = _xtops.xt_probabilities(counts, l=self.l, w=self.w)
        self._take_probabilities(probs)
        if self.keep_heatmaps:
            self._solve_numpy()
        else:
            self._take_solution(
                _xtops.solve_xt(probs, eps=self.eps, max_iter=self.max_iter, solver=variant)
            )

    def _group_codes(self, actions: 'pd.DataFrame', group_by: Any) -> Tuple[np.ndarray, np.ndarray]:
        """``(codes, keys)``: per-row int codes into the sorted unique key
        array (``-1`` for null keys)."""
        import pandas as pd

        if isinstance(group_by, str):
            if group_by not in actions.columns:
                raise ValueError(f'group_by column {group_by!r} not in actions')
            values = actions[group_by]
        else:
            values = np.asarray(group_by)
            if len(values) != len(actions):
                raise ValueError(
                    f'group_by array has {len(values)} entries for '
                    f'{len(actions)} actions'
                )
        codes, keys = pd.factorize(values, sort=True)
        return codes.astype(np.int32), np.asarray(keys)

    def _fit_torch_grouped(
        self,
        actions: 'pd.DataFrame',
        codes: np.ndarray,
        keys: np.ndarray,
        group_by: Any,
        variant: str,
    ) -> None:
        """One solve for the whole keyed surface fleet (see ``fit``)."""
        if self.keep_heatmaps:
            raise ValueError(
                'keep_heatmaps records one plain Picard iterate sequence; '
                'a grouped fit solves a whole fleet of grids at once'
            )
        batch = self._as_batch(actions)
        group_id = torch.from_numpy(pack_row_values(codes, batch, fill=-1)).to(self.device)
        G = len(keys)
        fields = self._fields(batch)
        if self._effective_solver(G) == 'matrix-free':
            sol, probs = _xtops.solve_xt_matrix_free(
                *fields, l=self.l, w=self.w, eps=self.eps,
                max_iter=self.max_iter, solver=variant,
                group_id=group_id, n_groups=G,
            )
        else:
            counts = _xtops.xt_counts(
                *fields, l=self.l, w=self.w, group_id=group_id, n_groups=G
            )
            probs = _xtops.xt_probabilities(counts, l=self.l, w=self.w)
            sol = _xtops.solve_xt(probs, eps=self.eps, max_iter=self.max_iter, solver=variant)
        # the fleet's device stacks (grids, probability planes and, dense,
        # the transition stack) are the xT layer's footprint while the fit
        # brings them to the host: claimed under `xt_fleet` for that window
        claim = claim_bytes('xt_fleet', (probs, sol.grid))
        try:
            self._adopt_fleet(sol, probs, keys, group_by)
        finally:
            claim.release()

    def _adopt_fleet(
        self,
        sol: _xtops.XTSolution,
        probs: _xtops.XTProbabilities,
        keys: np.ndarray,
        group_by: Any,
    ) -> None:
        """Turn one fleet solve's device stacks into host model state.

        The single-grid slots (``xT`` zeroed, the ``*_matrix`` slots
        ``None``) keep their 2-D contract, so a consumer of one surface
        fails loudly instead of reading a stack.
        """
        self.transition_matrices_ = (
            None if probs.transition is None else _host(probs.transition)
        )
        self.scoring_prob_matrix = None
        self.shot_prob_matrix = None
        self.move_prob_matrix = None
        self.transition_matrix = None
        self.scoring_prob_matrices_ = _host(probs.p_score)
        self.shot_prob_matrices_ = _host(probs.p_shot)
        self.move_prob_matrices_ = _host(probs.p_move)
        self.grids_ = _host(sol.grid)
        self.group_keys_ = keys
        self.group_by_ = group_by if isinstance(group_by, str) else None
        self.n_iter_per_grid_ = sol.iterations.cpu().numpy()
        self.solve_residual_per_grid_ = _host(sol.residual)
        self.converged_per_grid_ = sol.converged.cpu().numpy()
        self.n_iter = int(self.n_iter_per_grid_.max())
        worst = float(self.solve_residual_per_grid_.max())
        self.solve_residual = worst if math.isfinite(worst) else None
        self.converged = bool(self.converged_per_grid_.all())
        # fleet-wide numeric guard over the host certificate arrays
        record_nonfinite('solve_xt', 'grid', int(np.sum(~np.isfinite(self.grids_))))
        record_nonfinite(
            'solve_xt', 'residual', int(np.sum(~np.isfinite(self.solve_residual_per_grid_)))
        )
        self.xT = np.zeros((self.w, self.l))

    def _as_batch(self, actions: Actions) -> ActionBatch:
        """The model's device batch of ``actions`` (a batch or a frame)."""
        if isinstance(actions, ActionBatch):
            return actions if actions.device == self.device else actions.to(self.device)
        df = actions
        if 'game_id' not in df.columns:
            df = df.assign(game_id=0)
        # xT reads type, result and coordinates only: fill the other packed
        # columns a minimal frame omits
        defaults = {
            'team_id': 0,
            'period_id': 1,
            'time_seconds': 0.0,
            'bodypart_id': 0,
            'result_id': 0,
        }
        missing = {c: v for c, v in defaults.items() if c not in df.columns}
        if missing:
            df = df.assign(**missing)
        # xT is team-agnostic: any home side will do
        batch, _ = pack_actions(
            df, home_team_ids={g: None for g in df['game_id'].unique()}, device=self.device
        )
        return batch

    def fit(self, actions: Actions, *, group_by: Optional[GroupBy] = None) -> 'ExpectedThreat':
        """Fit the model on SPADL actions (an ``ActionBatch`` or a DataFrame).

        ``group_by`` (a DataFrame's column name, or a per-action key array
        aligned with its rows) fits one surface per group in one fleet
        solve, populating ``grids_``, ``group_keys_`` and the per-grid
        certificate vectors; ``rate`` then reads each action from its own
        group's surface.
        """
        variant = _resolve_variant(self.variant, self.accelerate, self.backend, self.keep_heatmaps)
        if self.backend == 'pandas' and isinstance(actions, ActionBatch):
            raise TypeError("backend='pandas' fits SPADL DataFrames, not packed batches")
        if group_by is not None:
            if self.backend != 'torch':
                raise ValueError('group_by (batched surface fleets) is a device-backend feature')
            if isinstance(actions, ActionBatch):
                raise ValueError(
                    'group_by requires a DataFrame (group keys live in frame columns)'
                )
            codes, keys = self._group_codes(actions, group_by)
            n_grids = len(keys)
            if n_grids == 0:
                raise ValueError('group_by produced no groups (all keys null?)')
        else:
            codes = keys = None
            n_grids = 1
        labels = {
            'grid': f'{self.l}x{self.w}',
            'solver': self._effective_solver(n_grids),
            'variant': variant,
            'backend': self.backend,
            'n_grids': str(_pow2_bucket(n_grids)),
        }
        t0 = time.perf_counter()
        with span('xt/fit', **labels):
            if group_by is not None:
                self._fit_torch_grouped(actions, codes, keys, group_by, variant)
            else:
                # a refit without group_by drops any previous fleet state
                self.grids_ = None
                self.group_keys_ = None
                self.group_by_ = None
                self.n_iter_per_grid_ = None
                self.solve_residual_per_grid_ = None
                self.converged_per_grid_ = None
                self.scoring_prob_matrices_ = None
                self.shot_prob_matrices_ = None
                self.move_prob_matrices_ = None
                self.transition_matrices_ = None
                if self.backend == 'torch':
                    self._fit_torch(self._as_batch(actions), variant)
                else:
                    self._fit_pandas(actions)
        solve_s = time.perf_counter() - t0
        if self.backend == 'torch' and not self.keep_heatmaps:
            # live-roofline feed: the fit wall is host-synced (the
            # certificate fetch waits for the solve), and the fn name is
            # the instrumented solver's, so the cost lookup finds its books
            fn = 'solve_xt' if labels['solver'] == 'dense' else 'solve_xt_matrix_free'
            record_dispatch(fn, solve_s, bucket=_pow2_bucket(n_grids))
        # the grid is user-controlled (any l×w): past-budget label sets
        # collapse into the reserved overflow series instead of raising
        histogram('xt/solve_iterations', unit='iterations', on_overflow='overflow').observe(
            self.n_iter, **labels
        )
        histogram('xt/solve_seconds', unit='s', on_overflow='overflow').observe(solve_s, **labels)
        if self.solve_residual is not None:
            gauge('xt/solve_residual', unit='value', on_overflow='overflow').set(
                self.solve_residual, **labels
            )
        return self

    # -- inference ---------------------------------------------------------

    def _fine(self, grids: np.ndarray) -> Tuple[np.ndarray, int, int]:
        """``grids`` upsampled to the 10 cm rating grid of the reference:
        on the device, or in numpy on the pandas backend."""
        l = int(spadlconfig.field_length * 10)
        w = int(spadlconfig.field_width * 10)
        if self.backend == 'pandas':
            return self._interpolate_numpy(l, w), l, w
        g = torch.as_tensor(grids, dtype=torch.float32, device=self.device)
        return _xtops.interpolate_grid(g, l, w).cpu().numpy(), l, w

    def _interpolate_numpy(self, l_out: int, w_out: int) -> np.ndarray:
        """Bilinear upsampling of ``xT`` between cell centers, the borders
        clamped to the edge cells' centers (the reference's FITPACK
        ``interp2d(kind='linear')`` clamps its queries into the knot range)."""
        cell_l = spadlconfig.field_length / self.l
        cell_w = spadlconfig.field_width / self.w
        xs = np.linspace(0.0, spadlconfig.field_length, l_out)
        ys = np.linspace(0.0, spadlconfig.field_width, w_out)
        fx = (xs - 0.5 * cell_l) / cell_l
        fy = (ys - 0.5 * cell_w) / cell_w
        ix = np.clip(np.floor(fx).astype(np.int64), 0, self.l - 2)
        iy = np.clip(np.floor(fy).astype(np.int64), 0, self.w - 2)
        tx = np.clip(fx - ix, 0.0, 1.0)
        ty = np.clip(fy - iy, 0.0, 1.0)
        r0 = self.w - 1 - iy
        r1 = self.w - 2 - iy
        g00 = self.xT[r0][:, ix]
        g01 = self.xT[r0][:, ix + 1]
        g10 = self.xT[r1][:, ix]
        g11 = self.xT[r1][:, ix + 1]
        top = g00 * (1 - tx[None, :]) + g01 * tx[None, :]
        bot = g10 * (1 - tx[None, :]) + g11 * tx[None, :]
        fine = top * (1 - ty[:, None]) + bot * ty[:, None]
        return fine[::-1]

    def _rate_batch(
        self, grid: np.ndarray, batch: ActionBatch, l: int, w: int,
        group_id: Optional[torch.Tensor] = None,
    ) -> torch.Tensor:
        return _xtops.rate_actions(
            torch.as_tensor(grid, dtype=torch.float32, device=self.device),
            *self._fields(batch), l=l, w=w, group_id=group_id,
        )

    def _rate_grouped(
        self, actions: 'pd.DataFrame', use_interpolation: bool, group_by: Any
    ) -> np.ndarray:
        """Every action rated against its own group's surface; keys the fit
        never saw rate NaN."""
        import pandas as pd

        if group_by is None:
            group_by = self.group_by_
        if group_by is None:
            raise ValueError(
                'this model was grouped by a per-action array, so rate() '
                'cannot look the keys up in a frame column; pass group_by= '
                '(a column name or a per-action key array) to rate. Fitted '
                f'group keys: {_preview_keys(self.group_keys_)}'
            )
        if isinstance(actions, ActionBatch):
            raise ValueError('rating a grouped model requires a DataFrame')
        if isinstance(group_by, str):
            if group_by not in actions.columns:
                raise ValueError(f'group_by column {group_by!r} not in actions')
            values = actions[group_by].to_numpy()
        else:
            values = np.asarray(group_by)
            if len(values) != len(actions):
                raise ValueError(
                    f'group_by array has {len(values)} entries for '
                    f'{len(actions)} actions'
                )
        codes = pd.Index(self.group_keys_).get_indexer(values).astype(np.int32)

        grids = self.grids_
        l, w = self.l, self.w
        if use_interpolation:
            # upsample only the groups this frame references
            used = np.unique(codes[codes >= 0])
            if used.size == 0:
                return np.full(len(actions), np.nan)
            remap = np.full(len(self.group_keys_), -1, dtype=np.int32)
            remap[used] = np.arange(used.size, dtype=np.int32)
            codes = np.where(codes >= 0, remap[np.clip(codes, 0, None)], -1).astype(np.int32)
            grids, l, w = self._fine(grids[used])
        batch = self._as_batch(actions)
        group_id = torch.from_numpy(pack_row_values(codes, batch, fill=-1)).to(self.device)
        return unpack_values(self._rate_batch(grids, batch, l, w, group_id), batch)

    def surface(self, key: Any) -> np.ndarray:
        """The fitted ``(w, l)`` surface of one group (grouped fits)."""
        if self.grids_ is None:
            raise NotFittedError('fit the model with group_by= first')
        matches = np.flatnonzero(self.group_keys_ == key)
        if matches.size == 0:
            raise KeyError(
                f'{key!r} is not a fitted group key; this fit has '
                f'{len(self.group_keys_)} keys: '
                f'{_preview_keys(self.group_keys_)} (rate() maps unseen '
                'keys to NaN instead of raising)'
            )
        return self.grids_[matches[0]]

    def surfaces(self) -> dict:
        """``{group key -> (w, l) surface}`` of a grouped fit."""
        if self.grids_ is None:
            raise NotFittedError('fit the model with group_by= first')
        return {k: self.grids_[i] for i, k in enumerate(self.group_keys_)}

    def rate(
        self,
        actions: Actions,
        use_interpolation: bool = False,
        *,
        group_by: Optional[GroupBy] = None,
    ) -> np.ndarray:
        """Per-action xT ratings: ``xT[end cell] - xT[start cell]``.

        Only successful pass/dribble/cross actions are rated; every other
        row is NaN. An ``ActionBatch`` is rated on the model's device and
        comes back ``(G, A)``; a DataFrame comes back in row order, binned
        in float64 on the host as the JAX package's frontend bins it (on
        either backend; ``use_interpolation`` upsamples the surface on the
        device, or in numpy on the pandas backend). A
        grouped model rates each action against its own group's surface
        (``group_by`` overrides the fit-time column).
        """
        if self.grids_ is not None:
            return self._rate_grouped(actions, use_interpolation, group_by)
        if group_by is not None:
            raise ValueError(
                'group_by rating requires a group_by fit: this model was '
                'fit as a single surface; refit with '
                'fit(actions, group_by=<column or per-action array>) to '
                'rate per group'
            )
        if not np.any(self.xT):
            raise NotFittedError('fit the model before calling rate')
        if use_interpolation:
            grid, l, w = self._fine(self.xT)
        else:
            grid, l, w = self.xT, self.l, self.w

        if isinstance(actions, ActionBatch):
            if self.backend == 'pandas':
                raise TypeError("backend='pandas' rates SPADL DataFrames, not packed batches")
            return self._rate_batch(grid, self._as_batch(actions), l, w).cpu().numpy()

        df = actions.reset_index(drop=True)
        ratings = np.full(len(df), np.nan)
        moves = get_successful_move_actions(df)
        sxi, syj = _get_cell_indexes(
            moves['start_x'].to_numpy(), moves['start_y'].to_numpy(), l, w
        )
        exi, eyj = _get_cell_indexes(moves['end_x'].to_numpy(), moves['end_y'].to_numpy(), l, w)
        ratings[moves.index.to_numpy()] = grid[w - 1 - eyj, exi] - grid[w - 1 - syj, sxi]
        return ratings

    predict = rate  # deprecated alias, as the JAX package keeps it for the reference's API

    def interpolator(self, kind: str = 'linear') -> Callable[..., np.ndarray]:
        """A callable interpolating the xT surface over the pitch.

        Called with 1-D ``xs``/``ys`` meter coordinates it returns the
        ``(len(ys), len(xs))`` surface, from
        ``scipy.interpolate.RegularGridInterpolator`` over the cell centers;
        queries outside the cell-center hull are clamped into it first (the
        reference's FITPACK border behavior).

        Parameters
        ----------
        kind : {'linear', 'cubic', 'quintic'}
            Spline order, as in the reference.
        """
        try:
            from scipy.interpolate import RegularGridInterpolator
        except ImportError as exc:
            raise ImportError('Interpolation requires scipy to be installed.') from exc

        methods = {'linear': 'linear', 'cubic': 'cubic', 'quintic': 'quintic'}
        if kind not in methods:
            raise ValueError(f'kind must be one of {sorted(methods)}, got {kind!r}')
        if self.grids_ is not None:
            raise ValueError(
                'a grouped fit holds a surface collection, not one grid; '
                'interpolate a single surface via surface(key), or rate '
                'with rate(..., use_interpolation=True)'
            )
        cell_l = spadlconfig.field_length / self.l
        cell_w = spadlconfig.field_width / self.w
        xs = np.arange(0.0, spadlconfig.field_length, cell_l) + 0.5 * cell_l
        ys = np.arange(0.0, spadlconfig.field_width, cell_w) + 0.5 * cell_w
        # grid row 0 is the top of the pitch: flip to ascending-y order
        interp = RegularGridInterpolator(
            (ys, xs), self.xT[::-1], method=methods[kind], bounds_error=False, fill_value=None,
        )

        def f(x: np.ndarray, y: np.ndarray) -> np.ndarray:
            x = np.clip(np.asarray(x, dtype=np.float64), xs[0], xs[-1])
            y = np.clip(np.asarray(y, dtype=np.float64), ys[0], ys[-1])
            gx, gy = np.meshgrid(x, y)
            return interp(np.stack([gy.ravel(), gx.ravel()], axis=-1)).reshape(len(y), len(x))

        return f

    # -- persistence -------------------------------------------------------

    def save_model(self, filepath: str, overwrite: bool = True) -> None:
        """Save the xT value surface as a JSON 2-D matrix (the JAX package's format)."""
        if self.grids_ is not None:
            raise ValueError(
                'a grouped fit holds a surface collection, not one grid; '
                'save per-group surfaces via surfaces() / surface(key)'
            )
        if not np.any(self.xT):
            raise NotFittedError('fit the model before saving')
        if not overwrite and os.path.isfile(filepath):
            raise ValueError(
                f'save_model got overwrite=False, but file {filepath!r} already exists'
            )
        with open(filepath, 'w') as f:
            json.dump(np.asarray(self.xT).tolist(), f)


def load_model(path: str, backend: str = 'torch', device: DeviceLike = None) -> ExpectedThreat:
    """A model from a saved xT value surface (JSON 2-D matrix): on
    ``device`` with the default backend, on the host with ``'pandas'``."""
    model = ExpectedThreat(backend=backend, device=device)
    with open(path) as f:
        grid = np.asarray(json.load(f), dtype=np.float64)
    model.xT = grid
    model.w, model.l = grid.shape
    return model
