"""Perturbation grids: declarative "what could have happened" specs.

A :class:`ScenarioGrid` describes ``P`` counterfactual variants of every
game state in a batch — "this pass, but ending in each of 96 pitch cells",
"this state, but as each of the 23 SPADL action types". It is a plain
host-side container: a dict of **field updates** (SPADL columns rewritten
per perturbation) plus optional raw **dense-override blocks** in the
``(P, G, A, width)`` layout that
:meth:`~socceraction_tpu_torch.vaep.base.VAEP.rate_batch` already accepts per
game. The engine (:mod:`socceraction_tpu_torch.scenario.engine`) folds the
perturbation axis into the game axis so the whole grid is valued by ONE
fused dispatch — never ``P`` separate ``rate_batch`` calls.

Grids are wire-serializable (:meth:`ScenarioGrid.to_wire`) so a frontend
can ship them, and bucketable (:func:`pad_perturbations`) so serving can
snap ``P`` to a power-of-two ladder.

A copy of the JAX package's ``socceraction_tpu/scenario/grid.py``
(numpy only), over the port's SPADL vocabulary.
"""

from __future__ import annotations

from typing import Any, Dict, Mapping, Optional, Sequence, Tuple

import numpy as np

from ..spadl import config as spadlconfig

__all__ = [
    'PERTURBABLE_FIELDS',
    'ScenarioGrid',
    'action_type_sweep',
    'custom_grid',
    'end_location_grid',
    'pad_perturbations',
]

#: SPADL columns a grid may rewrite per perturbation. These are exactly the
#: :class:`~socceraction_tpu_torch.core.batch.ActionBatch` fields the feature
#: kernels read as action *content* (ids and coordinates); bookkeeping
#: fields (``mask``, ``n_actions``, ``game_id``, ...) are never
#: perturbable.
PERTURBABLE_FIELDS: Tuple[str, ...] = (
    'type_id',
    'result_id',
    'bodypart_id',
    'start_x',
    'start_y',
    'end_x',
    'end_y',
)

_INT_FIELDS = frozenset({'type_id', 'result_id', 'bodypart_id'})


def _as_update(name: str, value: Any) -> np.ndarray:
    """Coerce one field update to a numpy array of the field's dtype."""
    dtype = np.int32 if name in _INT_FIELDS else np.float32
    arr = np.asarray(value, dtype=dtype)
    if arr.ndim == 0:
        arr = arr[None]
    if arr.ndim not in (1, 3):
        raise ValueError(
            f'field update {name!r} must have shape (P,) or (P, G, A), '
            f'got {arr.shape}'
        )
    return arr


class ScenarioGrid:
    """``P`` counterfactual variants of every game state in a batch.

    Parameters
    ----------
    field_updates
        Mapping from a :data:`PERTURBABLE_FIELDS` name to an array of
        per-perturbation values: shape ``(P,)`` (one value per
        perturbation, broadcast over every action) or ``(P, G, A)``
        (a full per-action rewrite). Id fields are cast to int32,
        coordinates to float32.
    dense_overrides
        Mapping from a dense feature-kernel name (e.g. ``'goalscore'``)
        to a ``(P, G, A, width)`` block substituted verbatim into the
        feature tensor via ``rate_batch(dense_overrides=...)``.
    meta
        Builder bookkeeping (grid geometry, swept type ids, ...) used by
        the product helpers (:mod:`socceraction_tpu_torch.scenario.product`)
        to reshape flat values back into heatmaps and rankings.
    """

    __slots__ = ('field_updates', 'dense_overrides', 'meta')

    def __init__(
        self,
        field_updates: Optional[Mapping[str, Any]] = None,
        dense_overrides: Optional[Mapping[str, Any]] = None,
        meta: Optional[Dict[str, Any]] = None,
    ) -> None:
        updates: Dict[str, np.ndarray] = {}
        for name, value in dict(field_updates or {}).items():
            if name not in PERTURBABLE_FIELDS:
                raise ValueError(
                    f'{name!r} is not a perturbable action field; '
                    f'choose from {sorted(PERTURBABLE_FIELDS)}'
                )
            updates[name] = _as_update(name, value)
        overrides: Dict[str, np.ndarray] = {}
        for name, value in dict(dense_overrides or {}).items():
            block = np.asarray(value, dtype=np.float32)
            if block.ndim != 4:
                raise ValueError(
                    f'dense override {name!r} must have shape '
                    f'(P, G, A, width), got {block.shape}'
                )
            overrides[name] = block
        counts = {a.shape[0] for a in updates.values()}
        counts |= {a.shape[0] for a in overrides.values()}
        if not counts:
            raise ValueError(
                'a ScenarioGrid needs at least one field update or dense '
                'override'
            )
        if len(counts) != 1:
            raise ValueError(
                'inconsistent perturbation counts across grid entries: '
                f'{sorted(counts)}'
            )
        self.field_updates = updates
        self.dense_overrides = overrides
        self.meta = dict(meta or {})

    @property
    def n_perturbations(self) -> int:
        """``P``: the number of counterfactual variants per game state."""
        for arr in self.field_updates.values():
            return int(arr.shape[0])
        for arr in self.dense_overrides.values():
            return int(arr.shape[0])
        raise AssertionError('empty grid')  # unreachable by construction

    def __repr__(self) -> str:  # pragma: no cover - debug convenience
        return (
            f'ScenarioGrid(P={self.n_perturbations}, '
            f'fields={sorted(self.field_updates)}, '
            f'dense={sorted(self.dense_overrides)})'
        )

    def to_wire(self) -> Dict[str, Any]:
        """Serialize to a JSON-safe document."""

        def arr(a: np.ndarray) -> Dict[str, Any]:
            return {
                'shape': list(a.shape),
                'dtype': str(a.dtype),
                'values': a.ravel().tolist(),
            }

        return {
            'field_updates': {k: arr(v) for k, v in self.field_updates.items()},
            'dense_overrides': {
                k: arr(v) for k, v in self.dense_overrides.items()
            },
            'meta': self.meta,
        }

    @classmethod
    def from_wire(cls, doc: Mapping[str, Any]) -> 'ScenarioGrid':
        """Rebuild a grid from its :meth:`to_wire` document."""

        def arr(d: Mapping[str, Any]) -> np.ndarray:
            return np.asarray(
                d['values'], dtype=np.dtype(d['dtype'])
            ).reshape(d['shape'])

        return cls(
            field_updates={
                k: arr(v) for k, v in dict(doc.get('field_updates') or {}).items()
            },
            dense_overrides={
                k: arr(v)
                for k, v in dict(doc.get('dense_overrides') or {}).items()
            },
            meta=dict(doc.get('meta') or {}),
        )


def end_location_grid(
    nx: int = 12,
    ny: int = 8,
    *,
    pitch_length: float = spadlconfig.field_length,
    pitch_width: float = spadlconfig.field_width,
) -> ScenarioGrid:
    """Sweep each action's end location over an ``nx × ny`` cell-center grid.

    Perturbation ``p = iy * nx + ix`` moves ``end_x``/``end_y`` to the
    center of cell ``(ix, iy)``; every other field keeps its factual value.
    The row-major ``(ny, nx)`` order is recorded in ``meta`` so
    :func:`~socceraction_tpu_torch.scenario.product.decision_surface` can fold
    the flat perturbation axis back into a heatmap.
    """
    if nx < 1 or ny < 1:
        raise ValueError(f'grid needs nx >= 1 and ny >= 1, got {nx}x{ny}')
    xs = (np.arange(nx, dtype=np.float32) + 0.5) * (pitch_length / nx)
    ys = (np.arange(ny, dtype=np.float32) + 0.5) * (pitch_width / ny)
    gy, gx = np.meshgrid(ys, xs, indexing='ij')  # (ny, nx)
    return ScenarioGrid(
        field_updates={'end_x': gx.ravel(), 'end_y': gy.ravel()},
        meta={
            'builder': 'end_location_grid',
            'nx': int(nx),
            'ny': int(ny),
            'xs': xs.tolist(),
            'ys': ys.tolist(),
        },
    )


def action_type_sweep(
    type_ids: Optional[Sequence[int]] = None,
    *,
    result_id: Optional[int] = None,
    bodypart_id: Optional[int] = None,
) -> ScenarioGrid:
    """Re-type each action as every SPADL action type (one per perturbation).

    ``type_ids`` defaults to the full 23-type SPADL vocabulary. Optional
    ``result_id`` / ``bodypart_id`` fix those fields across all
    perturbations (e.g. "as a *successful* action of each type").
    """
    if type_ids is None:
        type_ids = range(len(spadlconfig.actiontypes))
    ids = np.asarray(list(type_ids), dtype=np.int32)
    if ids.ndim != 1 or ids.size < 1:
        raise ValueError('type_ids must be a non-empty 1-d sequence of ids')
    n_types = len(spadlconfig.actiontypes)
    if ids.min() < 0 or ids.max() >= n_types:
        raise ValueError(
            f'type ids must be in [0, {n_types}), got '
            f'[{ids.min()}, {ids.max()}]'
        )
    updates: Dict[str, np.ndarray] = {'type_id': ids}
    if result_id is not None:
        updates['result_id'] = np.full(ids.shape, result_id, dtype=np.int32)
    if bodypart_id is not None:
        updates['bodypart_id'] = np.full(
            ids.shape, bodypart_id, dtype=np.int32
        )
    return ScenarioGrid(
        field_updates=updates,
        meta={
            'builder': 'action_type_sweep',
            'type_ids': ids.tolist(),
            'type_names': [spadlconfig.actiontypes[i] for i in ids.tolist()],
        },
    )


def custom_grid(
    field_updates: Optional[Mapping[str, Any]] = None,
    dense_overrides: Optional[Mapping[str, Any]] = None,
    *,
    meta: Optional[Dict[str, Any]] = None,
) -> ScenarioGrid:
    """Build a grid from raw field updates and/or ``(P, G, A, width)`` blocks.

    The escape hatch for perturbations the named grid functions don't cover:
    hand-built dense-override blocks ride the same one-dispatch path.
    """
    return ScenarioGrid(
        field_updates=field_updates,
        dense_overrides=dense_overrides,
        meta=meta,
    )


def pad_perturbations(grid: ScenarioGrid, n_perturbations: int) -> ScenarioGrid:
    """Pad a grid's perturbation axis to ``n_perturbations`` bucket slots.

    Pad slots replicate the last perturbation (edge padding), so the
    padded grid is valid input for the same kernels; callers slice the
    value block back to the true ``P`` rows. Mirrors the masked-game
    padding discipline of
    :func:`~socceraction_tpu_torch.core.batch.pad_batch_games` on the
    perturbation axis.
    """
    P = grid.n_perturbations
    if n_perturbations == P:
        return grid
    if n_perturbations < P:
        raise ValueError(
            f'cannot pad {P} perturbations down to {n_perturbations}'
        )

    def pad(a: np.ndarray) -> np.ndarray:
        width = [(0, n_perturbations - P)] + [(0, 0)] * (a.ndim - 1)
        return np.pad(a, width, mode='edge')

    return ScenarioGrid(
        field_updates={k: pad(v) for k, v in grid.field_updates.items()},
        dense_overrides={k: pad(v) for k, v in grid.dense_overrides.items()},
        meta=grid.meta,
    )
