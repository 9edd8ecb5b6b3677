"""Product-tier reshaping: flat scenario values back into decisions.

The engine returns one flat ``(P, G, A, 3)`` value block per grid. These
helpers fold the perturbation axis back into the shapes decision tools
consume: a per-cell heatmap over the pitch (:func:`decision_surface`) and
a ranked option table (:func:`pass_option_ranking`). Pure host-side numpy/
pandas — no dispatches, no device state; a value tensor on the card is
copied to the host first.

A copy of the JAX package's ``socceraction_tpu/scenario/product.py``;
pandas is imported inside :func:`pass_option_ranking`, its only user.
"""

from __future__ import annotations

from typing import TYPE_CHECKING, Any, Optional

import numpy as np
import torch

from .grid import ScenarioGrid

if TYPE_CHECKING:  # pandas is imported inside pass_option_ranking only
    import pandas as pd

__all__ = ['RATING_COLUMNS', 'decision_surface', 'pass_option_ranking']

#: Column order of the value axis — the same triplet every rating path
#: emits.
RATING_COLUMNS = ('offensive_value', 'defensive_value', 'vaep_value')


def _column_index(column: str) -> int:
    if column not in RATING_COLUMNS:
        raise ValueError(
            f'unknown value column {column!r}; choose from '
            f'{list(RATING_COLUMNS)}'
        )
    return RATING_COLUMNS.index(column)


def _values_at(
    values: Any, grid: ScenarioGrid, game: int, action: int, column: str
) -> np.ndarray:
    if isinstance(values, torch.Tensor):
        values = values.detach().cpu().numpy()
    vals = np.asarray(values)
    if vals.ndim == 3:
        # the serving verb's (P, n_rows, 3) block: the single-game case
        vals = vals[:, None]
    if vals.ndim != 4 or vals.shape[3] != 3:
        raise ValueError(
            f'values must have shape (P, G, A, 3) or (P, n_rows, 3), '
            f'got {vals.shape}'
        )
    if vals.shape[0] != grid.n_perturbations:
        raise ValueError(
            f'values carry {vals.shape[0]} perturbations, grid has '
            f'{grid.n_perturbations}'
        )
    return vals[:, game, action, _column_index(column)]


def decision_surface(
    values: Any,
    grid: ScenarioGrid,
    *,
    game: int = 0,
    action: int = 0,
    column: str = 'vaep_value',
) -> np.ndarray:
    """Fold one state's end-location sweep into a ``(ny, nx)`` heatmap.

    ``values`` is the ``(P, G, A, 3)`` block from
    :func:`~socceraction_tpu_torch.scenario.engine.rate_scenarios_batch` — or
    the serving verb's ``(P, n_rows, 3)`` result, accepted directly as
    the single-game case — for a grid built by
    :func:`~socceraction_tpu_torch.scenario.grid.end_location_grid`; the
    returned array is indexed ``[iy, ix]`` in pitch coordinates (cell
    centers in ``grid.meta['xs']`` / ``grid.meta['ys']``).
    """
    if grid.meta.get('builder') != 'end_location_grid':
        raise ValueError(
            'decision_surface needs a grid built by end_location_grid; '
            f'got builder={grid.meta.get("builder")!r}'
        )
    flat = _values_at(values, grid, game, action, column)
    return flat.reshape(grid.meta['ny'], grid.meta['nx'])


def pass_option_ranking(
    values: Any,
    grid: ScenarioGrid,
    *,
    game: int = 0,
    action: int = 0,
    column: str = 'vaep_value',
    top: Optional[int] = None,
) -> 'pd.DataFrame':
    """Rank one state's perturbations by value, best first.

    Returns a DataFrame with one row per perturbation: the ranked value
    (``column``), the perturbation index, every swept field's value at
    that perturbation (``(P,)``-shaped field updates only — per-action
    rewrites have no single per-perturbation scalar), and — for an
    :func:`~socceraction_tpu_torch.scenario.grid.action_type_sweep` grid — the
    SPADL action-type name. ``top`` truncates to the best ``top``
    options.
    """
    import pandas as pd

    flat = _values_at(values, grid, game, action, column)
    cols: dict = {'perturbation': np.arange(grid.n_perturbations)}
    for name, upd in sorted(grid.field_updates.items()):
        if upd.ndim == 1:
            cols[name] = upd
    names = grid.meta.get('type_names')
    if names is not None and len(names) == grid.n_perturbations:
        cols['type_name'] = list(names)
    cols[column] = flat
    out = pd.DataFrame(cols).sort_values(
        column, ascending=False, kind='stable'
    )
    out = out.reset_index(drop=True)
    out.insert(0, 'rank', np.arange(1, len(out) + 1))
    if top is not None:
        out = out.head(int(top))
    return out
