"""Scenario fleets on the xT side: one grouped solve for every variant.

Port of the JAX package's ``socceraction_tpu/scenario/xt.py``. Where the
VAEP half of the engine folds perturbations into the *game* axis, the xT
half folds them into the **fleet** axis of the batched solver: every
scenario (a perturbed-transition variant, a score-state slice, a phase
slice) becomes one group of a single grouped
:meth:`~socceraction_tpu_torch.xthreat.ExpectedThreat.fit`, whose fleet
of surfaces is counted by one segment sum and solved together, with
per-grid convergence certificates.
"""

from __future__ import annotations

from typing import TYPE_CHECKING, Any, Callable, Mapping, Optional, Union

from ..xthreat import ExpectedThreat

if TYPE_CHECKING:  # pandas is imported inside xt_scenario_fleet only
    import pandas as pd

__all__ = ['SCENARIO_COLUMN', 'xt_scenario_fleet']

#: The synthetic group column :func:`xt_scenario_fleet` keys the fleet by.
SCENARIO_COLUMN = '__scenario__'

#: A scenario spec: a ready action frame, or a transform applied to the
#: base frame (``None`` means "the factual frame, untouched").
Scenario = Union['pd.DataFrame', Callable[['pd.DataFrame'], 'pd.DataFrame'], None]


def xt_scenario_fleet(
    actions: Optional['pd.DataFrame'],
    scenarios: Mapping[Any, Scenario],
    **model_kwargs: Any,
) -> ExpectedThreat:
    """Fit one grouped xT model over a whole fleet of scenario frames.

    Parameters
    ----------
    actions
        The factual SPADL action frame every callable scenario perturbs.
        May be ``None`` when every scenario supplies its own frame.
    scenarios
        ``{key: scenario}`` — each value is a DataFrame (used as-is), a
        callable ``frame -> frame`` transform of ``actions``, or ``None``
        for the untouched factual frame.
    model_kwargs
        Forwarded to :class:`~socceraction_tpu_torch.xthreat.ExpectedThreat`
        (``l``, ``w``, ``solver``, ``device``, ...).

    Returns the fitted grouped model: ``surface(key)`` gives each
    scenario's surface, ``group_keys_`` lists the fleet, and the per-grid
    certificates report each scenario's convergence — all from ONE
    grouped solve.
    """
    import pandas as pd

    if not scenarios:
        raise ValueError('xt_scenario_fleet needs at least one scenario')
    frames = []
    for key, spec in scenarios.items():
        if callable(spec):
            if actions is None:
                raise ValueError(
                    f'scenario {key!r} is a transform but no base actions frame was given'
                )
            frame = spec(actions.copy())
        elif spec is None:
            if actions is None:
                raise ValueError(
                    f'scenario {key!r} is None (factual) but no base actions frame was given'
                )
            frame = actions.copy()
        else:
            frame = spec.copy()
        if SCENARIO_COLUMN in frame.columns:
            raise ValueError(f'scenario frames must not already carry {SCENARIO_COLUMN!r}')
        frame[SCENARIO_COLUMN] = key
        frames.append(frame)
    combined = pd.concat(frames, ignore_index=True)
    model = ExpectedThreat(**model_kwargs)
    model.fit(combined, group_by=SCENARIO_COLUMN)
    return model
