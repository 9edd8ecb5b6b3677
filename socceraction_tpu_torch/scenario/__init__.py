"""Counterfactual scenario engine: value every alternative in one call.

Port of the JAX package's ``socceraction_tpu/scenario``. A
:class:`ScenarioGrid` declares ``P`` perturbations of every game state;
the engine folds that perturbation axis into the game axis and values the
whole grid with ONE ``rate_batch`` call — one launch of the fused
first-layer kernel. xT scenario fleets ride the grouped solver's fleet
axis the same way (:func:`xt_scenario_fleet`).
:func:`decision_surface` and :func:`pass_option_ranking` fold the values
back into heatmaps and ranked option tables.
"""

from .engine import (
    bucket_perturbations,
    expand_scenarios,
    perturbation_ladder,
    rate_scenarios_batch,
    rate_scenarios_looped,
    rate_scenarios_reference,
)
from .grid import (
    PERTURBABLE_FIELDS,
    ScenarioGrid,
    action_type_sweep,
    custom_grid,
    end_location_grid,
    pad_perturbations,
)
from .product import decision_surface, pass_option_ranking
from .xt import SCENARIO_COLUMN, xt_scenario_fleet

__all__ = [
    'PERTURBABLE_FIELDS',
    'SCENARIO_COLUMN',
    'ScenarioGrid',
    'action_type_sweep',
    'bucket_perturbations',
    'custom_grid',
    'decision_surface',
    'end_location_grid',
    'expand_scenarios',
    'pad_perturbations',
    'pass_option_ranking',
    'perturbation_ladder',
    'rate_scenarios_batch',
    'rate_scenarios_looped',
    'rate_scenarios_reference',
    'xt_scenario_fleet',
]
