"""Traffic kind ``scenario``: each request values a perturbation grid over the
next ``games_per_call`` games through the port's
``scenario.rate_scenarios_batch`` (the grid folded into the game axis, one
``rate_batch``) and returns their ``(P, G, A, 3)`` values.

Parameter of its own: ``grid``, ``{"builder": "end_location", "nx": ..,
"ny": ..}``: the end location of every action of the games set to each
point of an ``nx`` × ``ny`` grid in turn.
"""

from __future__ import annotations

from typing import Any, Dict, List, Tuple

import torch

from cardbench import reference, traffic


def grid_updates(family: Any, grid: Dict[str, Any]) -> Dict[str, List[float]]:
    """The harness's own field values of a scenario grid (the reference's)."""
    if grid['builder'] != 'end_location':
        raise ValueError(f"unknown grid builder {grid['builder']!r}")
    return family.end_location(grid['nx'], grid['ny'])


def program_grid(grid: Dict[str, Any]) -> Any:
    """The port's scenario grid of a traffic mix's ``grid`` entry."""
    from socceraction_tpu_torch.scenario.grid import end_location_grid

    if grid['builder'] != 'end_location':
        raise ValueError(f"unknown grid builder {grid['builder']!r}")
    return end_location_grid(grid['nx'], grid['ny'])


def entry(program: Any, batch: Any, grid: Any) -> torch.Tensor:
    """``(P, G, A, 3)`` values of one folded counterfactual request."""
    from socceraction_tpu_torch.scenario.engine import rate_scenarios_batch

    return rate_scenarios_batch(program, batch, grid)


class Load(traffic.ClosedLoop):
    """One analyst in a closed loop over the season's games, a grid a request."""

    work_unit = 'values'

    def setup(self, family: Any) -> None:
        self.updates = grid_updates(family, self.traffic['grid'])
        self.grid = program_grid(self.traffic['grid'])
        self.perturbations = len(next(iter(self.updates.values())))

    def value_shape(self, games: int, actions: int) -> Tuple[int, ...]:
        return (self.perturbations, games, actions, 3)

    def values(self, item: traffic.Item) -> torch.Tensor:
        return entry(self.program, item.batch, self.grid)

    def reference_inputs(self, item: traffic.Item) -> Tuple[Dict[str, torch.Tensor], torch.Tensor]:
        """The games of ``item`` once for each point of the grid,
        perturbation-major, as the program's values lie."""
        fields, mask = super().reference_inputs(item)
        return reference.perturbed(fields, self.updates), mask.repeat(self.perturbations, 1)
