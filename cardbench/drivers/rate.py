"""Traffic kind ``rate``: each call rates the next ``games_per_call`` games of
the season through the port's ``rate_batch`` and returns their ``(G, A, 3)``
values."""

from __future__ import annotations

from typing import Any

import torch

from cardbench import traffic


def entry(program: Any, batch: Any) -> torch.Tensor:
    """``(G, A, 3)`` values of one ``rate_batch`` call."""
    return program.rate_batch(batch)


class Load(traffic.ClosedLoop):
    """One caller in a closed loop over the season's chunks."""

    def values(self, item: traffic.Item) -> torch.Tensor:
        return entry(self.program, item.batch)
