"""The program under test for a VAEP or Atomic-VAEP model with two MLP heads.

The heads enter the port through its own converter
(``convert.mlp_from_jax_params``: the flax parameter tree of numpy arrays
and the standardization), which is the program's set-up; the model is the
port's ``VAEP`` or ``AtomicVAEP`` (``model_class`` of the configuration)
over the configuration's transformers. The traffic's drivers
(``cardbench/drivers/``) call its public entry points.
"""

from __future__ import annotations

from typing import Any, Dict, List, Tuple

import torch


def build(config: Dict[str, Any], weights: Dict[str, List[Tuple[torch.Tensor, torch.Tensor]]],
          layout: Any, mean: torch.Tensor, std: torch.Tensor, device: torch.device) -> Any:
    """The port's model with the harness's heads, on ``device``. The heads
    read the whole row, so the port's converter takes the full-width
    standardization and the ``layout`` is not needed."""
    from socceraction_tpu_torch.atomic.vaep.base import AtomicVAEP
    from socceraction_tpu_torch.convert import mlp_from_jax_params
    from socceraction_tpu_torch.vaep.base import VAEP

    cls = {'VAEP': VAEP, 'AtomicVAEP': AtomicVAEP}[config['model_class']]
    heads = {}
    for col, layers in weights.items():
        params = {f'Dense_{i}': {'kernel': w.cpu().numpy(), 'bias': b.cpu().numpy()}
                  for i, (w, b) in enumerate(layers)}
        heads[col] = mlp_from_jax_params({'params': params}, mean.cpu().numpy(),
                                         std.cpu().numpy(), device=device)
    return cls(xfns=config['xfns'], nb_prev_actions=config['nb_prev_actions'],
               models=heads, device=device)


def batch(config: Dict[str, Any], fields: Dict[str, torch.Tensor], mask: torch.Tensor,
          total: int) -> Any:
    """The port's packed batch of the games in ``fields`` (left-aligned,
    ``mask`` on the valid rows), with its valid-action count on the host."""
    from socceraction_tpu_torch.core.batch import ActionBatch, AtomicActionBatch

    cls = {'VAEP': ActionBatch, 'AtomicVAEP': AtomicActionBatch}[config['model_class']]
    n_games = mask.shape[0]
    row_index = torch.where(mask, torch.cumsum(mask.reshape(-1).int(), 0).reshape(mask.shape) - 1,
                            -1)
    return cls(
        **fields, mask=mask, n_actions=mask.sum(1, dtype=torch.int32),
        game_id=torch.arange(n_games, dtype=torch.int32, device=mask.device),
        row_index=row_index.to(torch.int32),
    ).with_total(total)
