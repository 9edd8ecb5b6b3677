"""The program of head kind ``tokens`` (``cardbench/newkind/heads/tokens.py``),
for the benchmark's own tests: that head in plain float32 PyTorch over the
port's packed rows (``ops.fused._packed_rows``: the dense block and each
state's combined id in the port registry's order) and the port's VAEP
formula. Copied to ``adapters/tokens.py`` of a temporary root.

Its weights are the harness's, with each head's embedding mapped from the
reference's token order into the registry's combined-id order, and its
standardization the harness's cut to the dense columns by the layout.
"""

from __future__ import annotations

from typing import Any, Dict, List

import torch

from cardbench.adapters.vaep_mlp import batch  # noqa: F401  (the port's packed batch)


class Program:
    """Both heads over a batch, then the formula: ``rate_batch(batch)``."""

    def __init__(self, config: Dict[str, Any], heads: List[Dict[str, torch.Tensor]],
                 registry: Any, mean: torch.Tensor, std: torch.Tensor) -> None:
        self.config, self.heads, self.registry, self.mean, self.std = config, heads, registry, mean, std

    def rate_batch(self, batch: Any) -> torch.Tensor:
        from socceraction_tpu_torch.ops.formula import vaep_values
        from socceraction_tpu_torch.ops.fused import _packed_rows

        k = self.config['nb_prev_actions']
        x_dense, ids = _packed_rows(batch, names=self.config['xfns'], k=k, registry=self.registry)
        dense = (x_dense - self.mean) / self.std
        p = []
        for w in self.heads:
            emb = w['embed'][ids.long()]
            h = dense.new_zeros((dense.shape[0], w['wh'].shape[0]))
            for lag in range(k - 1, -1, -1):
                h = torch.tanh(emb[:, lag] @ w['wx'] + h @ w['wh'] + w['b'])
            r = torch.relu(torch.cat([h, dense], -1) @ w['w1'] + w['b1'])
            p.append(torch.sigmoid((r @ w['w2'] + w['b2'])[:, 0]).reshape(batch.n_games, -1))
        return vaep_values(batch, *p)


def build(config: Dict[str, Any], weights: Dict[str, Dict[str, torch.Tensor]], layout: Any,
          mean: torch.Tensor, std: torch.Tensor, device: torch.device) -> Program:
    """The program with the harness's heads, on ``device``."""
    from socceraction_tpu_torch.ops.fused import STANDARD_REGISTRY

    if config['model_class'] != 'VAEP':
        raise ValueError('the token program rates SPADL actions (model_class VAEP) only')
    registry = STANDARD_REGISTRY
    # the reference's token of each of the registry's combined ids
    combo = torch.arange(registry.combo_size)
    reference_token = torch.zeros_like(combo)
    for name in config['tokens']:
        width = next(b.width for b in layout if b.lag == 0 and b.name == name)
        reference_token = reference_token * width + registry.combo_rows[name](combo)
    heads = []
    for col in ('scores', 'concedes'):
        w = {n: t.to(device=device, dtype=torch.float32) for n, t in weights[col].items()}
        w['embed'] = w['embed'][reference_token.to(device)].contiguous()
        heads.append(w)
    dense = torch.tensor([b.offset + j for b in layout if not b.onehot for j in range(b.width)])
    return Program(config, heads, registry, mean[dense].to(device), std[dense].to(device))
