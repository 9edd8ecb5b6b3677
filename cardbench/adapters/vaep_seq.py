"""The program under test for a VAEP model with two GRU sequence heads.

The heads enter the port through its own converter
(``convert.seq_module_from_jax_params``: the JAX package's seq parameter
tree of numpy arrays), each in a ``SeqClassifier`` that holds the
full-row standardization as a fitted one does (the port cuts it to the
dense columns itself, ``seq.model.dense_stats``); the model is the port's
``VAEP`` over the configuration's transformers, which rates two seq heads
on its ``'seq'`` path. The traffic's drivers (``cardbench/drivers/``) call
its public entry points.
"""

from __future__ import annotations

from typing import Any, Dict

import numpy as np
import torch

from cardbench.adapters.vaep_mlp import batch  # noqa: F401  (the port's packed batch)

#: The readout's weights; a head's others but ``embed`` are the GRU's.
READOUT = ('w1', 'b1', 'w2', 'b2')


def registry_order(config: Dict[str, Any], layout: Any, registry: Any) -> torch.Tensor:
    """The reference's token (``heads/gru.py:tokens``) of each of the
    registry's combined ids: the registry's ``combo_rows`` give each id's
    row of every token block, combined in the reference's mixed radix."""
    combo = torch.arange(registry.combo_size)
    token = torch.zeros_like(combo)
    for name in config['tokens']:
        width = next(b.width for b in layout if b.lag == 0 and b.name == name)
        token = token * width + registry.combo_rows[name](combo)
    return token


def build(config: Dict[str, Any], weights: Dict[str, Dict[str, torch.Tensor]], layout: Any,
          mean: torch.Tensor, std: torch.Tensor, device: torch.device) -> Any:
    """The port's model with the harness's heads, on ``device``: each
    head's embedding in the registry's combined-id order, its gates in
    ``SeqModule``'s ``w*``, ``u*``, ``b*`` and its readout's ``w1`` ``(H +
    D, R)``, ``b1``, ``w2`` ``(R,)``, ``b2`` ``()``."""
    from socceraction_tpu_torch.convert import seq_module_from_jax_params
    from socceraction_tpu_torch.ops.fused import STANDARD_REGISTRY
    from socceraction_tpu_torch.seq.classifier import SeqClassifier
    from socceraction_tpu_torch.vaep.base import VAEP

    if config['model_class'] != 'VAEP':
        raise ValueError('the seq adapter rates SPADL actions (model_class VAEP) only')
    order = registry_order(config, layout, STANDARD_REGISTRY).numpy()
    heads = {}
    for col, w in weights.items():
        w = {n: t.detach().float().cpu().numpy() for n, t in w.items()}
        params = {
            'embed': np.ascontiguousarray(w['embed'][order]),
            'gru': {n: a for n, a in w.items() if n != 'embed' and n not in READOUT},
            'readout': {n: w[n] for n in READOUT},
        }
        clf = SeqClassifier(embed_dim=config['embed_dim'], hidden=config['hidden'],
                            readout=config['readout'], device=device)
        clf.module = seq_module_from_jax_params(params).to(device)
        clf.mean_, clf.std_ = mean.to(device), std.to(device)
        heads[col] = clf
    return VAEP(xfns=config['xfns'], nb_prev_actions=config['nb_prev_actions'],
                models=heads, device=device)
