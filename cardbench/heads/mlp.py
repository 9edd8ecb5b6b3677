"""MLP value heads: the seeded weight recipe and the plain forward pass.

A head is standardized features -> ReLU layers -> one logit -> sigmoid, as
socceraction's MLP learner and the port's ``MLPClassifier`` define it.

The recipe makes random heads that look trained (the recipe of the port's
smoke run, ``chip_smoke.make_model``): each kernel is normal with scale
``1/sqrt(fan_in)`` (half that on the output layer), hidden biases normal
with scale 0.05, the output bias at ``logit(0.01)`` (a goal within ten
actions is rare), and the first-layer row of a one-hot column scaled by
``min(1, 2σ)`` (a rarely active column gets few updates, so its weight on
the raw 0/1 input stays small instead of growing as ``1/σ``).
"""

from __future__ import annotations

import math
from typing import Callable, Dict, List, Sequence, Tuple

import torch

#: The two heads of a VAEP model, in the order the weights are drawn.
HEADS = ('scores', 'concedes')

Layers = List[Tuple[torch.Tensor, torch.Tensor]]


def make(gen: torch.Generator, hidden: Sequence[int], onehot: torch.Tensor,
         std: torch.Tensor, device: torch.device) -> Dict[str, Layers]:
    """``{head: [(kernel (in, out), bias (out,)), ...]}`` in float32 on
    ``device``, for features whose one-hot columns are ``onehot`` and
    whose standard deviations are ``std``."""
    widths = (onehot.numel(), *hidden, 1)
    row_scale = torch.where(onehot.to(device), torch.clamp(2.0 * std.to(device), max=1.0), 1.0)
    heads = {}
    for col in HEADS:
        layers = []
        for i, (fan_in, fan_out) in enumerate(zip(widths[:-1], widths[1:])):
            last = i == len(widths) - 2
            scale = (0.5 if last else 1.0) / math.sqrt(fan_in)
            kernel = scale * torch.randn((fan_in, fan_out), generator=gen, device=device)
            if i == 0:
                kernel = kernel * row_scale[:, None]
            if last:
                bias = torch.full((fan_out,), math.log(0.01 / 0.99), device=device)
            else:
                bias = 0.05 * torch.randn((fan_out,), generator=gen, device=device)
            layers.append((kernel.float(), bias.float()))
        heads[col] = layers
    return heads


def probs(x: torch.Tensor, layers: Layers,
          matmul: Callable[[torch.Tensor, torch.Tensor], torch.Tensor] = torch.matmul,
          ) -> torch.Tensor:
    """``(...,)`` probabilities of standardized features ``x (..., F)`` in
    ``x``'s dtype; ``matmul`` multiplies each layer's input by its kernel."""
    h = x
    for i, (kernel, bias) in enumerate(layers):
        h = matmul(h, kernel.to(x.dtype)) + bias.to(x.dtype)
        if i < len(layers) - 1:
            h = torch.relu(h)
    return torch.sigmoid(h[..., 0])
