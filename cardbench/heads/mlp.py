"""MLP value heads: the seeded weight recipe and the plain forward pass.

A head is standardized features -> ReLU layers -> one logit -> sigmoid, as
socceraction's MLP learner and the port's ``MLPClassifier`` define it. It
reads the whole feature row, one-hot columns included, standardized.

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
from typing import Any, Callable, Dict, List, Tuple

import torch

from cardbench import yardstick

#: The two heads of a VAEP model, in the order the weights are drawn.
HEADS = ('scores', 'concedes')

Layers = List[Tuple[torch.Tensor, torch.Tensor]]


def check(config: Dict[str, Any]) -> None:
    """Raise ``ValueError`` unless ``config`` states what an MLP pair needs:
    its hidden widths and B1's shape."""
    hidden = config.get('hidden')
    if not isinstance(hidden, list) or not hidden or not all(
            isinstance(w, int) and w > 0 for w in hidden):
        raise ValueError(f'an MLP head needs hidden widths, a list of positive ints; got {hidden!r}')
    for key in ('nb_prev_actions', 'table_rows', 'dense_columns'):
        if not isinstance(config.get(key), int) or config[key] <= 0:
            raise ValueError(f'an MLP head needs a positive int {key!r}; got {config.get(key)!r}')


def make(gen: torch.Generator, config: Dict[str, Any], layout: Any, mean: torch.Tensor,
         std: torch.Tensor, device: torch.device) -> Dict[str, Layers]:
    """``{head: [(kernel (in, out), bias (out,)), ...]}`` in float32 on
    ``device``, for the rows of ``layout`` (:class:`cardbench.families.Block`
    each) whose standard deviations are ``std``."""
    onehot = torch.tensor([b.onehot for b in layout for _ in range(b.width)], dtype=torch.bool)
    widths = (onehot.numel(), *config['hidden'], 1)
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


def probs(x: torch.Tensor, layers: Layers, config: Dict[str, Any], layout: Any,
          mean: torch.Tensor, std: torch.Tensor,
          matmul: Callable[[torch.Tensor, torch.Tensor], torch.Tensor] = torch.matmul,
          ) -> torch.Tensor:
    """``(...,)`` probabilities of raw features ``x (..., F)``, standardized
    by ``mean`` and ``std`` (in ``x``'s dtype), in ``x``'s dtype;
    ``matmul`` multiplies each layer's input by its kernel."""
    h = (x - mean) / std
    for i, (kernel, bias) in enumerate(layers):
        h = matmul(h, kernel.to(x.dtype)) + bias.to(x.dtype)
        if i < len(layers) - 1:
            h = torch.relu(h)
    return torch.sigmoid(h[..., 0])


def flops_per_action(config: Dict[str, Any]) -> float:
    """FLOPs of both heads for one valid action: B1's operations (the first
    layers side by side, :func:`cardbench.yardstick.b1_ops`), then each
    head's hidden chain (``2·w_in·w_out`` a layer, the output layer
    included)."""
    widths = list(config['hidden']) + [1]
    chain = sum(2 * a * b for a, b in zip(widths[:-1], widths[1:]))
    return yardstick.b1_ops(config, 1) + len(HEADS) * chain
