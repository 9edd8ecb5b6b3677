"""Head kind ``tokens``, for the benchmark's own tests: a head over token ids,
not an MLP, that joins the benchmark as new files only
(``test_a_head_that_is_not_an_mlp_is_new_files_only`` copies it to
``heads/tokens.py`` of a temporary root).

A game state's token is the combined id of the one-hot blocks that the
configuration's ``tokens`` names, read off the raw feature row at that
state's lag (mixed radix, in the order ``tokens`` lists them). A head
embeds each state's token (``embed``, ``(rows, E)``), runs a recurrence
``h = tanh(e·wx + h·wh + b)`` over the states oldest to newest, and reads
``relu([h, standardized dense columns]·w1 + b1)·w2 + b2`` as one logit.
Only the dense columns are standardized; the one-hot columns enter
through the tokens alone.

Configuration keys: ``tokens``, ``embed_dim``, ``hidden``
(``[state, readout]``), ``dense_columns``, ``nb_prev_actions``.
"""

from __future__ import annotations

import math
from typing import Any, Callable, Dict

import torch

HEADS = ('scores', 'concedes')


def check(config: Dict[str, Any]) -> None:
    """Raise ``ValueError`` unless ``config`` states what a token head needs."""
    if not config.get('tokens'):
        raise ValueError('a token head needs the one-hot blocks of its tokens, `tokens`')
    hidden = config.get('hidden')
    if not isinstance(hidden, list) or len(hidden) != 2:
        raise ValueError(f'a token head needs hidden = [state, readout]; got {hidden!r}')
    for key in ('embed_dim', 'dense_columns', 'nb_prev_actions'):
        if not isinstance(config.get(key), int) or config[key] <= 0:
            raise ValueError(f'a token head needs a positive int {key!r}; got {config.get(key)!r}')


def token_widths(config: Dict[str, Any], layout: Any) -> Dict[str, int]:
    """The width of each block of ``tokens``: its radix in the token id."""
    return {b.name: b.width for b in layout if b.lag == 0 and b.name in config['tokens']}


def tokens(x: torch.Tensor, config: Dict[str, Any], layout: Any) -> torch.Tensor:
    """``(..., k)`` int64 token of each state of raw feature rows ``x``."""
    at = {(b.name, b.lag): b for b in layout}
    out = []
    for lag in range(config['nb_prev_actions']):
        token = torch.zeros(x.shape[:-1], dtype=torch.int64, device=x.device)
        for name in config['tokens']:
            b = at[name, lag]
            token = token * b.width + x[..., b.offset:b.offset + b.width].argmax(-1)
        out.append(token)
    return torch.stack(out, -1)


def dense_columns(layout: Any) -> torch.Tensor:
    """The row's column indices that no one-hot block holds, in row order."""
    return torch.tensor([b.offset + j for b in layout if not b.onehot for j in range(b.width)])


def make(gen: torch.Generator, config: Dict[str, Any], layout: Any, mean: torch.Tensor,
         std: torch.Tensor, device: torch.device) -> Dict[str, Dict[str, torch.Tensor]]:
    """``{head: {name: tensor}}`` in float32 on ``device``: unit normal
    embeddings, kernels normal with scale ``1/sqrt(fan_in)`` (half that on
    ``w2``), biases normal with scale 0.05 and ``b2`` at ``logit(0.01)``."""
    rows = math.prod(token_widths(config, layout).values())
    e, (h, r), d = config['embed_dim'], config['hidden'], len(dense_columns(layout))

    def normal(scale: float, *shape: int) -> torch.Tensor:
        return scale * torch.randn(shape, generator=gen, device=device)

    return {col: {
        'embed': normal(1.0, rows, e),
        'wx': normal(1 / math.sqrt(e), e, h), 'wh': normal(1 / math.sqrt(h), h, h),
        'b': normal(0.05, h),
        'w1': normal(1 / math.sqrt(h + d), h + d, r), 'b1': normal(0.05, r),
        'w2': normal(0.5 / math.sqrt(r), r, 1),
        'b2': torch.full((1,), math.log(0.01 / 0.99), device=device),
    } for col in HEADS}


def probs(x: torch.Tensor, w: Dict[str, torch.Tensor], config: Dict[str, Any], layout: Any,
          mean: torch.Tensor, std: torch.Tensor,
          matmul: Callable[[torch.Tensor, torch.Tensor], torch.Tensor] = torch.matmul,
          ) -> torch.Tensor:
    """``(...,)`` probabilities of raw feature rows ``x (..., F)`` in ``x``'s
    dtype; ``matmul`` makes every product with a weight."""
    w = {n: t.to(x.dtype) for n, t in w.items()}
    emb = w['embed'][tokens(x, config, layout)]
    h = x.new_zeros((*x.shape[:-1], w['wh'].shape[0]))
    for lag in range(config['nb_prev_actions'] - 1, -1, -1):
        h = torch.tanh(matmul(emb[..., lag, :], w['wx']) + matmul(h, w['wh']) + w['b'])
    cols = dense_columns(layout).to(x.device)
    dense = (x[..., cols] - mean[cols]) / std[cols]
    r = torch.relu(matmul(torch.cat([h, dense], -1), w['w1']) + w['b1'])
    return torch.sigmoid((matmul(r, w['w2']) + w['b2'])[..., 0])


def flops_per_action(config: Dict[str, Any]) -> float:
    """FLOPs of both heads for one valid action: the recurrence's two
    products at each state, the readout's two."""
    e, (h, r), d = config['embed_dim'], config['hidden'], config['dense_columns']
    per_head = config['nb_prev_actions'] * 2 * (e * h + h * h) + 2 * (h + d) * r + 2 * r
    return float(len(HEADS) * per_head)
