"""GRU sequence value heads: the seeded weight recipe and the plain forward pass.

A head values an action from the short sequence of actions that led to
it. Its equations and widths are those of the GRU head of
``socceraction_tpu``'s ``seq/model.py`` (``_gru_pass`` and ``seq_logits``)
at ``seq/classifier.py``'s ``SeqClassifier`` defaults, the head of the
port's ``SeqClassifier``; this file follows them equation for equation,
with no departure. (Merhej, Beal, Matthews, Ramchurn: What Happened Next?
Using Deep Learning to Value Defensive Actions in Football Event-Data, KDD
2021, arXiv:2106.01786, is cited only as the rationale for valuing an
action from a sequence model over the actions before it.)

- each of the ``k`` game states is one token, embedded by a row of
  ``embed`` ``(rows, E)``;
- a GRU with one bias a gate runs over the tokens oldest to newest (lag
  ``k-1`` to 0), from ``h = 0``::

      z  = sigmoid(e·wz + h·uz + bz)
      r  = sigmoid(e·wr + h·ur + br)
      hh = tanh(e·wh + (r·h)·uh + bh)      # the reset gate before uh
      h  = (1 - z)·h + z·hh

- the readout takes the last ``h`` beside the standardized dense columns:
  ``relu([h, dense]·w1 + b1)·w2 + b2``, one logit, then a sigmoid.

A state's token is read off the raw feature row: the mixed-radix id of the
one-hot blocks that the configuration's ``tokens`` names, at that state's
lag, in the order ``tokens`` lists them. For SPADL with ``tokens`` =
actiontype, result, bodypart that is ``(type·6 + result)·4 + bodypart``,
552 = 23 × 6 × 4 ids. The assumption that this is the program's own order
(its registry's combined id) is made in the adapter, not here: it maps
this embedding into the registry's order through the registry's own
``combo_rows`` (``cardbench/adapters/vaep_seq.py``). Only the dense
columns (those of no one-hot block) are standardized; the one-hot columns
enter through the tokens alone.

The recipe makes random heads shaped like trained ones: embedding rows unit
normal, each kernel normal with scale ``1/sqrt(fan_in)`` (half that on the
readout's ``w2``), biases normal with scale 0.05 and the output bias ``b2``
at ``logit(0.01)`` (a goal within ten actions is rare). Shapes are the
port's: ``w*`` ``(E, H)``, ``u*`` ``(H, H)``, ``b*`` ``(H,)``, ``w1``
``(H + D, R)``, ``b1`` ``(R,)``, ``w2`` ``(R,)``, ``b2`` ``()``.

Configuration keys: ``tokens``, ``embed_dim`` (E), ``hidden`` (H),
``readout`` (R), ``table_rows`` (the tokens' count), ``dense_columns``
(D), ``nb_prev_actions`` (k).
"""

from __future__ import annotations

import math
from typing import Any, Callable, Dict

import torch

#: The two heads of a VAEP model, in the order the weights are drawn.
HEADS = ('scores', 'concedes')
#: The GRU's gates, in the order their weights are drawn.
GATES = ('z', 'r', 'h')


def check(config: Dict[str, Any]) -> None:
    """Raise ``ValueError`` unless ``config`` states what a GRU pair needs."""
    tokens = config.get('tokens')
    if not isinstance(tokens, list) or not tokens or not all(isinstance(t, str) for t in tokens):
        raise ValueError(f'a GRU head needs the one-hot blocks of its tokens, `tokens`; got {tokens!r}')
    missing = [t for t in tokens if t not in config.get('xfns', [])]
    if missing:
        raise ValueError(f'the tokens {missing} are not among the transformers `xfns`')
    for key in ('embed_dim', 'hidden', 'readout', 'table_rows', 'dense_columns', 'nb_prev_actions'):
        if not isinstance(config.get(key), int) or config[key] <= 0:
            raise ValueError(f'a GRU head needs a positive int {key!r}; got {config.get(key)!r}')


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
    """``{head: {name: tensor}}`` in float32 on ``device`` (see the module
    doc for the recipe)."""
    rows = math.prod(token_widths(config, layout).values())
    e, h, r = config['embed_dim'], config['hidden'], config['readout']
    d = len(dense_columns(layout))
    if (rows, d) != (config['table_rows'], config['dense_columns']):
        raise ValueError(f"the layout gives {rows} token ids and {d} dense columns; the "
                         f"configuration states {config['table_rows']} and {config['dense_columns']}")

    def normal(scale: float, *shape: int) -> torch.Tensor:
        return scale * torch.randn(shape, generator=gen, device=device)

    heads = {}
    for col in HEADS:
        w = {'embed': normal(1.0, rows, e)}
        for g in GATES:
            w[f'w{g}'] = normal(1 / math.sqrt(e), e, h)
            w[f'u{g}'] = normal(1 / math.sqrt(h), h, h)
            w[f'b{g}'] = normal(0.05, h)
        w.update(w1=normal(1 / math.sqrt(h + d), h + d, r), b1=normal(0.05, r),
                 w2=normal(0.5 / math.sqrt(r), r),
                 b2=torch.full((), math.log(0.01 / 0.99), device=device))
        heads[col] = w
    return heads


def probs(x: torch.Tensor, w: Dict[str, torch.Tensor], config: Dict[str, Any], layout: Any,
          mean: torch.Tensor, std: torch.Tensor,
          matmul: Callable[[torch.Tensor, torch.Tensor], torch.Tensor] = torch.matmul,
          ) -> torch.Tensor:
    """``(...,)`` probabilities of raw feature rows ``x (..., F)`` in ``x``'s
    dtype, with ``mean`` and ``std`` (full row width) in ``x``'s dtype;
    ``matmul`` makes every product with a weight."""
    w = {n: t.to(x.dtype) for n, t in w.items()}
    emb = w['embed'][tokens(x, config, layout)]
    h = x.new_zeros((*x.shape[:-1], config['hidden']))
    for lag in range(config['nb_prev_actions'] - 1, -1, -1):
        e = emb[..., lag, :]
        z = torch.sigmoid(matmul(e, w['wz']) + matmul(h, w['uz']) + w['bz'])
        r = torch.sigmoid(matmul(e, w['wr']) + matmul(h, w['ur']) + w['br'])
        hh = torch.tanh(matmul(e, w['wh']) + matmul(r * h, w['uh']) + w['bh'])
        h = (1.0 - z) * h + z * hh
    cols = dense_columns(layout).to(x.device)
    dense = (x[..., cols] - mean[cols]) / std[cols]
    r1 = torch.relu(matmul(torch.cat([h, dense], -1), w['w1']) + w['b1'])
    return torch.sigmoid(matmul(r1, w['w2']) + w['b2'])


def flops_per_action(config: Dict[str, Any]) -> float:
    """FLOPs of both heads for one valid action: at each of the ``k``
    states the three gates' two products (``2·(E·H + H·H)`` each), then the
    readout's two (``2·(H + D)·R + 2·R``)."""
    e, h, r = config['embed_dim'], config['hidden'], config['readout']
    d, k = config['dense_columns'], config['nb_prev_actions']
    per_head = k * 2 * len(GATES) * (e * h + h * h) + 2 * (h + d) * r + 2 * r
    return float(len(HEADS) * per_head)
