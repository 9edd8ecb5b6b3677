"""The GRU sequence head over packed game states.

Port of ``socceraction_tpu/seq/model.py``. A state's ``k`` actions are a
short sequence of tokens: each token is the state's combined categorical
id (:mod:`~socceraction_tpu_torch.ops.fused`), embedded by one
:func:`~socceraction_tpu_torch.ops.fused.table_lookup` over a
``(combo_size, E)`` table, whose backward is the row segment sum, a fixed
order product on the card. A small GRU, unrolled over the ``k`` tokens
oldest to newest, ends on the current action; its last hidden state and
the standardized dense feature columns feed a one-layer ReLU readout to
one logit.

The GRU cell is the JAX package's, not ``torch.nn.GRU``'s: one bias per
gate, the reset gate applied to ``h`` before its product with ``uh``, and
``h = (1 - z)·h + z·hh``.
"""

from __future__ import annotations

import functools
from typing import Any, Dict, Optional, Sequence, Tuple

import numpy as np
import torch
from torch import nn

from ..device import DeviceLike, resolve_device
from ..ml.mlp import _generator
from ..obs import counter, span
from ..obs.dispatch import instrument
from ..obs.numerics import nonfinite_count, note_guard
from ..ops.fused import (
    REGISTRIES,
    STANDARD_REGISTRY,
    FusedRegistry,
    TrainLayout,
    _packed_rows,
    table_lookup,
    train_layout,
)

__all__ = [
    'SeqModule',
    'check_seq_layout',
    'init_seq_params',
    'seq_param_shapes',
    'dense_stats',
    'seq_logits',
    'seq_train_logits',
    'seq_pair_probs',
]

#: The generator stream of a seq head's initial weights (the JAX
#: package's ``fold_in(PRNGKey(seed), 2**31 - 2)``); ``w2`` draws from its
#: sub-stream 7.
_SEQ_INIT_STREAM = 2**31 - 2

_GATES = ('z', 'r', 'h')


def seq_param_shapes(
    *, combo_size: int, n_dense: int, embed_dim: int, hidden: int, readout: int
) -> Dict[str, Any]:
    """The seq head's parameter shapes, as the JAX package's nested dict."""
    gru: Dict[str, Tuple[int, ...]] = {}
    for g in _GATES:
        gru[f'w{g}'] = (embed_dim, hidden)
        gru[f'u{g}'] = (hidden, hidden)
        gru[f'b{g}'] = (hidden,)
    return {
        'embed': (combo_size, embed_dim),
        'gru': gru,
        'readout': {'w1': (hidden + n_dense, readout), 'b1': (readout,), 'w2': (readout,), 'b2': ()},
    }


class _Params(nn.Module):
    """A named group of parameters, made from ``{name: shape}``."""

    def __init__(self, shapes: Dict[str, Tuple[int, ...]]) -> None:
        super().__init__()
        for name, shape in shapes.items():
            self.register_parameter(name, nn.Parameter(torch.zeros(shape)))


class SeqModule(nn.Module):
    """The seq head's parameters: ``embed`` ``(combo_size, E)``, ``gru``
    (``w*`` ``(E, H)``, ``u*`` ``(H, H)``, ``b*`` ``(H,)`` for the gates
    ``z``, ``r``, ``h``) and ``readout`` (``w1`` ``(H + D, R)``, ``b1``,
    ``w2`` ``(R,)``, ``b2`` ``()``). Zero until drawn or loaded."""

    def __init__(
        self, *, combo_size: int, n_dense: int, embed_dim: int, hidden: int, readout: int
    ) -> None:
        super().__init__()
        shapes = seq_param_shapes(
            combo_size=combo_size, n_dense=n_dense, embed_dim=embed_dim, hidden=hidden,
            readout=readout,
        )
        self.embed = nn.Parameter(torch.zeros(shapes['embed']))
        self.gru = _Params(shapes['gru'])
        self.readout = _Params(shapes['readout'])

    def dims(self) -> Dict[str, int]:
        """The constructor arguments, read off the parameter shapes."""
        return {
            'combo_size': self.embed.shape[0],
            'n_dense': self.readout.w1.shape[0] - self.gru.uz.shape[0],
            'embed_dim': self.embed.shape[1],
            'hidden': self.gru.uz.shape[0],
            'readout': self.readout.w1.shape[1],
        }


def init_seq_params(
    seed: int,
    *,
    combo_size: int,
    n_dense: int,
    embed_dim: int,
    hidden: int,
    readout: int,
    device: DeviceLike = None,
) -> SeqModule:
    """Fresh seq parameters on ``device`` (default ``cuda``), drawn as the
    JAX package draws them: every parameter of rank 2 is a unit normal over
    ``sqrt(fan_in)``, in the JAX tree's leaf order (keys sorted), biases are
    zero, and the readout's ``w2`` gets its own draw over ``sqrt(readout)``.
    The draws come from CPU generators of the seed, so every device starts
    from the same weights; the JAX package's have the same distribution,
    not the same values."""
    dev = resolve_device(device)
    module = SeqModule(
        combo_size=combo_size, n_dense=n_dense, embed_dim=embed_dim, hidden=hidden,
        readout=readout,
    )
    params = dict(module.named_parameters())
    gen = _generator(seed, _SEQ_INIT_STREAM)
    with torch.no_grad():
        for name in sorted(params):
            p = params[name]
            if p.dim() >= 2:
                p.copy_(torch.randn(p.shape, generator=gen) / np.sqrt(max(p.shape[0], 1)))
        w2 = module.readout.w2
        w2.copy_(
            torch.randn(w2.shape, generator=_generator(seed, _SEQ_INIT_STREAM, 7))
            / np.sqrt(max(w2.shape[0], 1))
        )
    return module.to(dev)


def dense_stats(
    mean: torch.Tensor, std: torch.Tensor, layout: TrainLayout
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Full-column ``(mean, std)`` cut down to the layout's dense columns,
    the part the seq head standardizes (its one-hot ids are embedded)."""
    spans = [(off, width) for _, kind, off, width in layout.spans if kind == 'dense']
    if not spans:
        return mean.new_zeros((0,)), std.new_ones((0,))
    return (
        torch.cat([mean[off : off + width] for off, width in spans]),
        torch.cat([std[off : off + width] for off, width in spans]),
    )


def _gru_pass(module: SeqModule, emb: torch.Tensor) -> torch.Tensor:
    """The GRU over ``(N, k, E)`` tokens -> the last hidden state ``(N, H)``.

    Token ``i`` is the action ``i`` steps back, so the recurrence runs
    ``i = k-1 .. 0``, oldest to newest, and ends on the current action.
    """
    g = module.gru
    n, k, _ = emb.shape
    h = emb.new_zeros((n, g.uz.shape[0]))
    for i in range(k - 1, -1, -1):
        x = emb[:, i, :]
        z = torch.sigmoid(x @ g.wz + h @ g.uz + g.bz)
        r = torch.sigmoid(x @ g.wr + h @ g.ur + g.br)
        hh = torch.tanh(x @ g.wh + (r * h) @ g.uh + g.bh)
        h = (1.0 - z) * h + z * hh
    return h


def seq_logits(
    module: SeqModule,
    x_dense: torch.Tensor,
    combo_ids: torch.Tensor,
    *,
    dense_mean: torch.Tensor,
    dense_std: torch.Tensor,
) -> torch.Tensor:
    """Differentiable seq-head logits over packed rows -> ``(N,)``.

    One :func:`~socceraction_tpu_torch.ops.fused.table_lookup` embeds the
    whole ``(N, k)`` id matrix, the GRU runs over it, and the readout
    takes the last hidden state beside the standardized dense columns.
    """
    emb = table_lookup(module.embed, combo_ids, int(module.embed.shape[0]))
    h = _gru_pass(module, emb)
    return _readout(module, h, x_dense, dense_mean, dense_std)


def _readout(
    module: SeqModule,
    h: torch.Tensor,
    x_dense: torch.Tensor,
    dense_mean: torch.Tensor,
    dense_std: torch.Tensor,
) -> torch.Tensor:
    """The readout's logits ``(N,)`` of the last hidden state ``h`` beside
    the dense columns, standardized here."""
    dn = (x_dense - dense_mean) / dense_std
    ro = module.readout
    r1 = torch.relu(torch.cat([h, dn.to(h.dtype)], dim=-1) @ ro.w1 + ro.b1)
    return r1 @ ro.w2 + ro.b2


def check_seq_layout(module: SeqModule, layout: TrainLayout) -> None:
    """Raise unless ``module``'s embedding and readout fit ``layout``."""
    registry = layout.registry
    dims = module.dims()
    if dims['combo_size'] != registry.combo_size:
        raise ValueError(
            f"embedding table has {dims['combo_size']} rows but registry "
            f'{layout.registry_name!r} has combo_size={registry.combo_size}'
        )
    if dims['n_dense'] != layout.n_dense:
        raise ValueError(
            f"readout expects {module.readout.w1.shape[0]} inputs but hidden="
            f"{dims['hidden']} plus the layout dense width {layout.n_dense} gives "
            f"{dims['hidden'] + layout.n_dense}"
        )


def seq_train_logits(
    module: SeqModule,
    x_dense: torch.Tensor,
    combo_ids: torch.Tensor,
    *,
    layout: TrainLayout,
    mean: torch.Tensor,
    std: torch.Tensor,
) -> torch.Tensor:
    """Logits ``(N,)`` from full-column statistics (:func:`dense_stats`
    cuts them to the dense columns), after checking that the parameters
    fit the layout (:func:`check_seq_layout`). The steps of
    :func:`seq_logits` run inside the ``seq/embed``, ``seq/gru`` and
    ``seq/readout`` spans (the dense standardization with the readout)."""
    check_seq_layout(module, layout)
    dm, ds = dense_stats(mean, std, layout)
    with span('seq/embed'):
        emb = table_lookup(module.embed, combo_ids, int(module.embed.shape[0]))
    with span('seq/gru'):
        h = _gru_pass(module, emb)
    with span('seq/readout'):
        return _readout(module, h, x_dense, dm, ds)


@functools.partial(instrument, name='seq_pair_probs')
def _seq_pair_dispatch(
    module_a: SeqModule,
    module_b: SeqModule,
    stats_a: Tuple[torch.Tensor, torch.Tensor],
    stats_b: Tuple[torch.Tensor, torch.Tensor],
    batch: Any,
    dense_overrides: Optional[Dict[str, torch.Tensor]],
    *,
    names: Tuple[str, ...],
    k: int,
    registry_name: str,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """The instrumented dispatch behind :func:`seq_pair_probs`, keyed by
    the shapes of what it reads. The feature rows run inside a
    ``vaep/features`` span and both heads, their sigmoids and the guard
    inside ``vaep/head``, each head's stages in :func:`seq_train_logits`'s
    spans. The ``seq/gru_rows`` counter adds the rows that enter the
    recurrence, padding included (``seq/rated_actions`` counts the valid
    ones)."""
    registry = REGISTRIES[registry_name]
    layout = train_layout(names, k, registry)
    with span('vaep/features'):
        x_dense, ids = _packed_rows(
            batch, names=names, k=k, registry=registry, dense_overrides=dense_overrides
        )
    counter('seq/gru_rows', unit='rows').inc(ids.shape[0], platform=ids.device.type)
    shape = (batch.n_games, batch.max_actions)
    with span('vaep/head'):
        pa, pb = (
            torch.sigmoid(
                seq_train_logits(module, x_dense, ids, layout=layout, mean=mean, std=std)
            ).reshape(shape)
            for module, (mean, std) in ((module_a, stats_a), (module_b, stats_b))
        )
        # the JAX package's seq guard: nonfinite probabilities of the whole
        # (padded) batch, counted on the card and left there
        note_guard('seq_pair_probs', 'probs', nonfinite_count(pa, pb))
    return pa, pb


@torch.no_grad()
def seq_pair_probs(
    clf_a: Any,
    clf_b: Any,
    batch: Any,
    *,
    names: Sequence[str],
    k: int,
    registry: FusedRegistry = STANDARD_REGISTRY,
    dense_overrides: Optional[Dict[str, torch.Tensor]] = None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Both seq heads' ``(G, A)`` probabilities over a batch.

    The dense kernels and the combined-id gathers run once, shared by both
    heads; ``dense_overrides[name]`` (``(G, A, width)``) stands in for
    dense kernel ``name``'s block, as in the fused MLP path. The dispatch
    is instrumented as ``seq_pair_probs`` and notes the JAX package's
    guard (``fn='seq_pair_probs'``: nonfinite ``probs``).
    """
    return _seq_pair_dispatch(
        clf_a.module, clf_b.module, (clf_a.mean_, clf_a.std_), (clf_b.mean_, clf_b.std_),
        batch, dense_overrides or None, names=tuple(names), k=k, registry_name=registry.name,
    )
