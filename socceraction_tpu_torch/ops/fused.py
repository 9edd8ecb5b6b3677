"""Fused first-layer MLP serving: one-hot features as combined-table gathers.

Port of the serving half of ``socceraction_tpu/ops/fused.py``. With the
default transformers, 513 of the 568 feature columns at ``k = 3`` are
one-hots, and every one-hot id of a game state is a function of its
(type, result, bodypart) triple. So each state's one-hot blocks fold into
ONE combined ``(23·6·4 = 552, H)`` table of summed ``Dense_0`` rows, and a
model's first layer is

``h = bias + Σ_{i<k} table_i[combo_id_i] + x_dense @ W_dense``

over the small dense sub-tensor only. Standardization ``(x - μ)/σ`` folds
into the weights (``W/σ``) and the bias (``b - μ·W/σ``). Both heads of a
VAEP model stack their first layers to width ``H_a + H_b``, so one gather
per state and one dense product serve both.

The fold is built once per model (:func:`prepare_pair_fold`), optionally
quantized (:mod:`.quant`), and every dispatch goes through the fused
gather + matmul first layer (:mod:`.gather_matmul`): on the card that is
the CUDA kernel, in every quantize mode.
"""

from __future__ import annotations

from typing import Any, Callable, Dict, List, NamedTuple, Optional, Sequence, Tuple

import torch

from ..core.batch import ActionBatch
from ..spadl import config as spadlconfig
from .features import KERNELS, _States, kernel_width
from .gather_matmul import fused_first_layer_quant
from .quant import (
    QuantizedArray,
    check_quantize_mode,
    dequantize,
    quantize_columns,
    quantize_with_scale,
)

__all__ = [
    'FusedRegistry',
    'PreparedPair',
    'STANDARD_REGISTRY',
    'TrainLayout',
    'pair_probs_prepared',
    'prepare_pair_fold',
    'train_layout',
]

_N_TYPES = len(spadlconfig.actiontypes)
_N_RESULTS = len(spadlconfig.results)
_N_BODYPARTS = len(spadlconfig.bodyparts)


class FusedRegistry(NamedTuple):
    """How one feature family's one-hot blocks fold into combined tables.

    ``onehot_widths[name]`` is the block's columns per state;
    ``combo_ids(states, i)`` gives state ``i``'s ``(G, A)`` combined id and
    ``combo_rows[name]`` maps combined ids ``0..combo_size`` to the block's
    own row ids.
    """

    kernels: Dict[str, Callable[[Any], torch.Tensor]]
    make_states: Callable[[ActionBatch, int], Any]
    onehot_widths: Dict[str, int]
    combo_size: int
    combo_ids: Callable[[Any, int], torch.Tensor]
    combo_rows: Dict[str, Callable[[torch.Tensor], torch.Tensor]]


#: Standard SPADL layout; the type-major actiontype×result flattening
#: matches :func:`~.features.compute_features`.
STANDARD_REGISTRY = FusedRegistry(
    kernels=KERNELS,
    make_states=_States,
    onehot_widths={
        'actiontype_onehot': _N_TYPES,
        'result_onehot': _N_RESULTS,
        'actiontype_result_onehot': _N_TYPES * _N_RESULTS,
        'bodypart_onehot': _N_BODYPARTS,
    },
    combo_size=_N_TYPES * _N_RESULTS * _N_BODYPARTS,
    combo_ids=lambda s, i: (
        s.type_id[i] * _N_RESULTS + s.result_id[i]
    ) * _N_BODYPARTS + s.bodypart_id[i],
    combo_rows={
        'actiontype_onehot': lambda c: c // (_N_RESULTS * _N_BODYPARTS),
        'result_onehot': lambda c: (c // _N_BODYPARTS) % _N_RESULTS,
        'actiontype_result_onehot': lambda c: c // _N_BODYPARTS,
        'bodypart_onehot': lambda c: c % _N_BODYPARTS,
    },
)


class TrainLayout(NamedTuple):
    """Static column layout of a feature family: ``spans`` lists
    ``(name, kind, offset, width)`` per transformer in column order, with
    ``kind`` ``'onehot'`` or ``'dense'``."""

    names: Tuple[str, ...]
    k: int
    n_features: int
    spans: Tuple[Tuple[str, str, int, int], ...]


def train_layout(
    names: Sequence[str], k: int, registry: FusedRegistry = STANDARD_REGISTRY
) -> TrainLayout:
    """The feature-column layout of ``names`` at ``k`` states.

    Widths are static (:func:`~.features.kernel_width`), so no kernel runs.
    """
    spans: List[Tuple[str, str, int, int]] = []
    off = 0
    for name in names:
        if name not in registry.kernels:
            raise ValueError(f'unknown feature kernel {name!r}')
        kind = 'onehot' if name in registry.onehot_widths else 'dense'
        width = kernel_width(name, k)
        spans.append((name, kind, off, width))
        off += width
    return TrainLayout(tuple(names), k, off, tuple(spans))


def _layout_split(
    layout: TrainLayout,
) -> Tuple[List[Tuple[str, int, int]], List[Tuple[int, int]]]:
    """``(onehot blocks as (name, per-state width, offset), dense spans as
    (offset, width))`` of a layout."""
    blocks = [
        (name, width // layout.k, off)
        for name, kind, off, width in layout.spans
        if kind == 'onehot'
    ]
    dense_spans = [
        (off, width) for _, kind, off, width in layout.spans if kind == 'dense'
    ]
    return blocks, dense_spans


def _standardized_first_layer(
    mlp: Any, mean: Optional[torch.Tensor], std: Optional[torch.Tensor]
) -> Tuple[torch.Tensor, torch.Tensor]:
    """``Dense_0`` as ``(kernel (in, out), bias)`` with standardization
    folded in: ``(x - μ)/σ @ W + b == x @ (W/σ) + (b - μ @ W/σ)``."""
    d0 = mlp.Dense_0
    Wk = d0.weight.t()
    bias = d0.bias
    if std is not None:
        Wk = Wk / std[:, None]
    if mean is not None:
        bias = bias - mean @ Wk
    return Wk.contiguous(), bias


def _combined_table(
    Wk: torch.Tensor,
    i: int,
    blocks: List[Tuple[str, int, int]],
    registry: FusedRegistry,
) -> torch.Tensor:
    """State ``i``'s combined ``(combo_size, H)`` table: the sum, block by
    block in layout order, of the ``Dense_0`` rows each combined id selects."""
    combo = torch.arange(registry.combo_size, device=Wk.device)
    table = torch.zeros((registry.combo_size, Wk.shape[1]), dtype=Wk.dtype, device=Wk.device)
    for name, per, off in blocks:
        rows = Wk[off + i * per : off + (i + 1) * per]
        table = table + rows[registry.combo_rows[name](combo)]
    return table


def _dense_subkernel(Wk: torch.Tensor, dense_spans: List[Tuple[int, int]]) -> torch.Tensor:
    """The ``(D, H)`` dense rows of a folded kernel, in layout order."""
    if not dense_spans:
        return Wk.new_zeros((0, Wk.shape[1]))
    return torch.cat([Wk[off : off + width] for off, width in dense_spans])


def _hidden_chain(mlp: Any, h: torch.Tensor) -> torch.Tensor:
    """relu + the remaining layers of ``mlp`` on first-layer activations
    -> logits ``h.shape[:-1]``."""
    n_hidden = len(mlp.hidden)
    if n_hidden == 0:
        return h[..., 0]  # Dense_0 is the one-unit output layer
    x = torch.relu(h)
    for li in range(1, n_hidden):
        x = torch.relu(getattr(mlp, f'Dense_{li}')(x))
    return getattr(mlp, f'Dense_{n_hidden}')(x)[..., 0]


class PreparedPair(NamedTuple):
    """A two-head serving fold, built once and optionally quantized.

    ``tables`` is the ``(k, combo_size, H_a + H_b)`` stack of combined
    tables and ``w_dense`` the ``(D, H_a + H_b)`` dense sub-kernel, both
    :class:`~.quant.QuantizedArray` in ``quantize`` storage; ``bias`` is the
    folded f32 bias; ``h_a_width`` splits the stacked hidden axis.
    """

    tables: QuantizedArray
    w_dense: QuantizedArray
    bias: torch.Tensor
    quantize: str
    h_a_width: int


@torch.no_grad()
def prepare_pair_fold(
    clf_a: Any,
    clf_b: Any,
    *,
    names: Sequence[str],
    k: int,
    registry: FusedRegistry = STANDARD_REGISTRY,
    quantize: str = 'none',
    table_scale: Optional[torch.Tensor] = None,
    w_dense_scale: Optional[torch.Tensor] = None,
) -> PreparedPair:
    """Fold two fitted heads into one prepared serving fold.

    ``table_scale``/``w_dense_scale`` pin the int8 scales (a checkpoint's
    ``models/quant_scales.npz``) instead of deriving them from the weights.
    """
    check_quantize_mode(quantize)
    Wk_a, bias_a = _standardized_first_layer(clf_a.module, clf_a.mean_, clf_a.std_)
    Wk_b, bias_b = _standardized_first_layer(clf_b.module, clf_b.mean_, clf_b.std_)
    Wk = torch.cat([Wk_a, Wk_b], dim=1)
    bias = torch.cat([bias_a, bias_b])
    layout = train_layout(names, k, registry)
    if Wk.shape[0] != layout.n_features:
        raise ValueError(
            f'first-layer kernels have {Wk.shape[0]} input rows but the '
            f'feature layout ({layout.names!r}, k={k}) emits '
            f'{layout.n_features} columns'
        )
    blocks, dense_spans = _layout_split(layout)
    tables = torch.stack([_combined_table(Wk, i, blocks, registry) for i in range(k)])
    w_dense = _dense_subkernel(Wk, dense_spans)
    if quantize == 'int8' and (table_scale is not None or w_dense_scale is not None):
        if table_scale is None or w_dense_scale is None:
            raise ValueError('int8 scale pinning needs both table_scale and w_dense_scale')
        t_q = QuantizedArray(*quantize_with_scale(tables, table_scale), table_scale)
        w_q = QuantizedArray(*quantize_with_scale(w_dense, w_dense_scale), w_dense_scale)
    else:
        t_q = quantize_columns(tables, quantize)
        w_q = quantize_columns(w_dense, quantize)
    return PreparedPair(t_q, w_q, bias.contiguous(), quantize, int(Wk_a.shape[1]))


def _packed_rows(
    s: Any,
    batch: ActionBatch,
    *,
    names: Sequence[str],
    k: int,
    registry: FusedRegistry,
    dense_overrides: Optional[Dict[str, torch.Tensor]] = None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """``(x_dense (N, D) f32, combo ids (N, k) int32)`` rows of a batch.

    Dense blocks are concatenated in layout order, with
    ``dense_overrides[name]`` (``(G, A, width)``) in place of kernel
    ``name``'s block.
    """
    G, A = batch.n_games, batch.max_actions
    n = G * A
    blocks: List[torch.Tensor] = []
    for name in names:
        if name in registry.onehot_widths:
            continue
        block = (dense_overrides or {}).get(name)
        if block is None:
            block = registry.kernels[name](s)
        elif tuple(block.shape[:2]) != (G, A):
            raise ValueError(
                f'dense override {name!r} has leading shape '
                f'{tuple(block.shape[:2])}, batch is {(G, A)}'
            )
        blocks.append(block)
    if blocks:
        x_dense = torch.cat(blocks, dim=-1).reshape(n, -1).to(torch.float32).contiguous()
    else:
        x_dense = torch.zeros((n, 0), dtype=torch.float32, device=batch.device)
    ids = torch.stack(
        [registry.combo_ids(s, i).reshape(n) for i in range(k)], dim=1
    ).to(torch.int32)
    return x_dense, ids


@torch.no_grad()
def pair_probs_prepared(
    prep: PreparedPair,
    clf_a: Any,
    clf_b: Any,
    batch: ActionBatch,
    *,
    names: Sequence[str],
    k: int,
    registry: FusedRegistry = STANDARD_REGISTRY,
    dense_overrides: Optional[Dict[str, torch.Tensor]] = None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Both heads' ``(G, A)`` probabilities through the prepared fold.

    Builds the packed rows, runs the fused gather + matmul first layer on
    the (dequantized, for int8) tables, then each head's hidden chain and
    a sigmoid.
    """
    s = registry.make_states(batch, k)
    x_dense, ids = _packed_rows(
        s, batch, names=names, k=k, registry=registry, dense_overrides=dense_overrides
    )
    if x_dense.shape[1] != prep.w_dense.data.shape[0]:
        raise ValueError(
            f'prepared fold has a {prep.w_dense.data.shape[0]}-column dense '
            f'sub-kernel but the feature layout ({tuple(names)!r}, k={k}) emits '
            f'{x_dense.shape[1]} dense columns'
        )
    # int8 storage expands to a transient f32 table per dispatch; bf16
    # rides into the kernel and is widened there
    int8 = prep.quantize == 'int8'
    tables = dequantize(*prep.tables) if int8 else prep.tables.data
    w_dense = dequantize(*prep.w_dense) if int8 else prep.w_dense.data
    h = fused_first_layer_quant(tables, w_dense, prep.bias, ids, x_dense)
    h = h.reshape(batch.n_games, batch.max_actions, -1)
    a = _hidden_chain(clf_a.module, h[..., : prep.h_a_width])
    b = _hidden_chain(clf_b.module, h[..., prep.h_a_width :])
    return torch.sigmoid(a), torch.sigmoid(b)
