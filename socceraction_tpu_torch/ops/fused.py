"""Fused first-layer MLP: one-hot features as combined-table gathers.

Port of ``socceraction_tpu/ops/fused.py``. With the
default transformers, 513 of the 568 feature columns at ``k = 3`` are
one-hots, and every one-hot id of a game state is a function of its
(type, result, bodypart) triple. So each state's one-hot blocks fold into
ONE combined ``(23·6·4 = 552, H)`` table of summed ``Dense_0`` rows (for
Atomic-SPADL, 108 of 154 columns and a ``(32·4 = 128, H)`` table of
(type group, bodypart)), and a model's first layer is

``h = bias + Σ_{i<k} table_i[combo_id_i] + x_dense @ W_dense``

over the small dense sub-tensor only. Standardization ``(x - μ)/σ`` folds
into the weights (``W/σ``) and the bias (``b - μ·W/σ``). Both heads of a
VAEP model stack their first layers to width ``H_a + H_b``, so one gather
per state and one dense product serve both.

The serving fold is built once per model (:func:`prepare_pair_fold`),
optionally quantized (:mod:`.quant`), and every dispatch goes through the
fused gather + matmul first layer (:mod:`.gather_matmul`): on the card
that is the CUDA kernel, in every quantize mode.

Training keeps the batch packed too (:func:`build_train_states`): the raw
dense columns, the per-state combined ids and a validity weight per row.
:func:`fused_train_logits` re-folds the combined tables from the master
``Dense_0`` weights every step, so gradients reach the ordinary
parameters, and runs the differentiable first layer, whose forward is the
same kernel. :func:`packed_feature_stats` standardizes without the
feature matrix: a one-hot column's moments are a function of its
activation frequency, read off segment-sum histograms of the ids.
"""

from __future__ import annotations

import functools
from typing import Any, Callable, Dict, List, NamedTuple, Optional, Sequence, Tuple

import torch

from ..atomic.spadl import config as atomicconfig
from ..obs.dispatch import instrument
from ..obs.numerics import guards_enabled, nonfinite_count, note_guard, overflow_count
from ..spadl import config as spadlconfig
from .atomic import _ONEHOT_GROUPS, ATOMIC_KERNELS, ATOMIC_WIDTHS, _AtomicStates
from .features import _WIDTHS, KERNELS, _States, kernel_width
from .gather_matmul import first_layer_cost, fused_first_layer, fused_first_layer_quant
from .quant import (
    QuantizedArray,
    check_quantize_mode,
    dequantize,
    fake_quant,
    quantize_columns,
    quantize_with_scale,
    quantized_nbytes,
)
from .segment import segment_sum, segment_sum_rows

__all__ = [
    'FusedRegistry',
    'STANDARD_REGISTRY',
    'ATOMIC_REGISTRY',
    'REGISTRIES',
    'onehot_blocks',
    'fused_mlp_logits',
    'fused_pair_logits',
    'PreparedPair',
    'prepare_pair_fold',
    'TrainStates',
    'TrainLayout',
    'train_layout',
    'build_train_states',
    'concat_train_states',
    'pair_probs_prepared',
    'packed_feature_stats',
    'table_lookup',
    'take_train_states',
    'fused_train_logits',
]

_N_TYPES = len(spadlconfig.actiontypes)
_N_RESULTS = len(spadlconfig.results)
_N_BODYPARTS = len(spadlconfig.bodyparts)


class FusedRegistry(NamedTuple):
    """How one feature family's one-hot blocks fold into combined tables.

    ``name`` is the family's key in :data:`REGISTRIES`; ``widths[name]``
    the ``(per state, per previous state, fixed)`` column multipliers of
    each kernel; ``onehot_widths[name]`` a one-hot block's columns per
    state; ``combo_ids(states, i)`` gives state ``i``'s ``(G, A)``
    combined id and ``combo_rows[name]`` maps combined ids
    ``0..combo_size`` to the block's own row ids.
    """

    name: str
    kernels: Dict[str, Callable[[Any], torch.Tensor]]
    widths: Dict[str, Tuple[int, int, int]]
    make_states: Callable[[Any, int], Any]
    onehot_widths: Dict[str, int]
    combo_size: int
    combo_ids: Callable[[Any, int], torch.Tensor]
    combo_rows: Dict[str, Callable[[torch.Tensor], torch.Tensor]]


#: Standard SPADL layout; the type-major actiontype×result flattening
#: matches :func:`~.features.compute_features`.
STANDARD_REGISTRY = FusedRegistry(
    name='standard',
    kernels=KERNELS,
    widths=_WIDTHS,
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

# Atomic one-hot columns are merged groups (both 'interception' ids share
# one): a type id -> group index table keeps the group one-hot a single
# row gather. Built from the kernel's own group table, so the two agree.
_N_ATOMIC_GROUPS = len(_ONEHOT_GROUPS)
_N_ATOMIC_BODYPARTS = len(atomicconfig.bodyparts)
_ATOMIC_GROUP_OF_TYPE = [0] * len(atomicconfig.actiontypes)
for _g, (_, _ids) in enumerate(_ONEHOT_GROUPS):
    for _t in _ids:
        _ATOMIC_GROUP_OF_TYPE[_t] = _g


@functools.lru_cache(maxsize=None)
def _atomic_group_table(device: torch.device) -> torch.Tensor:
    """The type id -> group table on ``device``, made once per device: a
    copy from the host on every call would wait for the card."""
    return torch.tensor(_ATOMIC_GROUP_OF_TYPE, dtype=torch.int32, device=device)


def _atomic_group(type_id: torch.Tensor) -> torch.Tensor:
    """The one-hot group of each atomic type id."""
    return _atomic_group_table(type_id.device)[type_id.long()]


#: Atomic-SPADL layout (:mod:`.atomic`): 32 type groups x 4 bodyparts.
ATOMIC_REGISTRY = FusedRegistry(
    name='atomic',
    kernels=ATOMIC_KERNELS,
    widths=ATOMIC_WIDTHS,
    make_states=_AtomicStates,
    onehot_widths={
        'actiontype_onehot': _N_ATOMIC_GROUPS,
        'bodypart_onehot': _N_ATOMIC_BODYPARTS,
    },
    combo_size=_N_ATOMIC_GROUPS * _N_ATOMIC_BODYPARTS,
    combo_ids=lambda s, i: _atomic_group(s.type_id[i]) * _N_ATOMIC_BODYPARTS + s.bodypart_id[i],
    combo_rows={
        'actiontype_onehot': lambda c: c // _N_ATOMIC_BODYPARTS,
        'bodypart_onehot': lambda c: c % _N_ATOMIC_BODYPARTS,
    },
)

#: Feature families by name (the JAX package's ``REGISTRIES``).
REGISTRIES: Dict[str, FusedRegistry] = {
    'standard': STANDARD_REGISTRY,
    'atomic': ATOMIC_REGISTRY,
}


class TrainLayout(NamedTuple):
    """Static column layout of a feature family: ``spans`` lists
    ``(name, kind, offset, width)`` per transformer in column order, with
    ``kind`` ``'onehot'`` or ``'dense'``; ``registry_name`` names the
    family in :data:`REGISTRIES`."""

    names: Tuple[str, ...]
    k: int
    n_features: int
    spans: Tuple[Tuple[str, str, int, int], ...]
    registry_name: str = 'standard'

    @property
    def registry(self) -> FusedRegistry:
        """The family's :class:`FusedRegistry`."""
        return REGISTRIES[self.registry_name]

    @property
    def n_dense(self) -> int:
        """Columns of the dense sub-tensor."""
        return sum(width for _, kind, _, width in self.spans if kind == 'dense')


def train_layout(
    names: Sequence[str], k: int, registry: FusedRegistry = STANDARD_REGISTRY
) -> TrainLayout:
    """The feature-column layout of ``names`` at ``k`` states.

    Widths are static (``registry.widths``), so no kernel runs.
    """
    spans: List[Tuple[str, str, int, int]] = []
    off = 0
    for name in names:
        if name not in registry.kernels:
            raise ValueError(f'unknown feature kernel {name!r}')
        kind = 'onehot' if name in registry.onehot_widths else 'dense'
        width = kernel_width(name, k, registry.widths)
        spans.append((name, kind, off, width))
        off += width
    return TrainLayout(tuple(names), k, off, tuple(spans), registry.name)


def onehot_blocks(names: Sequence[str], registry: FusedRegistry = STANDARD_REGISTRY) -> List[str]:
    """The kernels of ``names`` that the fold applies as table gathers."""
    return [n for n in names if n in registry.onehot_widths]


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


def _fold_tables(Wk: torch.Tensor, layout: TrainLayout) -> Tuple[torch.Tensor, torch.Tensor]:
    """A folded first-layer kernel ``Wk`` (one head's, or several stacked
    along the output axis) as ``(k, combo_size, H)`` combined tables and
    the ``(D, H)`` dense sub-kernel; raises unless ``Wk`` has the layout's
    input rows."""
    if Wk.shape[0] != layout.n_features:
        raise ValueError(
            f'first-layer kernel has {Wk.shape[0]} input rows but the '
            f'feature layout ({layout.names!r}, k={layout.k}) emits '
            f'{layout.n_features} columns'
        )
    blocks, dense_spans = _layout_split(layout)
    tables = torch.stack(
        [_combined_table(Wk, i, blocks, layout.registry) for i in range(layout.k)]
    )
    return tables, _dense_subkernel(Wk, dense_spans)


def _hidden_chain(
    mlp: Any, h: torch.Tensor, hidden_dtype: Optional[torch.dtype] = None
) -> torch.Tensor:
    """relu + the remaining layers of ``mlp`` on first-layer activations
    -> logits ``h.shape[:-1]``.

    ``hidden_dtype`` (e.g. ``torch.bfloat16``) casts the post-relu hidden
    pipeline, activations and hidden-layer weights, to a narrower type,
    rounding after each product and each bias add as the JAX package's
    ``x @ kern + bias`` does; the logit head goes back to the type of ``h``.
    """
    n_hidden = len(mlp.hidden)
    if n_hidden == 0:
        return h[..., 0]  # Dense_0 is the one-unit output layer
    x = torch.relu(h)
    if hidden_dtype is None:
        for li in range(1, n_hidden):
            x = torch.relu(getattr(mlp, f'Dense_{li}')(x))
        return getattr(mlp, f'Dense_{n_hidden}')(x)[..., 0]
    x = x.to(hidden_dtype)
    for li in range(1, n_hidden):
        d = getattr(mlp, f'Dense_{li}')
        x = torch.relu(x @ d.weight.to(hidden_dtype).t() + d.bias.to(hidden_dtype))
    return getattr(mlp, f'Dense_{n_hidden}')(x.to(h.dtype))[..., 0]


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

    @property
    def table_nbytes(self) -> int:
        """Device bytes of the combined tables (planes and int8 scales):
        what the quantize modes trade against each other."""
        return quantized_nbytes(self.tables)

    def arrays(self) -> List[torch.Tensor]:
        """The fold's device tensors (for residency claims)."""
        return [a for a in (*self.tables, *self.w_dense, self.bias) if a is not None]


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
    tables, w_dense = _fold_tables(Wk, train_layout(names, k, registry))
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
    batch: Any,
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


def _pair_cost(
    prep: PreparedPair, mlp_a: Any, mlp_b: Any, batch: Any, dense_overrides: Any, *,
    names: Tuple[str, ...], k: int, registry_name: str,
    hidden_dtype: Optional[torch.dtype] = None,
) -> Tuple[float, float]:
    """Analytic ``(flops, bytes)`` of one pair dispatch, from shapes.

    B1's operands and output (:func:`~.gather_matmul.first_layer_cost`,
    every id counted: the data is not read), then each head's hidden
    chain: every later layer's input, weights and bias read and its
    output written (in ``hidden_dtype``'s width), ``2·N·in·out``
    operations each, and the sigmoid's output written. The batch's own
    reads by the feature kernels are not counted, so the cost is a lower
    bound of what moves.
    """
    esize = 4 if hidden_dtype is None else torch.empty((), dtype=hidden_dtype).element_size()
    n = batch.n_games * batch.max_actions
    kt, r, h = prep.tables.data.shape
    table_dtype = torch.float32 if prep.quantize == 'int8' else prep.tables.data.dtype
    b1 = first_layer_cost(n, kt, r, h, prep.w_dense.data.shape[0], table_dtype=table_dtype)
    flops, nbytes = b1['flops'], b1['bytes']
    for mlp in (mlp_a, mlp_b):
        for layer in mlp.layers()[1:]:
            fi, fo = layer.in_features, layer.out_features
            flops += 2 * n * fi * fo
            nbytes += esize * (n * fi + fi * fo + fo + n * fo)
        nbytes += 4 * n
    return flops, nbytes


@functools.partial(instrument, name='pair_probs', cost=_pair_cost, storm_threshold=16)
def _pair_dispatch(
    prep: PreparedPair,
    mlp_a: Any,
    mlp_b: Any,
    batch: Any,
    dense_overrides: Optional[Dict[str, torch.Tensor]],
    *,
    names: Tuple[str, ...],
    k: int,
    registry_name: str,
    hidden_dtype: Optional[torch.dtype] = None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """The instrumented pair dispatch behind :func:`pair_probs_prepared`:
    its arguments are the tensors and modules it reads, so the dispatch
    observatory keys it by their shapes."""
    registry = REGISTRIES[registry_name]
    s = registry.make_states(batch, k)
    x_dense, ids = _packed_rows(
        s, batch, names=names, k=k, registry=registry, dense_overrides=dense_overrides
    )
    if x_dense.shape[1] != prep.w_dense.data.shape[0]:
        raise ValueError(
            f'prepared fold has a {prep.w_dense.data.shape[0]}-column dense '
            f'sub-kernel but the feature layout ({names!r}, k={k}) emits '
            f'{x_dense.shape[1]} dense columns'
        )
    # int8 storage expands to a transient f32 table per dispatch; bf16
    # rides into the kernel and is widened there
    int8 = prep.quantize == 'int8'
    tables = dequantize(*prep.tables) if int8 else prep.tables.data
    w_dense = dequantize(*prep.w_dense) if int8 else prep.w_dense.data
    h = fused_first_layer_quant(tables, w_dense, prep.bias, ids, x_dense)
    h = h.reshape(batch.n_games, batch.max_actions, -1)
    a = _hidden_chain(mlp_a, h[..., : prep.h_a_width], hidden_dtype)
    b = _hidden_chain(mlp_b, h[..., prep.h_a_width :], hidden_dtype)
    pa, pb = torch.sigmoid(a), torch.sigmoid(b)
    if guards_enabled():
        # in-dispatch guard, counted on the card beside the outputs and
        # left there (no host read): nonfinite probabilities, what
        # callers consume (an Inf logit serves a finite 0/1), and logits
        # past the sigmoid's saturation; padding games are counted too
        note_guard('pair_probs', 'probs', nonfinite_count(pa, pb))
        note_guard('pair_probs', 'logits', overflow_count(a, b), kind='overflow')
    return pa, pb


@torch.no_grad()
def pair_probs_prepared(
    prep: PreparedPair,
    clf_a: Any,
    clf_b: Any,
    batch: Any,
    *,
    names: Sequence[str],
    k: int,
    registry: FusedRegistry = STANDARD_REGISTRY,
    dense_overrides: Optional[Dict[str, torch.Tensor]] = None,
    hidden_dtype: Optional[torch.dtype] = None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Both heads' ``(G, A)`` probabilities through the prepared fold.

    Builds the packed rows, runs the fused gather + matmul first layer on
    the (dequantized, for int8) tables, then each head's hidden chain
    (narrowed to ``hidden_dtype`` after the first layer's relu, as
    :func:`_hidden_chain` does) and a sigmoid. The dispatch is
    instrumented as ``pair_probs``
    (:mod:`~socceraction_tpu_torch.obs.dispatch`) and, unless
    ``SOCCERACTION_TPU_NUM_GUARDS=0``, notes the JAX package's numeric
    guards (``fn='pair_probs'``: nonfinite ``probs``, ``logits`` past 88)
    for a later :func:`~socceraction_tpu_torch.obs.numerics.drain_guards`.
    """
    return _pair_dispatch(
        prep, clf_a.module, clf_b.module, batch, dense_overrides or None,
        names=tuple(names), k=k, registry_name=registry.name, hidden_dtype=hidden_dtype,
    )


def _fold_first_layer(
    Wk: torch.Tensor,
    bias: torch.Tensor,
    batch: Any,
    *,
    names: Sequence[str],
    k: int,
    registry: FusedRegistry,
    dense_overrides: Optional[Dict[str, torch.Tensor]],
) -> torch.Tensor:
    """First-layer activations ``(G, A, H)`` of a folded kernel ``Wk``
    (one head's, or several stacked along the output axis): the combined
    tables and the dense sub-kernel folded from it, then one launch of
    :func:`~.gather_matmul.fused_first_layer` (kernel B1 on the card)."""
    tables, w_dense = _fold_tables(Wk, train_layout(names, k, registry))
    s = registry.make_states(batch, k)
    x_dense, ids = _packed_rows(
        s, batch, names=names, k=k, registry=registry, dense_overrides=dense_overrides
    )
    h = fused_first_layer(tables, w_dense, bias, ids, x_dense)
    return h.reshape(batch.n_games, batch.max_actions, -1)


def fused_mlp_logits(
    mlp: Any,
    batch: Any,
    *,
    names: Sequence[str],
    k: int,
    mean: Optional[torch.Tensor] = None,
    std: Optional[torch.Tensor] = None,
    registry: FusedRegistry = STANDARD_REGISTRY,
    dense_overrides: Optional[Dict[str, torch.Tensor]] = None,
    hidden_dtype: Optional[torch.dtype] = None,
) -> torch.Tensor:
    """``(G, A)`` logits of ``mlp`` (an :class:`~..ml.mlp.MLP`) over a batch.

    The function ``mlp((compute_features(batch) - mean) / std)`` computes,
    without the feature tensor: standardization folds into ``Dense_0``,
    its one-hot rows into per-state combined tables, and the first layer
    is one launch of :func:`~.gather_matmul.fused_first_layer` (kernel B1
    on the card; differentiable). ``dense_overrides[name]`` (``(G, A,
    width)``) stands in for dense kernel ``name``'s block; ``hidden_dtype``
    narrows the hidden chain after the first layer's relu
    (:func:`_hidden_chain`), the first layer staying f32.
    """
    Wk, bias = _standardized_first_layer(mlp, mean, std)
    h = _fold_first_layer(
        Wk, bias, batch, names=names, k=k, registry=registry, dense_overrides=dense_overrides
    )
    return _hidden_chain(mlp, h, hidden_dtype)


def fused_pair_logits(
    mlp_a: Any,
    mlp_b: Any,
    batch: Any,
    *,
    names: Sequence[str],
    k: int,
    mean_a: Optional[torch.Tensor] = None,
    std_a: Optional[torch.Tensor] = None,
    mean_b: Optional[torch.Tensor] = None,
    std_b: Optional[torch.Tensor] = None,
    registry: FusedRegistry = STANDARD_REGISTRY,
    dense_overrides: Optional[Dict[str, torch.Tensor]] = None,
    hidden_dtype: Optional[torch.dtype] = None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Two heads' ``(G, A)`` logits with their first layers stacked.

    :func:`fused_mlp_logits` for both heads at once: both folded
    ``Dense_0`` kernels side by side (width ``H_a + H_b``), so one launch
    of the first layer serves both; the heads' widths and depths may
    differ. Folds the weights on every call; serving caches its fold
    (:func:`prepare_pair_fold`, :func:`pair_probs_prepared`).
    """
    Wk_a, bias_a = _standardized_first_layer(mlp_a, mean_a, std_a)
    Wk_b, bias_b = _standardized_first_layer(mlp_b, mean_b, std_b)
    h = _fold_first_layer(
        torch.cat([Wk_a, Wk_b], dim=1), torch.cat([bias_a, bias_b]), batch,
        names=names, k=k, registry=registry, dense_overrides=dense_overrides,
    )
    width = Wk_a.shape[1]
    return (
        _hidden_chain(mlp_a, h[..., :width], hidden_dtype),
        _hidden_chain(mlp_b, h[..., width:], hidden_dtype),
    )


# -- training ------------------------------------------------------------------


class TrainStates(NamedTuple):
    """Packed per-action training rows, flattened over ``(G, A)``.

    ``x_dense`` holds the raw (unstandardized) dense columns:
    standardization folds into the weights at apply time, as in serving.
    Padding rows carry ``weight == 0`` and count in no loss.
    """

    x_dense: torch.Tensor  # (N, D) f32 raw dense feature columns
    combo_ids: torch.Tensor  # (N, k) int32 combined categorical id per state
    weight: torch.Tensor  # (N,) f32 validity weight (0 on padding rows)


def build_train_states(
    batch: Any,
    *,
    names: Sequence[str],
    k: int,
    registry: FusedRegistry = STANDARD_REGISTRY,
) -> Tuple[TrainStates, TrainLayout]:
    """Pack a batch into its training representation and layout.

    The dense sub-tensor (55 of the 568 columns at the defaults), the
    combined ids and the validity weights; the feature matrix is never
    formed.
    """
    layout = train_layout(names, k, registry)
    s = registry.make_states(batch, k)
    x_dense, ids = _packed_rows(s, batch, names=names, k=k, registry=registry)
    weight = batch.mask.reshape(-1).to(torch.float32)
    return TrainStates(x_dense, ids, weight), layout


def concat_train_states(chunks: Sequence[TrainStates]) -> TrainStates:
    """Concatenate training states along the row axis."""
    if not chunks:
        raise ValueError('cannot concatenate zero TrainStates chunks')
    if len(chunks) == 1:
        return chunks[0]
    return TrainStates(*(torch.cat(parts) for parts in zip(*chunks)))


def take_train_states(states: TrainStates, rows: torch.Tensor) -> TrainStates:
    """The training states of ``rows`` (an index tensor on their device)."""
    return TrainStates(*(t.index_select(0, rows) for t in states))


def packed_feature_stats(
    states: TrainStates, layout: TrainLayout
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Per-feature-column ``(mean, std)`` f32 from the packed form.

    Equals ``X.mean(0)`` / ``X.std(0)`` over the valid rows of the feature
    matrix without building it. A one-hot column's moments are
    ``μ = p``, ``σ = √(p(1 - p))``, with ``p`` read off weight histograms
    of the combined ids: one :func:`~.segment.segment_sum` of the rows
    into the combined ids per state, then one of each histogram into each
    block's own rows (``k + k · blocks`` launches of kernel B2 on the
    card). Dense columns use weighted two-pass moments, accumulated in
    float64 so that the card and the CPU, which reduce in other orders,
    agree to the last f32 bit or so. ``std`` is raw (zero where a column is
    constant); callers guard it.
    """
    registry = layout.registry
    w = states.weight
    n = torch.clamp(w.sum(), min=1.0)
    combo = torch.arange(registry.combo_size, device=w.device)
    counts = [
        segment_sum(w, states.combo_ids[:, i], registry.combo_size) for i in range(layout.k)
    ]
    mean_parts: List[torch.Tensor] = []
    var_parts: List[torch.Tensor] = []
    w64, n64 = w.to(torch.float64), n.to(torch.float64)
    dense_off = 0
    for name, kind, _off, width in layout.spans:
        if kind == 'onehot':
            per = width // layout.k
            rows = registry.combo_rows[name](combo)
            for i in range(layout.k):
                p = segment_sum(counts[i], rows, per) / n
                mean_parts.append(p)
                var_parts.append(p * (1.0 - p))
        else:
            x = states.x_dense[:, dense_off : dense_off + width].to(torch.float64)
            dense_off += width
            mu = (w64 @ x) / n64
            var = (w64 @ torch.square(x - mu)) / n64  # two-pass, like np.std
            mean_parts.append(mu.to(torch.float32))
            var_parts.append(var.to(torch.float32))
    return (
        torch.cat(mean_parts).to(torch.float32),
        torch.sqrt(torch.cat(var_parts)).to(torch.float32),
    )


class _TableLookup(torch.autograd.Function):
    @staticmethod
    def forward(ctx: Any, table: torch.Tensor, ids: torch.Tensor, num_rows: int) -> torch.Tensor:
        ctx.save_for_backward(ids)
        ctx.num_rows = num_rows
        return table[ids.long()]

    @staticmethod
    def backward(ctx: Any, g: torch.Tensor) -> Tuple[torch.Tensor, None, None]:
        (ids,) = ctx.saved_tensors
        return segment_sum_rows(g, ids, ctx.num_rows), None, None


def table_lookup(table: torch.Tensor, ids: torch.Tensor, num_rows: int) -> torch.Tensor:
    """``table[ids]`` whose backward is the row segment sum of the cotangent.

    The per-gather form of the fused first layer's table term (the JAX
    package's ``table_lookup``): ids lie in ``[0, num_rows)``.
    """
    return _TableLookup.apply(table, ids, num_rows)


def fused_train_logits(
    mlp: Any,
    x_dense: torch.Tensor,
    combo_ids: torch.Tensor,
    *,
    layout: TrainLayout,
    mean: Optional[torch.Tensor] = None,
    std: Optional[torch.Tensor] = None,
    compute_dtype: Optional[torch.dtype] = None,
    quantize: str = 'none',
) -> torch.Tensor:
    """Differentiable logits ``(N,)`` of ``mlp`` over packed training rows.

    The same function of the parameters as ``mlp((features - mean) /
    std)`` on the feature matrix: standardization folds into ``Dense_0``
    (:func:`_standardized_first_layer`), the per-state combined tables are
    folded from its rows every call, and the first layer runs through
    :func:`~.gather_matmul.fused_first_layer` (kernel B1 on the card, the
    plain version on the CPU), in f32 whatever ``compute_dtype`` is, as the
    JAX package's fused-kernel branch does. ``compute_dtype`` narrows the
    post-relu hidden pipeline (:func:`_hidden_chain`). ``quantize`` other
    than ``'none'`` trains quantization-aware: the tables and the dense
    sub-kernel pass through :func:`~.quant.fake_quant`.
    """
    check_quantize_mode(quantize)
    Wk, bias = _standardized_first_layer(mlp, mean, std)
    tables, w_dense = _fold_tables(Wk, layout)
    tables = fake_quant(tables, quantize)
    if w_dense.shape[0] and x_dense.shape[1]:
        w_dense = fake_quant(w_dense, quantize)
    else:
        w_dense = Wk.new_zeros((0, Wk.shape[1]))
    h = fused_first_layer(tables, w_dense, bias, combo_ids, x_dense)
    return _hidden_chain(mlp, h, compute_dtype)
