"""Distributed VAEP training and rating (port of ``socceraction_tpu/parallel/vaep.py``).

Both MLP heads train jointly from the packed batch, with the feature and
label kernels inside the step: the batch is split over the ``'games'``
axis, and the heads' hidden layers may also be split over ``'model'``
(Megatron's column and row split). The JAX package leaves its
collectives to XLA; here they are written out:

- **data parallel.** The loss is the global masked mean of the JAX
  package's ``_masked_bce``: each rank divides its own ``Σ bce·w`` by the
  all-reduced ``Σ w``, and the gradients are all-reduced with ``SUM``
  over ``'games'``. ``DistributedDataParallel`` would divide a sum of
  per-rank means by the world size instead, which equals the global mean
  only when every shard holds as many valid actions; padding games and
  ragged games make them differ.
- **tensor parallel.** Even hidden layers are split by output units
  (the first of them is kernel B1, which then gathers a column slice of
  the stacked tables, ``W_dense`` and the bias), odd ones by input units
  with an all-reduce of their partial outputs before the bias; the logit
  layer is replicated. The activations entering a column-split layer, or
  the logit layer, are whole on every rank of a ``'model'`` line, so the
  loss is computed the same on each of them and a replicated parameter
  gets the same gradient there.

Parameters start the same on every rank (drawn from one CPU generator,
or given) and Adam updates them identically, so after every step all
ranks hold the same bits; :func:`gather_params` assembles the split
layers.
"""

from __future__ import annotations

from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from ..device import resolve_device
from ..ml.mlp import _INIT_STREAM, MLP, AdamState, MLPClassifier, _generator, adam_update, init_mlp
from ..ops.fused import STANDARD_REGISTRY, _fold_first_layer, train_layout
from ..ops.labels import scores_concedes
from .collectives import all_gather, all_reduce_sum, group_rank, group_size
from .mesh import axis_group, axis_index, axis_size, mark_shard, shard_batch

__all__ = [
    'data_parallel_rate',
    'gather_params',
    'make_train_step',
    'param_shardings',
    'sharded_rate',
    'train_distributed',
]

#: The two heads, in the order their parameters are laid out.
HEADS = ('scores', 'concedes')

#: Local parameters of both heads: ``{head: [W_0, b_0, W_1, b_1, ...]}`` in
#: ``nn.Linear`` orientation (``W`` is ``(out, in)``), this rank's slices.
Params = Dict[str, List[torch.Tensor]]


def _layer_kind(i: int, n_layers: int) -> str:
    """``'col'`` (split by output units), ``'row'`` (by input units) or
    ``'rep'`` (the logit layer, replicated) for ``Dense_i``."""
    if i == n_layers - 1:
        return 'rep'
    return 'col' if i % 2 == 0 else 'row'


def param_shardings(module: MLP, mesh: Any) -> Dict[str, Dict[str, Tuple[Any, ...]]]:
    """Megatron placements of an :class:`~..ml.mlp.MLP`'s parameters.

    ``{'Dense_i': {'weight': placements, 'bias': placements}}`` over the
    mesh's axes: even hidden layers split their ``(out, in)`` weight and
    their bias by output units over ``'model'``, odd ones their weight by
    input units (bias replicated), and the logit layer is replicated.
    With ``model_parallel == 1`` every split is of one piece.
    """
    from torch.distributed.tensor import Replicate, Shard

    n = len(module.layers())

    def over_model(p: Any) -> Tuple[Any, ...]:
        return tuple(p if name == 'model' else Replicate() for name in mesh.mesh_dim_names)

    out = {}
    for i in range(n):
        kind = _layer_kind(i, n)
        weight = {'col': Shard(0), 'row': Shard(1), 'rep': Replicate()}[kind]
        bias = Shard(0) if kind == 'col' else Replicate()
        out[f'Dense_{i}'] = {'weight': over_model(weight), 'bias': over_model(bias)}
    return out


def _local(t: torch.Tensor, placements: Tuple[Any, ...], mesh: Any) -> torch.Tensor:
    """This rank's piece of a whole tensor under ``placements``."""
    for name, p in zip(mesh.mesh_dim_names, placements):
        if p.is_shard():
            n, i = axis_size(mesh, name), axis_index(mesh, name)
            if t.shape[p.dim] % n:
                raise ValueError(
                    f'a dimension of {t.shape[p.dim]} does not split over {name}={n}'
                )
            t = t.chunk(n, dim=p.dim)[i]
    return t


def _shard_module(module: MLP, mesh: Any, device: torch.device) -> List[torch.Tensor]:
    placements = param_shardings(module, mesh)
    flat = []
    for i, layer in enumerate(module.layers()):
        spec = placements[f'Dense_{i}']
        for leaf in ('weight', 'bias'):
            t = _local(getattr(layer, leaf).detach(), spec[leaf], mesh)
            flat.append(t.to(device, copy=True).contiguous().requires_grad_(True))
    return flat


def gather_params(params: Params, mesh: Any, hidden: Sequence[int]) -> Dict[str, MLP]:
    """The whole :class:`~..ml.mlp.MLP` of each head from every rank's
    slices (an all-gather over ``'model'`` for each split layer), on the
    slices' device; the same on every rank."""
    group = axis_group(mesh, 'model')
    out = {}
    for head, flat in params.items():
        n_features = flat[0].shape[1]
        module = MLP(n_features, hidden).to(flat[0].device)
        placements = param_shardings(module, mesh)
        with torch.no_grad():
            for i, layer in enumerate(module.layers()):
                spec = placements[f'Dense_{i}']
                for j, leaf in enumerate(('weight', 'bias')):
                    t = flat[2 * i + j].detach()
                    p = spec[leaf][mesh.mesh_dim_names.index('model')]
                    if p.is_shard():
                        t = torch.cat(all_gather(t, group).unbind(0), dim=p.dim)
                    getattr(layer, leaf).copy_(t)
        out[head] = module.requires_grad_(False)
    return out


# -- the tensor-parallel hidden chain ---------------------------------------------


class _SumOverModel(torch.autograd.Function):
    """Forward: all-reduce the partial outputs of a row-split layer.
    Backward: the cotangent as it is (it is the same on every rank)."""

    @staticmethod
    def forward(ctx: Any, x: torch.Tensor, group: Any) -> torch.Tensor:
        return all_reduce_sum([x], group)[0]

    @staticmethod
    def backward(ctx: Any, g: torch.Tensor) -> Tuple[torch.Tensor, None]:
        return g, None


class _EnterSplit(torch.autograd.Function):
    """Forward: a whole activation into a column-split layer, as it is.
    Backward: its cotangent summed over ``'model'`` (each rank's slice of
    the layer contributes one term)."""

    @staticmethod
    def forward(ctx: Any, x: torch.Tensor, group: Any) -> torch.Tensor:
        ctx.group = group
        return x.view_as(x)

    @staticmethod
    def backward(ctx: Any, g: torch.Tensor) -> Tuple[torch.Tensor, None]:
        return all_reduce_sum([g], ctx.group)[0], None


class _GatherSplit(torch.autograd.Function):
    """Forward: the slices of a column-split activation joined along the
    last axis. Backward: this rank's slice of the cotangent."""

    @staticmethod
    def forward(ctx: Any, x: torch.Tensor, group: Any) -> torch.Tensor:
        ctx.width, ctx.index = x.shape[-1], group_rank(group)
        return torch.cat(all_gather(x, group).unbind(0), dim=-1)

    @staticmethod
    def backward(ctx: Any, g: torch.Tensor) -> Tuple[torch.Tensor, None]:
        return g[..., ctx.index * ctx.width : (ctx.index + 1) * ctx.width], None


def _head_logits(flat: List[torch.Tensor], h: torch.Tensor, group: Any) -> torch.Tensor:
    """Logits of one head from its first-layer activations ``h`` (this
    rank's columns of a split first layer). With one rank on ``'model'``
    every layer is one ``F.linear``, the ops of the unsharded chain."""
    n_layers = len(flat) // 2
    split = group_size(group) > 1
    if n_layers == 1:
        return h[..., 0]
    x = torch.relu(h)
    sharded = _layer_kind(0, n_layers) == 'col'
    for i in range(1, n_layers):
        w, b = flat[2 * i], flat[2 * i + 1]
        kind = _layer_kind(i, n_layers)
        if split and kind == 'row':
            x = _SumOverModel.apply(F.linear(x, w), group) + b
        else:
            if split and sharded:  # into the replicated logit layer
                x = _GatherSplit.apply(x, group)
            elif split and kind == 'col':
                x = _EnterSplit.apply(x, group)
            x = F.linear(x, w, b)
        sharded = kind == 'col'
        if i < n_layers - 1:
            x = torch.relu(x)
    return x[..., 0]


def _pair_logits(
    params: Params, batch: Any, *, names: Tuple[str, ...], k: int, group: Any
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Both heads' ``(G, A)`` logits: one launch of the fused first layer
    (kernel B1 on the card) over this rank's columns of both heads'
    stacked ``Dense_0``, then each head's chain."""
    ws, bs = params['scores'][0], params['scores'][1]
    wc, bc = params['concedes'][0], params['concedes'][1]
    Wk = torch.cat([ws.t().contiguous(), wc.t().contiguous()], dim=1)
    h = _fold_first_layer(
        Wk, torch.cat([bs, bc]), batch, names=names, k=k, registry=STANDARD_REGISTRY,
        dense_overrides=None,
    )
    width = ws.shape[0]
    return (
        _head_logits(params['scores'], h[..., :width], group),
        _head_logits(params['concedes'], h[..., width:], group),
    )


def _masked_bce(logits: torch.Tensor, y: torch.Tensor, w: torch.Tensor, n: torch.Tensor) -> torch.Tensor:
    """``Σ bce·w / max(n, 1)``: optax's ``sigmoid_binary_cross_entropy``
    written out, over this rank's rows, divided by the global weight ``n``."""
    losses = -y * F.logsigmoid(logits) - (1.0 - y) * F.logsigmoid(-logits)
    return torch.sum(losses * w) / torch.clamp(n, min=1.0)


def make_train_step(
    mesh: Any,
    names: Tuple[str, ...],
    k: int = 3,
    hidden: Sequence[int] = (128, 128),
    learning_rate: float = 1e-3,
    nr_actions: int = 10,
) -> Tuple[Callable, Callable, Callable]:
    """``(init_fn, step_fn, place_batch)`` of the distributed VAEP step.

    - ``init_fn(seed, n_features, params=None) -> (params, opt_state)``:
      both heads drawn from CPU generators of ``seed`` (or ``params``,
      ``{head: MLP}``, given whole), this rank's slices placed on the
      mesh's device (the current card for a ``'cuda'`` mesh);
    - ``step_fn(params, opt_state, batch) -> (params, opt_state, loss)``:
      features, labels, both heads' fused logits (kernel B1 on the card),
      the global masked loss, gradients all-reduced over ``'games'`` and
      one Adam step as :func:`~..ml.mlp.adam_update` computes it, in
      place; ``loss`` is the global loss, a 0-dim tensor the same on
      every rank;
    - ``place_batch(batch)``: this rank's shard of a global batch, on its
      device (``step_fn`` shards a global batch itself too).

    Every rank calls them with the same arguments. Standard SPADL
    batches, as in the JAX package.
    """
    names = tuple(names)
    hidden = tuple(int(h) for h in hidden)
    train_layout(names, k)  # unknown kernels raise here, not in the step
    device = resolve_device(mesh.device_type)
    games, model = axis_group(mesh, 'games'), axis_group(mesh, 'model')

    def init_fn(
        seed: int, n_features: int, params: Optional[Dict[str, MLP]] = None
    ) -> Tuple[Params, AdamState]:
        if params is None:
            params = {
                head: init_mlp(n_features, hidden, _generator(seed, _INIT_STREAM, i))
                for i, head in enumerate(HEADS)
            }
        local = {head: _shard_module(params[head], mesh, device) for head in HEADS}
        return local, AdamState.zeros([t for head in HEADS for t in local[head]])

    def place_batch(batch: Any) -> Any:
        local = shard_batch(batch, mesh)
        return local if local.device == device else mark_shard(local.to(device), mesh)

    def step_fn(params: Params, opt_state: AdamState, batch: Any) -> Tuple[Params, AdamState, torch.Tensor]:
        local = place_batch(batch)
        ys, yc = scores_concedes(local, nr_actions=nr_actions)
        w = local.mask.to(torch.float32)
        (n,) = all_reduce_sum([w.sum()], games)
        logit_s, logit_c = _pair_logits(params, local, names=names, k=k, group=model)
        loss = (
            _masked_bce(logit_s, ys.to(torch.float32), w, n)
            + _masked_bce(logit_c, yc.to(torch.float32), w, n)
        )
        flat = [t for head in HEADS for t in params[head]]
        grads = all_reduce_sum(torch.autograd.grad(loss, flat), games)
        opt_state, _ = adam_update(flat, grads, opt_state, learning_rate)
        (total,) = all_reduce_sum([loss.detach()], games)
        return params, opt_state, total

    return init_fn, step_fn, place_batch


def train_distributed(
    batch: Any,
    mesh: Any,
    names: Tuple[str, ...],
    *,
    k: int = 3,
    hidden: Sequence[int] = (128, 128),
    learning_rate: float = 1e-3,
    epochs: int = 10,
    seed: int = 0,
) -> Dict[str, MLPClassifier]:
    """Train both heads data- and tensor-parallel on ``mesh``: ``epochs``
    full-batch steps of :func:`make_train_step`.

    Returns ``{'scores': MLPClassifier, 'concedes': MLPClassifier}``, the
    same whole heads on every rank, on the mesh's device, with identity
    normalisation (mean 0, std 1: the step trains on raw features), usable
    as ``VAEP._models`` on the fused path.
    """
    init_fn, step_fn, place_batch = make_train_step(mesh, names, k, hidden, learning_rate)
    local = place_batch(batch)
    n_features = train_layout(tuple(names), k).n_features
    params, opt_state = init_fn(seed, n_features)
    for _ in range(epochs):
        params, opt_state, _ = step_fn(params, opt_state, local)
    whole = gather_params(params, mesh, hidden)
    dev = local.device
    return {
        head: MLPClassifier.from_module(
            whole[head],
            torch.zeros(n_features, device=dev),
            torch.ones(n_features, device=dev),
            learning_rate=learning_rate,
        )
        for head in HEADS
    }


def sharded_rate(model: Any, batch: Any, mesh: Any) -> Tuple[torch.Tensor, Any]:
    """Rate this rank's game shard of a global batch -> ``(values,
    shard)``: ``model.rate_batch`` of :func:`~.mesh.shard_batch`'s
    shard, whose padding games carry all-False masks (unpack the values
    against the shard). ``model`` is a fitted VAEP with MLP heads on the
    shard's device."""
    local = shard_batch(batch, mesh)
    return model.rate_batch(local), local


def data_parallel_rate(
    model: Any,
    host_batches: Sequence[Any],
    *,
    n_replicas: Optional[int] = None,
    devices: Optional[Sequence[Any]] = None,
) -> Tuple[np.ndarray, ...]:
    """Rate N equal-shaped batches, one per replica, through the serving
    tier's gang dispatch (:meth:`~.serve.ReplicaDispatcher.rate_mesh`):
    one fused dispatch per lane and no collective. Returns one ``(G, A,
    3)`` numpy array per batch, each bitwise ``model.rate_batch(batch,
    bucket=False)`` on that batch."""
    from .serve import ReplicaDispatcher

    n = len(host_batches) if n_replicas is None else int(n_replicas)
    if n != len(host_batches):
        raise ValueError(
            f'{len(host_batches)} batches for {n} replicas — '
            'gang dispatch needs exactly one batch per replica'
        )
    dispatcher = ReplicaDispatcher(model, n, devices=devices)
    return tuple(dispatcher.rate_mesh(list(host_batches)))
