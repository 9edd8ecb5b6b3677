"""The MLP probability head (port of ``socceraction_tpu/ml/mlp.py``).

:class:`MLP` holds ``Dense_0 .. Dense_L`` as ``nn.Linear`` layers, named
like the flax module's so a JAX checkpoint maps onto it one to one
(:mod:`socceraction_tpu_torch.convert`). :class:`MLPClassifier` adds the
standardization statistics, the serving quantize mode and training:

- **fused** (:meth:`MLPClassifier.fit_packed`, the default): the batch
  stays packed (dense sub-tensor + per-state combined ids,
  :func:`~socceraction_tpu_torch.ops.fused.build_train_states`) and every
  step re-folds ``Dense_0`` into combined tables and runs the fused first
  layer (kernel B1 on the card);
- **materialized** (:meth:`MLPClassifier.fit`, or ``fit_packed(...,
  path='materialized')``): minibatches are rows of the feature matrix.

Both feed one epoch loop (:class:`_EpochTrainer`): ``ceil(n /
batch_size)`` steps of a fixed shape, the last one wrapping around the
epoch's permutation with zero loss weight on the wrapped slots, so each
sample counts once per epoch; Adam as optax computes it; health scalars
kept on the device and read once, after the fit. The permutation of epoch
``e`` comes from a CPU ``torch.Generator`` seeded from ``(seed, e)`` and
is copied to the device once per epoch, so a fit on the card and one on
the CPU see the same minibatches. Nothing inside an epoch waits for the
device.
"""

from __future__ import annotations

import copy
import json
import time
import zipfile
from typing import Any, Callable, Dict, List, NamedTuple, Optional, Sequence, Tuple

import numpy as np
import torch
from torch import nn

from ..device import DeviceLike, resolve_device
from ..ops.quant import check_quantize_mode

__all__ = ['AdamState', 'MLP', 'MLPClassifier', 'MLP_FORMAT_VERSION']

#: Newest ``MLPClassifier.save`` artifact format this port reads and
#: writes (the JAX package's ``MLP_FORMAT_VERSION``).
MLP_FORMAT_VERSION = 2

#: optax's ``adam`` defaults.
_B1, _B2, _EPS = 0.9, 0.999, 1e-8
#: The generator stream of the initial weights; stream ``e`` draws epoch
#: ``e``'s permutation.
_INIT_STREAM = 2**31 - 1
#: ``jax.nn.initializers.variance_scaling``'s standard deviation of the
#: unit normal truncated to [-2, 2].
_TRUNCATED_STD = 0.87962566103423978


class MLP(nn.Module):
    """ReLU MLP with one logit output: ``Dense_0 .. Dense_{len(hidden)}``."""

    def __init__(self, n_features: int, hidden: Sequence[int]) -> None:
        super().__init__()
        self.hidden = tuple(int(h) for h in hidden)
        widths = (n_features, *self.hidden, 1)
        for i in range(len(widths) - 1):
            self.add_module(f'Dense_{i}', nn.Linear(widths[i], widths[i + 1]))

    def layers(self) -> List[nn.Linear]:
        """``Dense_0 .. Dense_L`` in order."""
        return [getattr(self, f'Dense_{i}') for i in range(len(self.hidden) + 1)]

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        """Logits ``x.shape[:-1]`` of standardized features ``x``."""
        for i in range(len(self.hidden)):
            x = torch.relu(getattr(self, f'Dense_{i}')(x))
        return getattr(self, f'Dense_{len(self.hidden)}')(x)[..., 0]


class AdamState(NamedTuple):
    """Adam's state: the step count and both moments, one tensor per
    parameter in ``module.parameters()`` order."""

    count: int
    mu: Tuple[torch.Tensor, ...]
    nu: Tuple[torch.Tensor, ...]

    @classmethod
    def zeros(cls, params: Sequence[torch.Tensor]) -> 'AdamState':
        return cls(0, tuple(torch.zeros_like(p) for p in params),
                   tuple(torch.zeros_like(p) for p in params))

    def clone(self) -> 'AdamState':
        return AdamState(self.count, tuple(t.clone() for t in self.mu),
                         tuple(t.clone() for t in self.nu))


def _generator(seed: int, stream: int) -> torch.Generator:
    """A CPU generator for one stream of a classifier's seed."""
    state = np.random.SeedSequence([seed % 2**32, stream]).generate_state(1)[0]
    return torch.Generator().manual_seed(int(state))


def _global_norm(tensors: Sequence[torch.Tensor]) -> torch.Tensor:
    """``sqrt(Σ ‖t‖²)`` over a list of tensors, as a device scalar."""
    return torch.linalg.vector_norm(torch.stack(torch._foreach_norm(list(tensors))))


def _weighted_bce(
    logits: torch.Tensor, y: torch.Tensor, w: torch.Tensor, pos_w: float
) -> torch.Tensor:
    """``Σ bce · w · posw / max(Σ w, 1)``: wrapped and padding rows
    (``w = 0``) add nothing. The element loss is optax's
    ``sigmoid_binary_cross_entropy`` written out."""
    losses = -y * nn.functional.logsigmoid(logits) - (1.0 - y) * nn.functional.logsigmoid(-logits)
    weights = w * torch.where(y > 0.5, pos_w, 1.0)
    return torch.sum(losses * weights) / torch.clamp(torch.sum(w), min=1.0)


class _EpochTrainer:
    """Minibatch Adam over fixed-shape steps, one epoch per :meth:`run`.

    ``loss_fn(minibatch, slot_weights)`` is the objective of the module
    whose ``params`` it reads; :meth:`run` updates them in place. Data is
    a dict of ``(n, ...)`` tensors on the device; minibatches are row
    gathers from it.
    """

    def __init__(
        self,
        loss_fn: Callable[[Dict[str, torch.Tensor], torch.Tensor], torch.Tensor],
        params: Sequence[torch.Tensor],
        n: int,
        batch_size: int,
        seed: int,
        learning_rate: float,
    ) -> None:
        if n < 1:
            raise ValueError('no training rows')
        self.loss_fn = loss_fn
        self.params = list(params)
        self.device = self.params[0].device
        self.n = n
        self.seed = seed
        self.learning_rate = learning_rate
        self.batch_size = min(batch_size, n)
        # ceil so the tail trains; the last step wraps around the
        # permutation to keep one shape, and its wrapped slots weigh 0
        self.steps = -(-n // self.batch_size)
        slots = self.steps * self.batch_size
        slot = torch.arange(slots, device=self.device)
        self.slot_pos = slot % n
        #: (steps, batch_size) loss weights: 0 on the wrapped tail slots
        self.slot_weight = (slot < n).to(torch.float32).reshape(self.steps, self.batch_size)

    def _permutation(self, epoch: int) -> torch.Tensor:
        """Epoch ``epoch``'s row order on the device, drawn on the CPU from
        the ``(seed, epoch)`` stream whatever the device is."""
        perm = torch.randperm(self.n, generator=_generator(self.seed, epoch))
        return perm.to(self.device)

    @torch.no_grad()
    def _adam(self, grads: Sequence[torch.Tensor], state: AdamState) -> Tuple[AdamState, torch.Tensor]:
        """One optax Adam step applied in place -> (new state, update norm).

        The bias corrections ``1 - b**t`` are taken in f32, as optax takes
        them on f32 parameters.
        """
        t = state.count + 1
        bc1 = float(np.float32(1) - np.float32(_B1) ** np.float32(t))
        bc2 = float(np.float32(1) - np.float32(_B2) ** np.float32(t))
        grads = list(grads)
        # multi-tensor ops: a few launches per step, not ten per parameter
        mu = torch._foreach_mul(state.mu, _B1)
        torch._foreach_add_(mu, torch._foreach_mul(grads, 1 - _B1))
        nu = torch._foreach_mul(state.nu, _B2)
        torch._foreach_add_(nu, torch._foreach_mul(torch._foreach_mul(grads, grads), 1 - _B2))
        den = torch._foreach_sqrt(torch._foreach_div(nu, bc2))
        torch._foreach_add_(den, _EPS)
        updates = torch._foreach_div(torch._foreach_div(mu, bc1), den)
        torch._foreach_mul_(updates, -self.learning_rate)
        torch._foreach_add_(self.params, updates)
        return AdamState(t, tuple(mu), tuple(nu)), _global_norm(updates)

    def run(
        self, opt_state: AdamState, epoch: int, data: Dict[str, torch.Tensor]
    ) -> Tuple[AdamState, torch.Tensor, Dict[str, torch.Tensor]]:
        """Train one epoch -> ``(opt_state, mean loss, health)``, every
        number a device scalar (nothing here waits for the device).

        Health: the count of steps whose loss or gradient norm went
        non-finite, the finite steps' mean gradient and update norms, and
        the weight norm after the epoch.
        """
        sel = self._permutation(epoch)[self.slot_pos].reshape(self.steps, self.batch_size)
        losses, gnorms, unorms = [], [], []
        for step in range(self.steps):
            idx = sel[step]
            mb = {name: t.index_select(0, idx) for name, t in data.items()}
            loss = self.loss_fn(mb, self.slot_weight[step])
            grads = torch.autograd.grad(loss, self.params)
            opt_state, unorm = self._adam(grads, opt_state)
            losses.append(loss.detach())
            gnorms.append(_global_norm(grads))
            unorms.append(unorm)
        losses_t, gnorms_t, unorms_t = torch.stack(losses), torch.stack(gnorms), torch.stack(unorms)
        step_ok = torch.isfinite(losses_t) & torch.isfinite(gnorms_t)

        def finite_mean(x: torch.Tensor) -> torch.Tensor:
            ok = torch.isfinite(x)
            return torch.where(ok, x, 0.0).sum() / torch.clamp(ok.sum(), min=1)

        with torch.no_grad():
            health = {
                'nonfinite_steps': (~step_ok).sum(),
                'grad_norm': finite_mean(gnorms_t),
                'update_norm': finite_mean(unorms_t),
                'weight_norm': _global_norm(self.params),
            }
        return opt_state, losses_t.mean(), health


class MLPClassifier:
    """Binary classifier: standardized inputs -> ReLU MLP -> sigmoid.

    Parameters
    ----------
    hidden : sequence of int
        Hidden layer widths.
    learning_rate : float
        Adam learning rate.
    batch_size : int
        Minibatch size.
    max_epochs : int
        Most passes over the training rows.
    patience : int
        Early-stopping patience in epochs (with an eval set).
    pos_weight : float
        Loss weight multiplier of positive examples.
    seed : int
        Seed of the initial weights and of the epoch permutations.
    train_dtype : str, optional
        ``'bfloat16'`` narrows the post-relu hidden pipeline in training
        (and the first-layer product of the materialized path); master
        weights, Adam and the loss stay f32. ``None`` trains in f32.
    quantize : {'none', 'bf16', 'int8'}
        Storage of the fused serving fold. Set before :meth:`fit_packed`,
        a narrow mode also trains quantization-aware.
    device
        Where the head trains and serves: ``cuda`` (default) or ``'cpu'``.

    Fitted, ``module`` holds the :class:`MLP` and ``mean_``/``std_`` the
    per-feature statistics, on ``device``.
    """

    def __init__(
        self,
        hidden: Sequence[int] = (128, 128),
        learning_rate: float = 1e-3,
        batch_size: int = 8192,
        max_epochs: int = 50,
        patience: int = 5,
        pos_weight: float = 1.0,
        seed: int = 0,
        train_dtype: Optional[str] = None,
        quantize: str = 'none',
        *,
        device: DeviceLike = None,
    ) -> None:
        self.device = resolve_device(device)
        self.hidden = tuple(int(h) for h in hidden)
        self.learning_rate = learning_rate
        self.batch_size = batch_size
        self.max_epochs = max_epochs
        self.patience = patience
        self.pos_weight = pos_weight
        self.seed = seed
        if train_dtype not in (None, 'bfloat16'):
            raise ValueError(f"train_dtype must be None or 'bfloat16', got {train_dtype!r}")
        self.train_dtype = train_dtype
        self.quantize = check_quantize_mode(quantize)
        self.module: Optional[MLP] = None
        self.mean_: Optional[torch.Tensor] = None
        self.std_: Optional[torch.Tensor] = None
        #: Adam state matching :attr:`module`: the best eval epoch's under
        #: early stopping, else the last epoch's. ``fit_packed(
        #: init_opt_state=...)`` continues from it. Not checkpointed.
        self.opt_state_: Optional[AdamState] = None
        #: Health of the last fit: ``finite``, ``path``, ``epochs``,
        #: ``nonfinite_steps``, the last epoch's ``grad_norm_last``,
        #: ``update_norm_last`` and ``weight_norm_last``, and per epoch the
        #: mean training loss (``epoch_losses``), the eval loss
        #: (``val_losses``) and the host seconds to the end of its eval
        #: (``epoch_seconds``).
        self.train_health_: Optional[Dict[str, Any]] = None

    @classmethod
    def from_module(
        cls, module: MLP, mean: torch.Tensor, std: torch.Tensor, **hyper: Any
    ) -> 'MLPClassifier':
        """A fitted classifier from a module and its statistics, on their
        device; ``hyper`` are constructor arguments (``hidden`` comes from
        the module)."""
        n_features = module.Dense_0.in_features
        if tuple(mean.shape) != (n_features,) or tuple(std.shape) != (n_features,):
            raise ValueError(
                f'mean/std must have shape ({n_features},), got '
                f'{tuple(mean.shape)} and {tuple(std.shape)}'
            )
        clf = cls(hidden=module.hidden, device=mean.device, **hyper)
        clf.module = module.requires_grad_(False)
        clf.mean_ = mean.to(torch.float32)
        clf.std_ = std.to(torch.float32)
        return clf

    def _compute_dtype(self) -> Optional[torch.dtype]:
        return None if self.train_dtype is None else getattr(torch, self.train_dtype)

    # -- parameters ----------------------------------------------------------

    def init_params(self, n_features: int) -> MLP:
        """Fresh weights on the device, as flax's ``Dense`` draws them: a
        LeCun normal kernel truncated at two standard deviations and a zero
        bias. The draws come from a CPU generator of the seed's init stream,
        so every device starts from the same weights; the JAX package's
        weights have the same distribution, not the same values."""
        module = MLP(n_features, self.hidden)
        gen = _generator(self.seed, _INIT_STREAM)
        with torch.no_grad():
            for layer in module.layers():
                std = layer.in_features ** -0.5 / _TRUNCATED_STD
                nn.init.trunc_normal_(layer.weight, 0.0, std, -2 * std, 2 * std, generator=gen)
                layer.bias.zero_()
        return module.to(self.device)

    def _check_init_params(self, init_params: MLP, n_features: int) -> MLP:
        """A validated copy of a warm-start ``MLP`` on the device: the
        architecture and ``n_features`` must match this classifier's."""
        if not isinstance(init_params, MLP):
            raise TypeError(f'init_params must be an MLP, got {type(init_params).__name__}')
        got = (init_params.Dense_0.in_features, init_params.hidden)
        if got != (n_features, self.hidden):
            raise ValueError(
                f'init_params have (n_features, hidden) = {got}, this classifier '
                f'{(n_features, self.hidden)}; warm starts require an unchanged layout'
            )
        return copy.deepcopy(init_params).to(self.device)

    def _check_opt_state(self, opt_state: AdamState, module: MLP) -> AdamState:
        shapes = [tuple(p.shape) for p in module.parameters()]
        if [tuple(t.shape) for t in opt_state.mu] != shapes or [
            tuple(t.shape) for t in opt_state.nu
        ] != shapes:
            raise ValueError('init_opt_state does not match the parameters')
        return AdamState(
            int(opt_state.count),
            tuple(t.to(self.device, copy=True) for t in opt_state.mu),
            tuple(t.to(self.device, copy=True) for t in opt_state.nu),
        )

    def _dense_logits(
        self, module: MLP, x: torch.Tensor, mean: torch.Tensor, std: torch.Tensor
    ) -> torch.Tensor:
        """``module`` on standardized rows. Narrowed, the first-layer
        product takes ``train_dtype`` inputs with f32 accumulation and the
        hidden pipeline follows the fused path's policy, so bf16 deltas
        measure the type, never the path."""
        from ..ops.fused import _hidden_chain

        xn = (x - mean) / std
        dt = self._compute_dtype()
        if dt is None:
            return module(xn)
        d0 = module.Dense_0
        # bf16 products are exact in f32: the f32 product of the narrowed
        # operands is the narrow product with f32 accumulation
        h = xn.to(dt).to(torch.float32) @ d0.weight.to(dt).to(torch.float32).t() + d0.bias
        return _hidden_chain(module, h, dt)

    # -- training --------------------------------------------------------------

    def _fit_loop(
        self,
        module: MLP,
        data: Dict[str, torch.Tensor],
        n: int,
        loss_fn: Callable[[Dict[str, torch.Tensor], torch.Tensor], torch.Tensor],
        eval_data: Optional[Dict[str, torch.Tensor]] = None,
        *,
        path: str,
        init_opt_state: Optional[AdamState] = None,
    ) -> 'MLPClassifier':
        """The epoch loop: train, evaluate, early-stop, keep the best.

        Each epoch with an eval set ends in one read of its eval loss (the
        loop's only wait for the device); the health scalars are read once,
        after the last epoch.
        """
        module.requires_grad_(True)
        params = list(module.parameters())
        opt_state = (
            AdamState.zeros(params) if init_opt_state is None
            else self._check_opt_state(init_opt_state, module)
        )
        trainer = _EpochTrainer(loss_fn, params, n, self.batch_size, self.seed, self.learning_rate)
        best_state: Optional[Dict[str, torch.Tensor]] = None
        best_opt: Optional[AdamState] = None
        best_loss = np.inf
        bad_epochs = 0
        epoch_health, epoch_losses, val_losses, seconds = [], [], [], []
        for epoch in range(self.max_epochs):
            t0 = time.perf_counter()
            opt_state, loss, health = trainer.run(opt_state, epoch, data)
            epoch_health.append(health)
            epoch_losses.append(loss)
            if eval_data is not None:
                with torch.no_grad():
                    ones = torch.ones_like(eval_data['w'])
                    vloss = float(loss_fn(eval_data, ones))
                val_losses.append(vloss)
            seconds.append(time.perf_counter() - t0)
            if eval_data is not None:
                if vloss < best_loss - 1e-6:
                    best_loss = vloss
                    # the Adam state is kept with the parameters it belongs to
                    best_state = {k: v.detach().clone() for k, v in module.state_dict().items()}
                    best_opt = opt_state.clone()
                    bad_epochs = 0
                else:
                    bad_epochs += 1
                    if bad_epochs >= self.patience:
                        break
        if best_state is not None:
            module.load_state_dict(best_state)
            opt_state = best_opt
        self.module = module.requires_grad_(False)
        self.opt_state_ = opt_state
        self._record_train_health(epoch_health, epoch_losses, val_losses, seconds, path)
        return self

    def _record_train_health(
        self,
        epoch_health: List[Dict[str, torch.Tensor]],
        epoch_losses: List[torch.Tensor],
        val_losses: List[float],
        seconds: List[float],
        path: str,
    ) -> None:
        """Read the per-epoch device scalars in one transfer and store the
        :attr:`train_health_` verdict."""
        keys = ('nonfinite_steps', 'grad_norm', 'update_norm', 'weight_norm')
        rows = (
            torch.stack(
                [torch.stack([h[k].to(torch.float32) for k in keys]) for h in epoch_health]
            ).tolist()
            if epoch_health else []
        )
        nonfinite = int(sum(r[0] for r in rows))
        last = dict(zip(keys[1:], rows[-1][1:])) if rows else dict.fromkeys(keys[1:])
        finite = nonfinite == 0 and all(v is None or np.isfinite(v) for v in last.values())
        self.train_health_ = {
            'finite': bool(finite),
            'path': path,
            'epochs': len(rows),
            'nonfinite_steps': nonfinite,
            'grad_norm_last': last['grad_norm'],
            'update_norm_last': last['update_norm'],
            'weight_norm_last': last['weight_norm'],
            'epoch_losses': torch.stack(epoch_losses).tolist() if epoch_losses else [],
            'val_losses': val_losses,
            'epoch_seconds': seconds,
        }

    def fit(
        self,
        X: Any,
        y: Any,
        eval_set: Optional[Tuple[Any, Any]] = None,
    ) -> 'MLPClassifier':
        """Train on a materialized feature matrix ``X`` ``(n, F)``.

        Standardizes with ``X``'s column mean and std, minimizes the
        sigmoid cross entropy with Adam and, given ``eval_set``, early-stops
        on its loss.
        """
        X = torch.as_tensor(np.asarray(X, dtype=np.float32), device=self.device)
        y = torch.as_tensor(np.asarray(y, dtype=np.float32), device=self.device).reshape(-1)
        self.mean_ = X.mean(dim=0)
        std = X.std(dim=0, correction=0)
        self.std_ = torch.where(std > 0, std, 1.0)
        module = self.init_params(X.shape[1])
        mean, std = self.mean_, self.std_
        pos_w = self.pos_weight

        def loss_fn(mb: Dict[str, torch.Tensor], w: torch.Tensor) -> torch.Tensor:
            return _weighted_bce(self._dense_logits(module, mb['x'], mean, std), mb['y'], w, pos_w)

        data = {'x': X, 'y': y, 'w': torch.ones_like(y)}
        eval_data = None
        if eval_set is not None:
            ex = torch.as_tensor(np.asarray(eval_set[0], dtype=np.float32), device=self.device)
            ey = torch.as_tensor(np.asarray(eval_set[1], dtype=np.float32), device=self.device)
            eval_data = {'x': ex, 'y': ey.reshape(-1), 'w': torch.ones(ex.shape[0], device=self.device)}
        return self._fit_loop(module, data, X.shape[0], loss_fn, eval_data, path='materialized')

    def fit_packed(
        self,
        batch: Any,
        y: Any,
        *,
        names: Sequence[str],
        k: int,
        eval_set: Optional[Tuple[Any, Any]] = None,
        mean: Optional[torch.Tensor] = None,
        std: Optional[torch.Tensor] = None,
        path: str = 'fused',
        init_params: Optional[MLP] = None,
        init_opt_state: Optional[AdamState] = None,
    ) -> 'MLPClassifier':
        """Train on packed game states, without the feature matrix.

        Parameters
        ----------
        batch
            An :class:`~socceraction_tpu_torch.core.batch.ActionBatch` on
            this classifier's device, or a ``(TrainStates, TrainLayout)``
            pair from :func:`~socceraction_tpu_torch.ops.fused.build_train_states`
            (several heads share one pack).
        y
            Labels, ``(G, A)`` or flat; padding rows weigh 0.
        names, k
            The feature layout (standard SPADL transformer names, states).
        eval_set
            Optional ``(batch_like, y)`` for early stopping.
        mean, std
            Standardization statistics; default: computed from the packed
            form (:func:`~socceraction_tpu_torch.ops.fused.packed_feature_stats`).
        path
            ``'fused'`` trains through the combined-table fold and kernel
            B1; ``'materialized'`` gathers rows of the feature tensor (an
            ``ActionBatch`` is needed) through the same loop.
        init_params, init_opt_state
            Warm start from an :class:`MLP` (a fitted head's ``module``, or
            :func:`~socceraction_tpu_torch.convert.module_from_jax_params`
            of a JAX head) and an :class:`AdamState` (a fit's
            :attr:`opt_state_`). Both are copied: the caller's model is
            never changed.
        """
        module, data, loss_fn, make_data, states, layout = self._packed_problem(
            batch, y, names=names, k=k, mean=mean, std=std, path=path, init_params=init_params,
        )
        eval_data = None
        if eval_set is not None:
            ev_states, ev_layout, ev_batch = self._resolve_states(eval_set[0], names=names, k=k)
            if ev_layout.n_features != layout.n_features:
                raise ValueError('eval_set feature layout differs from train')
            eval_data = make_data(ev_states, self._labels(eval_set[1]), ev_batch)
        return self._fit_loop(
            module, data, int(states.weight.shape[0]), loss_fn, eval_data,
            path=path, init_opt_state=init_opt_state,
        )

    def _labels(self, y: Any) -> torch.Tensor:
        return torch.as_tensor(y, dtype=torch.float32, device=self.device).reshape(-1)

    def _packed_problem(
        self,
        batch: Any,
        y: Any,
        *,
        names: Sequence[str],
        k: int,
        mean: Optional[torch.Tensor] = None,
        std: Optional[torch.Tensor] = None,
        path: str = 'fused',
        init_params: Optional[MLP] = None,
    ) -> Tuple[MLP, Dict[str, torch.Tensor], Callable[..., torch.Tensor], Callable[..., Any], Any, Any]:
        """The packed training problem: ``(module, data, loss_fn,
        make_data, states, layout)``, all :class:`_EpochTrainer` needs.
        Sets ``mean_``/``std_``."""
        from ..ops.features import compute_features
        from ..ops.fused import fused_train_logits, packed_feature_stats

        if path not in ('fused', 'materialized'):
            raise ValueError(f'unknown training path {path!r}')
        states, layout, raw_batch = self._resolve_states(batch, names=names, k=k)
        yd = self._labels(y)
        if yd.shape[0] != states.weight.shape[0]:
            raise ValueError(
                f'labels have {yd.shape[0]} rows, packed states have {states.weight.shape[0]}'
            )
        if mean is None or std is None:
            mean, raw_std = packed_feature_stats(states, layout)
            std = torch.where(raw_std > 0, raw_std, 1.0)
        self.mean_ = torch.as_tensor(mean, dtype=torch.float32, device=self.device)
        self.std_ = torch.as_tensor(std, dtype=torch.float32, device=self.device)
        mean, std = self.mean_, self.std_
        module = (
            self.init_params(layout.n_features) if init_params is None
            else self._check_init_params(init_params, layout.n_features)
        )
        pos_w = self.pos_weight
        compute_dtype = self._compute_dtype()
        quantize = self.quantize

        if path == 'fused':

            def loss_fn(mb: Dict[str, torch.Tensor], w: torch.Tensor) -> torch.Tensor:
                logits = fused_train_logits(
                    module, mb['x'], mb['ids'], layout=layout, mean=mean, std=std,
                    compute_dtype=compute_dtype, quantize=quantize,
                )
                return _weighted_bce(logits, mb['y'], w * mb['w'], pos_w)

            def make_data(states: Any, yd: torch.Tensor, batch: Any) -> Dict[str, torch.Tensor]:
                return {'x': states.x_dense, 'ids': states.combo_ids, 'w': states.weight, 'y': yd}

        else:

            def loss_fn(mb: Dict[str, torch.Tensor], w: torch.Tensor) -> torch.Tensor:
                logits = self._dense_logits(module, mb['x'], mean, std)
                return _weighted_bce(logits, mb['y'], w * mb['w'], pos_w)

            def make_data(states: Any, yd: torch.Tensor, batch: Any) -> Dict[str, torch.Tensor]:
                if batch is None:
                    raise ValueError(
                        "path='materialized' needs ActionBatch inputs (precomputed "
                        'TrainStates cannot rebuild the feature tensor)'
                    )
                feats = compute_features(batch, names=layout.names, k=layout.k)
                return {'x': feats.reshape(-1, layout.n_features), 'w': states.weight, 'y': yd}

        return module, make_data(states, yd, raw_batch), loss_fn, make_data, states, layout

    def _resolve_states(
        self, batch: Any, *, names: Sequence[str], k: int
    ) -> Tuple[Any, Any, Any]:
        """``batch`` -> ``(TrainStates, TrainLayout, ActionBatch or None)``,
        on this classifier's device."""
        from ..ops.fused import TrainStates, build_train_states

        if isinstance(batch, tuple) and len(batch) == 2 and isinstance(batch[0], TrainStates):
            states, layout, raw = batch[0], batch[1], None
        else:
            states, layout = build_train_states(batch, names=tuple(names), k=k)
            raw = batch
        if states.weight.device != self.device:
            raise ValueError(f'the training rows live on {states.weight.device}, the classifier on {self.device}')
        return states, layout, raw

    # -- inference ---------------------------------------------------------------

    def _fitted(self) -> MLP:
        if self.module is None:
            raise ValueError('classifier is not fitted')
        return self.module

    @torch.no_grad()
    def predict_proba_device(self, X: torch.Tensor) -> torch.Tensor:
        """P(y=1) for features ``X`` of any leading shape ``(..., F)``."""
        return torch.sigmoid(self._fitted()((X - self.mean_) / self.std_))

    def predict_proba(self, X: Any) -> np.ndarray:
        """sklearn-style ``(n, 2)`` probability matrix, as numpy."""
        x = torch.as_tensor(np.asarray(X, dtype=np.float32), device=self.device)
        p1 = self.predict_proba_device(x).cpu().numpy()
        return np.stack([1.0 - p1, p1], axis=1)

    # -- persistence -------------------------------------------------------------

    def _hyperparameters(self) -> Dict[str, Any]:
        """The constructor arguments the JAX package's loader takes."""
        hyper: Dict[str, Any] = {
            'hidden': list(self.hidden),
            'learning_rate': self.learning_rate,
            'batch_size': self.batch_size,
            'max_epochs': self.max_epochs,
            'patience': self.patience,
            'pos_weight': self.pos_weight,
            'seed': self.seed,
        }
        if self.train_dtype is not None:
            hyper['train_dtype'] = self.train_dtype
        if self.quantize != 'none':
            hyper['quantize'] = self.quantize
        return hyper

    def save(self, path: str) -> None:
        """Write the fitted classifier as the JAX package's ``.npz``: the
        flax-msgpack parameters, the statistics and the hyperparameters.
        The format stamp is the oldest reader version the file needs (2
        with a quantize mode, else 1)."""
        from ..convert import jax_params_from_mlp, params_to_msgpack

        raw = params_to_msgpack(jax_params_from_mlp(self._fitted()))
        with open(path, 'wb') as f:  # a handle keeps np.savez from adding '.npz'
            np.savez(
                f,
                format_version=np.array(2 if self.quantize != 'none' else 1),
                params_msgpack=np.frombuffer(raw, dtype=np.uint8),
                mean=self.mean_.cpu().numpy(),
                std=self.std_.cpu().numpy(),
                hyper_json=np.array(json.dumps(self._hyperparameters())),
            )

    @classmethod
    def load(cls, path: str, *, device: DeviceLike = None) -> 'MLPClassifier':
        """Load a classifier that :meth:`save` or the JAX package's
        ``MLPClassifier.save`` wrote.

        Reads the ``.npz`` (format gate, hyperparameters, statistics) and
        decodes the flax-msgpack parameters without flax. A damaged
        artifact raises a ``ValueError`` naming it.
        """
        from ..convert import module_from_jax_params, params_from_msgpack

        dev = resolve_device(device)
        try:
            with np.load(path, allow_pickle=False) as data:
                version = int(data['format_version']) if 'format_version' in data else 1
                if version > MLP_FORMAT_VERSION:
                    raise ValueError(
                        f'checkpoint at {path!r} has format_version={version}, '
                        f'newer than this library understands '
                        f'(<= {MLP_FORMAT_VERSION})'
                    )
                hyper = json.loads(str(data['hyper_json']))
                mean = np.asarray(data['mean'], dtype=np.float32)
                std = np.asarray(data['std'], dtype=np.float32)
                raw = data['params_msgpack'].tobytes()
        except (zipfile.BadZipFile, EOFError, KeyError, json.JSONDecodeError) as e:
            raise ValueError(
                f'checkpoint artifact corrupt: {path!r} failed to parse as an '
                f'MLP checkpoint ({type(e).__name__}: {e})'
            ) from e
        module = module_from_jax_params(params_from_msgpack(raw))
        hidden = tuple(hyper.pop('hidden'))
        if module.hidden != hidden:
            raise ValueError(
                f'checkpoint at {path!r}: parameters have hidden widths '
                f'{module.hidden} but the hyperparameters say {hidden}'
            )
        return cls.from_module(
            module.to(dev),
            torch.as_tensor(mean, device=dev),
            torch.as_tensor(std, device=dev),
            **hyper,
        )
