"""The GRU sequence head as a trainable binary classifier.

Port of ``socceraction_tpu/seq/classifier.py``. :class:`SeqClassifier`
takes the same labels and the same packed training rows as
:class:`~socceraction_tpu_torch.ml.mlp.MLPClassifier` and trains through
the same epoch loop; it is not a subclass, so "an MLP head" keeps
meaning the fused serving fold. What the two share lives in
:mod:`socceraction_tpu_torch.ml.mlp` as functions of the classifier: the
epoch loop with its health verdict and Adam-state check, the resolution
of packed inputs and the labels.
"""

from __future__ import annotations

import copy
import json
import time
import zipfile
from typing import Any, Callable, Dict, Optional, Sequence, Tuple

import numpy as np
import torch

from ..device import DeviceLike, resolve_device
from ..obs import counter, histogram
from ..ml.mlp import AdamState, _fit_loop, _labels, _resolve_states, _weighted_bce
from .model import (
    SeqModule,
    check_seq_layout,
    dense_stats,
    init_seq_params,
    seq_logits,
    seq_train_logits,
)

__all__ = ['SeqClassifier', 'SEQ_FORMAT_VERSION']

#: Newest ``SeqClassifier.save`` artifact format this port reads and writes
#: (the JAX package's ``SEQ_FORMAT_VERSION``).
SEQ_FORMAT_VERSION = 1


class SeqClassifier:
    """Binary classifier: GRU over the k-action window -> sigmoid.

    Parameters
    ----------
    embed_dim : int
        Width of the combined-id token embedding.
    hidden : int
        GRU hidden-state width.
    readout : int
        Width of the readout layer.
    learning_rate, batch_size, max_epochs, patience, pos_weight, seed
        The training knobs of :class:`~socceraction_tpu_torch.ml.mlp.MLPClassifier`.
    device
        Where the head trains and serves: ``cuda`` (default) or ``'cpu'``.

    Fitted, ``module`` holds the :class:`~.model.SeqModule` and
    ``mean_``/``std_`` the full-column statistics, on ``device``.
    """

    def __init__(
        self,
        embed_dim: int = 32,
        hidden: int = 64,
        readout: int = 64,
        learning_rate: float = 1e-3,
        batch_size: int = 8192,
        max_epochs: int = 50,
        patience: int = 5,
        pos_weight: float = 1.0,
        seed: int = 0,
        *,
        device: DeviceLike = None,
    ) -> None:
        self.device = resolve_device(device)
        self.embed_dim = int(embed_dim)
        self.hidden = int(hidden)
        self.readout = int(readout)
        self.learning_rate = learning_rate
        self.batch_size = batch_size
        self.max_epochs = max_epochs
        self.patience = patience
        self.pos_weight = pos_weight
        self.seed = seed
        self.module: Optional[SeqModule] = None
        self.mean_: Optional[torch.Tensor] = None
        self.std_: Optional[torch.Tensor] = None
        #: Adam state matching :attr:`module` (see the MLP's).
        self.opt_state_: Optional[AdamState] = None
        #: Health of the last fit, the MLP's schema.
        self.train_health_: Optional[Dict[str, Any]] = None

    # -- parameters ----------------------------------------------------------

    def _dims(self, layout: Any) -> Dict[str, int]:
        """The :class:`~.model.SeqModule` dimensions for ``layout``."""
        return {
            'combo_size': layout.registry.combo_size,
            'n_dense': layout.n_dense,
            'embed_dim': self.embed_dim,
            'hidden': self.hidden,
            'readout': self.readout,
        }

    def init_params(self, layout: Any) -> SeqModule:
        """Fresh weights for ``layout`` on the device (:func:`~.model.init_seq_params`)."""
        return init_seq_params(self.seed, **self._dims(layout), device=self.device)

    def _check_init_params(self, init_params: SeqModule, layout: Any) -> SeqModule:
        """A validated copy of a warm-start module on the device: its shapes
        must be those of a fresh init for this architecture and layout."""
        if not isinstance(init_params, SeqModule):
            raise TypeError(f'init_params must be a SeqModule, got {type(init_params).__name__}')
        want = self._dims(layout)
        if init_params.dims() != want:
            raise ValueError(
                f'init_params have dimensions {init_params.dims()}, this classifier and '
                f'layout {want}; warm starts require an unchanged layout'
            )
        return copy.deepcopy(init_params).to(self.device)

    # -- training --------------------------------------------------------------

    def fit_packed(
        self,
        batch: Any,
        y: Any,
        *,
        names: Sequence[str],
        k: int,
        registry: str = 'standard',
        eval_set: Optional[Tuple[Any, Any]] = None,
        mean: Optional[torch.Tensor] = None,
        std: Optional[torch.Tensor] = None,
        path: str = 'seq',
        init_params: Optional[SeqModule] = None,
        init_opt_state: Optional[AdamState] = None,
    ) -> 'SeqClassifier':
        """Train the GRU head on packed game states.

        :meth:`MLPClassifier.fit_packed`'s protocol: a packed batch or a
        ``(TrainStates, TrainLayout)`` pair, full-column statistics (from
        the packed form when not given, so they stay interchangeable with
        an MLP head's), early stopping on ``eval_set``, warm starts from
        ``init_params`` (a :class:`~.model.SeqModule`) and
        ``init_opt_state``, both copied. Each fit counts into ``seq/fits``
        and ``seq/fit_seconds`` (labeled ``platform``) besides the epoch
        loop's ``train/*``.
        """
        t0 = time.perf_counter()
        module, data, loss_fn, make_data, states, layout = self._packed_problem(
            batch, y, names=names, k=k, registry=registry, mean=mean, std=std,
            init_params=init_params,
        )
        eval_data = None
        if eval_set is not None:
            ev_states, ev_layout, _ = _resolve_states(
                eval_set[0], names=names, k=k, registry=registry, device=self.device
            )
            if ev_layout.n_features != layout.n_features:
                raise ValueError('eval_set feature layout differs from train')
            eval_data = make_data(ev_states, _labels(eval_set[1], self.device))
        out = _fit_loop(
            self, module, data, int(states.weight.shape[0]), loss_fn, eval_data,
            path=path, n_samples=int(states.weight.sum()), init_opt_state=init_opt_state,
        )
        labels = {'platform': self.device.type}
        counter('seq/fits', unit='count').inc(1, **labels)
        histogram('seq/fit_seconds', unit='s').observe(time.perf_counter() - t0, **labels)
        return out

    def _packed_problem(
        self,
        batch: Any,
        y: Any,
        *,
        names: Sequence[str],
        k: int,
        registry: str = 'standard',
        mean: Optional[torch.Tensor] = None,
        std: Optional[torch.Tensor] = None,
        init_params: Optional[SeqModule] = None,
    ) -> Tuple[SeqModule, Dict[str, torch.Tensor], Callable[..., torch.Tensor], Callable[..., Any], Any, Any]:
        """The packed training problem, as the MLP's: ``(module, data,
        loss_fn, make_data, states, layout)``. Sets ``mean_``/``std_``."""
        from ..ops.fused import packed_feature_stats

        states, layout, _ = _resolve_states(
            batch, names=names, k=k, registry=registry, device=self.device
        )
        yd = _labels(y, self.device)
        if yd.shape[0] != states.weight.shape[0]:
            raise ValueError(
                f'labels have {yd.shape[0]} rows, packed states have {states.weight.shape[0]}'
            )
        if mean is None or std is None:
            mean, raw_std = packed_feature_stats(states, layout)
            std = torch.where(raw_std > 0, raw_std, 1.0)
        self.mean_ = torch.as_tensor(mean, dtype=torch.float32, device=self.device)
        self.std_ = torch.as_tensor(std, dtype=torch.float32, device=self.device)
        module = (
            self.init_params(layout) if init_params is None
            else self._check_init_params(init_params, layout)
        )
        check_seq_layout(module, layout)
        # the dense statistics are cut once, not every step
        dm, ds = dense_stats(self.mean_, self.std_, layout)
        pos_w = self.pos_weight

        def loss_fn(mb: Dict[str, torch.Tensor], w: torch.Tensor) -> torch.Tensor:
            logits = seq_logits(module, mb['x'], mb['ids'], dense_mean=dm, dense_std=ds)
            return _weighted_bce(logits, mb['y'], w * mb['w'], pos_w)

        def make_data(states: Any, yd: torch.Tensor) -> Dict[str, torch.Tensor]:
            return {'x': states.x_dense, 'ids': states.combo_ids, 'w': states.weight, 'y': yd}

        return module, make_data(states, yd), loss_fn, make_data, states, layout

    # -- inference ---------------------------------------------------------------

    @torch.no_grad()
    def predict_proba_states(self, states: Any, layout: Any) -> torch.Tensor:
        """P(y=1) per packed row -> ``(N,)``."""
        if self.module is None:
            raise ValueError('classifier is not fitted')
        return torch.sigmoid(seq_train_logits(
            self.module, states.x_dense, states.combo_ids, layout=layout,
            mean=self.mean_, std=self.std_,
        ))

    @torch.no_grad()
    def predict_proba_device_batch(
        self, batch: Any, *, names: Sequence[str], k: int, registry: str = 'standard'
    ) -> torch.Tensor:
        """P(y=1) per action of a packed batch -> ``(G, A)``: the batch
        packed (:func:`~socceraction_tpu_torch.ops.fused.build_train_states`)
        and the head run on its rows. ``names``, ``k`` and ``registry`` are
        the layout the head was trained on."""
        from ..ops.fused import REGISTRIES, build_train_states

        states, layout = build_train_states(
            batch, names=names, k=k, registry=REGISTRIES[registry]
        )
        return self.predict_proba_states(states, layout).reshape(batch.n_games, batch.max_actions)

    # -- persistence -------------------------------------------------------------

    def _hyperparameters(self) -> Dict[str, Any]:
        """The constructor arguments the JAX package's loader takes."""
        return {
            'embed_dim': self.embed_dim,
            'hidden': self.hidden,
            'readout': self.readout,
            'learning_rate': self.learning_rate,
            'batch_size': self.batch_size,
            'max_epochs': self.max_epochs,
            'patience': self.patience,
            'pos_weight': self.pos_weight,
            'seed': self.seed,
        }

    def save(self, path: str) -> None:
        """Write the fitted head as the JAX package's seq ``.npz``: the
        msgpack parameter tree, the full-column statistics, the
        hyperparameters and the format stamp."""
        from ..convert import jax_params_from_seq_module, params_to_msgpack

        if self.module is None:
            raise ValueError('cannot save an unfitted classifier')
        raw = params_to_msgpack(jax_params_from_seq_module(self.module))
        with open(path, 'wb') as f:  # a handle keeps np.savez from adding '.npz'
            np.savez(
                f,
                format_version=np.array(SEQ_FORMAT_VERSION),
                seq_params_msgpack=np.frombuffer(raw, dtype=np.uint8),
                mean=self.mean_.cpu().numpy(),
                std=self.std_.cpu().numpy(),
                hyper_json=np.array(json.dumps(self._hyperparameters())),
            )

    @classmethod
    def load(cls, path: str, *, device: DeviceLike = None) -> 'SeqClassifier':
        """Load a head that :meth:`save` or the JAX package's
        ``SeqClassifier.save`` wrote. A damaged artifact, or one of another
        kind (an MLP head has no ``seq_params_msgpack``), raises a
        ``ValueError`` naming it."""
        from ..convert import params_from_msgpack, seq_module_from_jax_params

        dev = resolve_device(device)
        try:
            with np.load(path, allow_pickle=False) as data:
                version = int(data['format_version']) if 'format_version' in data else 1
                if version > SEQ_FORMAT_VERSION:
                    raise ValueError(
                        f'checkpoint at {path!r} has format_version={version}, newer than '
                        f'this library understands (<= {SEQ_FORMAT_VERSION})'
                    )
                hyper = json.loads(str(data['hyper_json']))
                mean = np.asarray(data['mean'], dtype=np.float32)
                std = np.asarray(data['std'], dtype=np.float32)
                raw = data['seq_params_msgpack'].tobytes()
        except (zipfile.BadZipFile, EOFError, KeyError, json.JSONDecodeError) as e:
            raise ValueError(
                f'checkpoint artifact corrupt: {path!r} failed to parse as a seq '
                f'checkpoint ({type(e).__name__}: {e})'
            ) from e
        clf = cls(**hyper, device=dev)
        module = seq_module_from_jax_params(params_from_msgpack(raw))
        dims = module.dims()
        got = (dims['embed_dim'], dims['hidden'], dims['readout'])
        if got != (clf.embed_dim, clf.hidden, clf.readout):
            raise ValueError(
                f'checkpoint at {path!r}: parameters have (embed_dim, hidden, readout) = '
                f'{got} but the hyperparameters say {(clf.embed_dim, clf.hidden, clf.readout)}'
            )
        clf.module = module.to(dev).requires_grad_(False)
        clf.mean_ = torch.as_tensor(mean, device=dev)
        clf.std_ = torch.as_tensor(std, device=dev)
        return clf
