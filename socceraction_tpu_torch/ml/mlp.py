"""The MLP probability head (inference half of ``socceraction_tpu/ml/mlp.py``).

:class:`MLP` holds ``Dense_0 .. Dense_L`` as ``nn.Linear`` layers, named
like the flax module's so the JAX checkpoint maps onto it one to one
(:mod:`socceraction_tpu_torch.convert`). :class:`MLPClassifier` adds the
standardization statistics and the serving quantize mode. Training comes
with a later slice of the port.
"""

from __future__ import annotations

import json
import zipfile
from typing import Sequence, Tuple

import numpy as np
import torch
from torch import nn

from ..device import DeviceLike, resolve_device
from ..ops.quant import check_quantize_mode

__all__ = ['MLP', 'MLPClassifier', 'MLP_FORMAT_VERSION']

#: Newest ``MLPClassifier.save`` artifact format this port reads (the JAX
#: package's ``MLP_FORMAT_VERSION``).
MLP_FORMAT_VERSION = 2


class MLP(nn.Module):
    """ReLU MLP with one logit output: ``Dense_0 .. Dense_{len(hidden)}``."""

    def __init__(self, n_features: int, hidden: Sequence[int]) -> None:
        super().__init__()
        self.hidden = tuple(int(h) for h in hidden)
        widths = (n_features, *self.hidden, 1)
        for i in range(len(widths) - 1):
            self.add_module(f'Dense_{i}', nn.Linear(widths[i], widths[i + 1]))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        """Logits ``x.shape[:-1]`` of standardized features ``x``."""
        for i in range(len(self.hidden)):
            x = torch.relu(getattr(self, f'Dense_{i}')(x))
        return getattr(self, f'Dense_{len(self.hidden)}')(x)[..., 0]


class MLPClassifier:
    """Binary classifier: standardized inputs -> ReLU MLP -> sigmoid.

    ``module`` is the :class:`MLP` (on ``device``, no gradients), ``mean_``
    and ``std_`` the per-feature standardization statistics on the same
    device. ``quantize`` is the storage mode of the fused serving fold
    (:mod:`~socceraction_tpu_torch.ops.quant`).
    """

    def __init__(
        self,
        module: MLP,
        mean: torch.Tensor,
        std: torch.Tensor,
        *,
        quantize: str = 'none',
    ) -> None:
        n_features = module.Dense_0.in_features
        if tuple(mean.shape) != (n_features,) or tuple(std.shape) != (n_features,):
            raise ValueError(
                f'mean/std must have shape ({n_features},), got '
                f'{tuple(mean.shape)} and {tuple(std.shape)}'
            )
        self.module = module.requires_grad_(False)
        self.mean_ = mean.to(torch.float32)
        self.std_ = std.to(torch.float32)
        self.quantize = check_quantize_mode(quantize)

    @property
    def hidden(self) -> Tuple[int, ...]:
        """Hidden layer widths."""
        return self.module.hidden

    @torch.no_grad()
    def predict_proba_device(self, X: torch.Tensor) -> torch.Tensor:
        """P(y=1) for features ``X`` of any leading shape ``(..., F)``."""
        return torch.sigmoid(self.module((X - self.mean_) / self.std_))

    @classmethod
    def load(cls, path: str, *, device: DeviceLike = None) -> 'MLPClassifier':
        """Load a classifier the JAX package's ``MLPClassifier.save`` wrote.

        Reads the ``.npz`` (format gate, hyperparameters, statistics) and
        decodes the flax-msgpack parameters without flax. A damaged
        artifact raises a ``ValueError`` naming it.
        """
        from ..convert import mlp_from_jax_params, params_from_msgpack

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
        clf = mlp_from_jax_params(
            params_from_msgpack(raw), mean, std,
            quantize=hyper.get('quantize', 'none'), device=dev,
        )
        if clf.hidden != tuple(hyper['hidden']):
            raise ValueError(
                f'checkpoint at {path!r}: parameters have hidden widths '
                f'{clf.hidden} but the hyperparameters say {tuple(hyper["hidden"])}'
            )
        return clf
