"""Carry weights from the JAX package's checkpoints into the port.

The JAX package stores an MLP head as a flax parameter pytree,
``{'params': {'Dense_i': {'kernel': (in, out), 'bias': (out,)}}}``,
serialized with flax's msgpack encoding. :func:`params_from_msgpack`
decodes that encoding without flax, and :func:`mlp_from_jax_params` builds
the port's :class:`~socceraction_tpu_torch.ml.mlp.MLPClassifier` from the
numpy pytree. ``msgpack`` is imported inside the decoder only.
"""

from __future__ import annotations

from typing import Any, Dict, Mapping

import numpy as np
import torch

from .device import DeviceLike, resolve_device
from .ml.mlp import MLP, MLPClassifier

__all__ = ['mlp_from_jax_params', 'params_from_msgpack']

#: flax's msgpack extension type of an ndarray leaf
#: (``flax.serialization._MsgpackExtType.ndarray``).
_EXT_NDARRAY = 1


def params_from_msgpack(raw: bytes) -> Dict[str, Any]:
    """Decode flax-msgpack bytes into a nested dict of numpy arrays.

    flax encodes each array leaf as ``ExtType(1, packb((shape, dtype name,
    C-order bytes)))``. Any other extension type, and the chunked form
    flax uses for leaves over 1 GiB, raise: an MLP checkpoint holds
    neither.
    """
    import msgpack

    def ext_hook(code: int, data: bytes) -> Any:
        if code != _EXT_NDARRAY:
            raise ValueError(f'unsupported msgpack extension type {code} in parameters')
        shape, dtype_name, buffer = msgpack.unpackb(data, raw=True)
        dtype = np.dtype(dtype_name.decode())
        return np.frombuffer(buffer, dtype=dtype).reshape(shape, order='C')

    tree = msgpack.unpackb(raw, ext_hook=ext_hook, raw=False)

    def check(node: Any) -> None:
        if isinstance(node, dict):
            if '__msgpack_chunked_array__' in node:
                raise ValueError('chunked (> 1 GiB) parameter leaves are not supported')
            for v in node.values():
                check(v)

    check(tree)
    return tree


def mlp_from_jax_params(
    params: Mapping[str, Any],
    mean: Any,
    std: Any,
    *,
    quantize: str = 'none',
    device: DeviceLike = None,
) -> MLPClassifier:
    """The port's classifier from a flax ``_MLP`` pytree of numpy arrays.

    Flax stores ``kernel`` as ``(in, out)``; ``nn.Linear.weight`` is
    ``(out, in)``, so each kernel is transposed. Layer widths come from the
    kernels' shapes and must chain (``Dense_i`` out == ``Dense_{i+1}`` in,
    one output unit at the end).
    """
    dev = resolve_device(device)
    layers = params['params']
    n_layers = len(layers)
    names = [f'Dense_{i}' for i in range(n_layers)]
    if sorted(layers) != sorted(names):
        raise ValueError(f'expected layers {names}, got {sorted(layers)}')
    # copies: decoded leaves are read-only views of the msgpack buffer
    kernels = [np.array(layers[n]['kernel'], dtype=np.float32) for n in names]
    biases = [np.array(layers[n]['bias'], dtype=np.float32) for n in names]
    for i, (kern, b) in enumerate(zip(kernels, biases)):
        if kern.ndim != 2 or b.shape != kern.shape[1:]:
            raise ValueError(
                f'Dense_{i}: kernel {kern.shape} and bias {b.shape} do not form a layer'
            )
        if i and kern.shape[0] != kernels[i - 1].shape[1]:
            raise ValueError(
                f'Dense_{i} takes {kern.shape[0]} inputs but Dense_{i - 1} '
                f'emits {kernels[i - 1].shape[1]}'
            )
    if kernels[-1].shape[1] != 1:
        raise ValueError(f'the output layer must have one unit, got {kernels[-1].shape[1]}')
    module = MLP(kernels[0].shape[0], [kern.shape[1] for kern in kernels[:-1]])
    with torch.no_grad():
        for name, kern, b in zip(names, kernels, biases):
            layer = getattr(module, name)
            layer.weight.copy_(torch.from_numpy(np.ascontiguousarray(kern.T)))
            layer.bias.copy_(torch.from_numpy(b))
    return MLPClassifier(
        module.to(dev),
        torch.as_tensor(np.asarray(mean, dtype=np.float32), device=dev),
        torch.as_tensor(np.asarray(std, dtype=np.float32), device=dev),
        quantize=quantize,
    )
