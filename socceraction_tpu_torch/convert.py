"""Carry weights between the JAX package's checkpoints and the port.

The JAX package stores an MLP head as a flax parameter pytree,
``{'params': {'Dense_i': {'kernel': (in, out), 'bias': (out,)}}}``,
serialized with flax's msgpack encoding. :func:`params_from_msgpack`
decodes that encoding without flax and :func:`params_to_msgpack` writes
it; :func:`module_from_jax_params` and :func:`mlp_from_jax_params` build
the port's :class:`~socceraction_tpu_torch.ml.mlp.MLP` and
:class:`~socceraction_tpu_torch.ml.mlp.MLPClassifier` from the numpy
pytree, and :func:`jax_params_from_mlp` gives it back. ``msgpack`` is
imported inside the two codec functions only.
"""

from __future__ import annotations

from typing import Any, Dict, Mapping

import numpy as np
import torch

from .device import DeviceLike, resolve_device
from .ml.mlp import MLP, MLPClassifier

__all__ = [
    'jax_params_from_mlp',
    'mlp_from_jax_params',
    'module_from_jax_params',
    'params_from_msgpack',
    'params_to_msgpack',
]

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


def params_to_msgpack(tree: Mapping[str, Any]) -> bytes:
    """Encode a nested dict of numpy arrays as flax's ``to_bytes`` does.

    Keys are written in the dict's order and each array leaf as
    ``ExtType(1, packb((shape, dtype name, C-order bytes)))``, so the JAX
    package's ``serialization.from_bytes`` reads the result.
    """
    import msgpack

    def encode(node: Any) -> Any:
        if isinstance(node, Mapping):
            return {str(key): encode(value) for key, value in node.items()}
        arr = np.asarray(node)
        payload = msgpack.packb((arr.shape, arr.dtype.name, arr.tobytes('C')), use_bin_type=True)
        return msgpack.ExtType(_EXT_NDARRAY, payload)

    return msgpack.packb(encode(tree), strict_types=True)


def module_from_jax_params(params: Mapping[str, Any]) -> MLP:
    """The port's :class:`MLP`, on the CPU, from a flax ``_MLP`` pytree.

    Flax stores ``kernel`` as ``(in, out)``; ``nn.Linear.weight`` is
    ``(out, in)``, so each kernel is transposed. Layer widths come from the
    kernels' shapes and must chain (``Dense_i`` out == ``Dense_{i+1}`` in,
    one output unit at the end).
    """
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
    return module


def jax_params_from_mlp(module: MLP) -> Dict[str, Any]:
    """The flax ``_MLP`` pytree of numpy f32 arrays of a port's
    :class:`MLP`, kernels transposed back to ``(in, out)``."""
    # flax's init orders each layer's leaves bias, kernel: the same order
    # gives the same msgpack bytes
    return {'params': {
        f'Dense_{i}': {
            'bias': layer.bias.detach().cpu().numpy().astype(np.float32),
            'kernel': np.ascontiguousarray(layer.weight.detach().cpu().numpy().T, dtype=np.float32),
        }
        for i, layer in enumerate(module.layers())
    }}


def mlp_from_jax_params(
    params: Mapping[str, Any],
    mean: Any,
    std: Any,
    *,
    quantize: str = 'none',
    device: DeviceLike = None,
) -> MLPClassifier:
    """The port's fitted classifier from a flax ``_MLP`` pytree of numpy
    arrays and its statistics, on ``device``
    (:func:`module_from_jax_params`)."""
    dev = resolve_device(device)
    return MLPClassifier.from_module(
        module_from_jax_params(params).to(dev),
        torch.as_tensor(np.asarray(mean, dtype=np.float32), device=dev),
        torch.as_tensor(np.asarray(std, dtype=np.float32), device=dev),
        quantize=quantize,
    )
