"""Carry weights between the JAX package's checkpoints and the port.

The JAX package stores an MLP head as a flax parameter pytree,
``{'params': {'Dense_i': {'kernel': (in, out), 'bias': (out,)}}}``, and a
GRU sequence head as a plain nested dict, ``{'embed', 'gru': {...},
'readout': {...}}``, both serialized with flax's msgpack encoding.
:func:`params_from_msgpack` decodes that encoding without flax and
:func:`params_to_msgpack` writes it; :func:`module_from_jax_params` and
:func:`mlp_from_jax_params` build the port's
:class:`~socceraction_tpu_torch.ml.mlp.MLP` and
:class:`~socceraction_tpu_torch.ml.mlp.MLPClassifier` from the numpy
pytree, and :func:`jax_params_from_mlp` gives it back;
:func:`seq_module_from_jax_params` and :func:`jax_params_from_seq_module`
do the same for the seq head's
:class:`~socceraction_tpu_torch.seq.model.SeqModule`. The codec is the
port's own and needs no ``msgpack`` package: it writes the bytes flax
writes and reads only that subset.
"""

from __future__ import annotations

from typing import Any, Dict, Mapping, Optional, Tuple

import numpy as np
import torch

from .device import DeviceLike, resolve_device
from .ml.mlp import MLP, MLPClassifier
from .seq.model import SeqModule, seq_param_shapes

__all__ = [
    'CheckpointFormatError',
    'jax_params_from_mlp',
    'jax_params_from_seq_module',
    'mlp_from_jax_params',
    'module_from_jax_params',
    'params_from_msgpack',
    'params_to_msgpack',
    'seq_module_from_jax_params',
]

#: flax's msgpack extension type of an ndarray leaf
#: (``flax.serialization._MsgpackExtType.ndarray``).
_EXT_NDARRAY = 1

#: dtype names a leaf may carry. ``bfloat16`` has no numpy dtype without
#: ``ml_dtypes``; its leaves widen exactly to float32 (the port's heads
#: hold f32 parameters either way).
_LEAF_DTYPES = frozenset({
    'bool', 'int8', 'int16', 'int32', 'int64', 'uint8', 'uint16', 'uint32', 'uint64',
    'float16', 'float32', 'float64', 'bfloat16',
})


class CheckpointFormatError(ValueError):
    """Parameter bytes outside the msgpack subset flax's ``to_bytes``
    writes for the port's heads (or truncated, or with trailing bytes)."""


# -- the msgpack subset: maps of str keys, arrays of ints, str, bin, ext ------


def _head(out: bytearray, n: int, fix: int, fix_max: int, wide: Tuple[int, ...]) -> None:
    """A length-prefixed msgpack header: the fix form when ``n`` fits its
    low bits, else the 8-, 16- or 32-bit form (``wide`` holds their type
    bytes; a 0 entry means the width does not exist for this type)."""
    if fix_max and n <= fix_max:
        out.append(fix | n)
        return
    for code, width in zip(wide, (1, 2, 4)):
        if code and n < 1 << (8 * width):
            out.append(code)
            out += n.to_bytes(width, 'big')
            return
    raise CheckpointFormatError(f'a length of {n} does not fit msgpack')


def _pack_int(out: bytearray, v: int) -> None:
    """The smallest msgpack int, as msgpack's packer picks it (unsigned
    forms for positive values, signed forms for negative ones)."""
    if 0 <= v < 128 or -32 <= v < 0:
        out += (v & 0xFF).to_bytes(1, 'big')
        return
    if v > 0:
        forms = ((0xCC, 1), (0xCD, 2), (0xCE, 4), (0xCF, 8))
        for code, width in forms:
            if v < 1 << (8 * width):
                out.append(code)
                out += v.to_bytes(width, 'big')
                return
    else:
        for code, width in ((0xD0, 1), (0xD1, 2), (0xD2, 4), (0xD3, 8)):
            if v >= -(1 << (8 * width - 1)):
                out.append(code)
                out += v.to_bytes(width, 'big', signed=True)
                return
    raise CheckpointFormatError(f'the int {v} does not fit msgpack')


def _pack_str(out: bytearray, s: str) -> None:
    raw = s.encode('utf-8')
    _head(out, len(raw), 0xA0, 31, (0xD9, 0xDA, 0xDB))
    out += raw


def _pack_leaf(out: bytearray, arr: np.ndarray) -> None:
    """``ExtType(1, packb((shape, dtype name, C-order bytes)))``."""
    if arr.dtype.name not in _LEAF_DTYPES:
        raise CheckpointFormatError(f'parameter leaves of dtype {arr.dtype} are not supported')
    payload = bytearray()
    _head(payload, 3, 0x90, 15, (0, 0xDC, 0xDD))
    _head(payload, arr.ndim, 0x90, 15, (0, 0xDC, 0xDD))
    for dim in arr.shape:
        _pack_int(payload, int(dim))
    _pack_str(payload, arr.dtype.name)
    data = arr.tobytes('C')
    _head(payload, len(data), 0, 0, (0xC4, 0xC5, 0xC6))
    payload += data
    fixext = {1: 0xD4, 2: 0xD5, 4: 0xD6, 8: 0xD7, 16: 0xD8}
    if len(payload) in fixext:
        out.append(fixext[len(payload)])
    else:
        _head(out, len(payload), 0, 0, (0xC7, 0xC8, 0xC9))
    out.append(_EXT_NDARRAY)
    out += payload


def _pack_tree(out: bytearray, node: Any) -> None:
    if isinstance(node, Mapping):
        _head(out, len(node), 0x80, 15, (0, 0xDE, 0xDF))
        for key, value in node.items():
            _pack_str(out, str(key))
            _pack_tree(out, value)
    else:
        _pack_leaf(out, np.asarray(node))


class _Reader:
    """A cursor over msgpack bytes that decodes the subset above."""

    def __init__(self, raw: Any) -> None:
        self.raw = memoryview(raw)
        self.pos = 0

    def take(self, n: int) -> memoryview:
        if self.pos + n > len(self.raw):
            raise CheckpointFormatError(
                f'parameter bytes end at {len(self.raw)}, inside a value at {self.pos}'
            )
        part = self.raw[self.pos : self.pos + n]
        self.pos += n
        return part

    def uint(self, width: int) -> int:
        return int.from_bytes(self.take(width), 'big')

    def byte(self) -> int:
        return self.take(1)[0]

    def length(self, code: int, fix: int, fix_bits: int, wide: Tuple[int, ...]) -> Optional[int]:
        """The length a header byte announces, or ``None`` if ``code`` is not
        one of this type's headers."""
        if fix_bits and code >> fix_bits == fix >> fix_bits:
            return code & ((1 << fix_bits) - 1)
        for c, width in zip(wide, (1, 2, 4)):
            if c and code == c:
                return self.uint(width)
        return None

    def value(self, what: str) -> Any:
        at = self.pos
        code = self.byte()
        n = self.length(code, 0x80, 4, (0, 0xDE, 0xDF))
        if n is not None:
            return self.mapping(n)
        n = self.length(code, 0x90, 4, (0, 0xDC, 0xDD))
        if n is not None:
            return [self.value('an array item') for _ in range(n)]
        n = self.length(code, 0xA0, 5, (0xD9, 0xDA, 0xDB))
        if n is not None:
            return bytes(self.take(n)).decode('utf-8')
        n = self.length(code, 0, 0, (0xC4, 0xC5, 0xC6))
        if n is not None:
            return bytes(self.take(n))
        if code < 0x80 or code >= 0xE0:
            return code - 0x100 if code >= 0xE0 else code
        unsigned = {0xCC: 1, 0xCD: 2, 0xCE: 4, 0xCF: 8}
        signed = {0xD0: 1, 0xD1: 2, 0xD2: 4, 0xD3: 8}
        if code in unsigned:
            return self.uint(unsigned[code])
        if code in signed:
            return int.from_bytes(self.take(signed[code]), 'big', signed=True)
        fixext = {0xD4: 1, 0xD5: 2, 0xD6: 4, 0xD7: 8, 0xD8: 16}
        n = fixext.get(code)
        if n is None:
            n = self.length(code, 0, 0, (0xC7, 0xC8, 0xC9))
        if n is not None:
            return self.ext(n)
        raise CheckpointFormatError(
            f'unsupported msgpack type byte 0x{code:02x} at {at} ({what}); parameter '
            'checkpoints hold maps of str keys and ndarray leaves only'
        )

    def mapping(self, n: int) -> Dict[str, Any]:
        out: Dict[str, Any] = {}
        for _ in range(n):
            key = self.value('a map key')
            if not isinstance(key, str):
                raise CheckpointFormatError(f'a map key is a {type(key).__name__}, not a str')
            if key == '__msgpack_chunked_array__':
                raise CheckpointFormatError(
                    'chunked (> 1 GiB) parameter leaves are not supported'
                )
            out[key] = self.value(f'the value of {key!r}')
        return out

    def ext(self, n: int) -> np.ndarray:
        code = self.byte()
        if code != _EXT_NDARRAY:
            raise CheckpointFormatError(f'unsupported msgpack extension type {code} in parameters')
        inner = _Reader(self.take(n))
        leaf = inner.value('an ndarray leaf')
        if inner.pos != len(inner.raw):
            raise CheckpointFormatError('trailing bytes inside an ndarray leaf')
        if not (
            isinstance(leaf, list) and len(leaf) == 3 and isinstance(leaf[0], list)
            and all(isinstance(d, int) and d >= 0 for d in leaf[0])
            and isinstance(leaf[1], str) and isinstance(leaf[2], bytes)
        ):
            raise CheckpointFormatError('an ndarray leaf is not (shape, dtype name, bytes)')
        shape, name, buffer = leaf
        if name not in _LEAF_DTYPES:
            raise CheckpointFormatError(f'parameter leaves of dtype {name!r} are not supported')
        if name == 'bfloat16':
            # bf16 is the top half of an f32: widen exactly
            bits = np.frombuffer(buffer, dtype=np.uint16)
            arr = (bits.astype(np.uint32) << 16).view(np.float32)
        else:
            arr = np.frombuffer(buffer, dtype=np.dtype(name))
        if arr.size != int(np.prod(shape, dtype=np.int64)):
            raise CheckpointFormatError(
                f'an ndarray leaf of shape {tuple(shape)} holds {arr.size} {name} values'
            )
        return arr.reshape(shape, order='C')


def params_from_msgpack(raw: bytes) -> Dict[str, Any]:
    """Decode flax-msgpack bytes into a nested dict of numpy arrays.

    flax encodes each array leaf as ``ExtType(1, packb((shape, dtype name,
    C-order bytes)))``. The decoder reads the subset ``to_bytes`` writes
    for the port's heads (maps of str keys, those leaves, and the int, str,
    bin and ext widths they need) and raises :class:`CheckpointFormatError`
    on anything else, including the chunked form flax uses for leaves over
    1 GiB. Leaves are read-only arrays; bf16 leaves come back widened
    exactly to f32.
    """
    reader = _Reader(raw)
    tree = reader.value('the parameter tree')
    if not isinstance(tree, dict):
        raise CheckpointFormatError(f'the parameter tree is a {type(tree).__name__}, not a map')
    if reader.pos != len(reader.raw):
        raise CheckpointFormatError(
            f'{len(reader.raw) - reader.pos} trailing bytes after the parameter tree'
        )
    return tree


def params_to_msgpack(tree: Mapping[str, Any]) -> bytes:
    """Encode a nested dict of numpy arrays as flax's ``to_bytes`` does.

    Keys are written in the dict's order and each array leaf as
    ``ExtType(1, packb((shape, dtype name, C-order bytes)))``, each value
    in the smallest msgpack form, so the bytes equal ``to_bytes``'s and
    the JAX package's ``serialization.from_bytes`` reads them.
    """
    if not isinstance(tree, Mapping):
        raise CheckpointFormatError(f'the parameter tree is a {type(tree).__name__}, not a map')
    out = bytearray()
    _pack_tree(out, tree)
    return bytes(out)


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


def seq_module_from_jax_params(params: Mapping[str, Any]) -> SeqModule:
    """The port's :class:`SeqModule`, on the CPU, from the JAX package's seq
    parameter tree (numpy arrays). The dimensions come from the leaves,
    whose structure and shapes must be those of
    :func:`~socceraction_tpu_torch.seq.model.seq_param_shapes`."""
    try:
        embed = np.asarray(params['embed'])
        dims = {
            'combo_size': embed.shape[0],
            'embed_dim': embed.shape[1],
            'hidden': np.asarray(params['gru']['uz']).shape[0],
            'readout': np.asarray(params['readout']['w1']).shape[1],
        }
        dims['n_dense'] = np.asarray(params['readout']['w1']).shape[0] - dims['hidden']
    except (KeyError, IndexError, TypeError) as e:
        raise ValueError(f'not a seq parameter tree ({type(e).__name__}: {e})') from e
    want = seq_param_shapes(**dims)
    got = {
        'embed': embed.shape,
        'gru': {n: np.shape(a) for n, a in params['gru'].items()},
        'readout': {n: np.shape(a) for n, a in params['readout'].items()},
    }
    if sorted(params) != sorted(want) or got != want:
        raise ValueError(f'seq parameter shapes {got} do not form a head; expected {want}')
    module = SeqModule(**dims)
    with torch.no_grad():
        for name, p in module.named_parameters():
            node: Any = params
            for part in name.split('.'):
                node = node[part]
            # copies: decoded leaves are read-only views of the msgpack buffer
            p.copy_(torch.from_numpy(np.array(node, dtype=np.float32)))
    return module


def jax_params_from_seq_module(module: SeqModule) -> Dict[str, Any]:
    """The JAX package's seq parameter tree of numpy f32 arrays, keys in
    sorted order at every level (the order the JAX package's tree
    functions leave them in, so the msgpack bytes are the same)."""
    tree: Dict[str, Any] = {}
    for name, p in sorted(module.named_parameters()):
        *groups, leaf = name.split('.')
        node = tree
        for g in groups:
            node = node.setdefault(g, {})
        node[leaf] = p.detach().cpu().numpy().astype(np.float32)
    return tree
