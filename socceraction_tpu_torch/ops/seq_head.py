"""One GRU sequence head's logits in one launch: the embedding, the recurrence and the readout.

What :func:`~socceraction_tpu_torch.seq.model.seq_logits` returns (its plain
PyTorch version: ``table_lookup``, ``_gru_pass`` and ``_readout``, some 55
kernels a head on the card), written by one launch of the hand-written
kernel ``csrc/seq_head.cu`` from the feature rows ``(x_dense, ids)``, the
head's parameters and the dense ``(mean, std)``: on the tensor cores for a
head of ``hidden`` up to 64 whose weights fit a block, on its general
kernel for any other (:func:`check_widths`). Nothing but the logits
goes to device memory: not the embeddings, the gates, ``h`` or the
readout's concatenation.

:func:`seq_head` launches on the card or raises
:class:`~socceraction_tpu_torch.ops.cuda_build.KernelError`
(:class:`~socceraction_tpu_torch.ops.cuda_build.KernelRefused` for
operands the kernel does not take, checked before the device, so the check
runs anywhere): there is no fallback. The dispatch between the two versions
is :func:`~socceraction_tpu_torch.seq.model.seq_train_logits`: CPU inputs
and calls that want gradients run the plain version.
"""

from __future__ import annotations

import ctypes
import functools
import threading
from typing import Any

import torch

__all__ = ['check_widths', 'seq_head']

#: ``cudaErrorInvalidValue``: what the C entry returns for widths it refuses.
_INVALID_VALUE = 1
#: What a Hopper block can opt into, in floats; less the general kernel's
#: partial logits of its 8 warps, what one row of its tile may take.
_ROW_FLOATS = 232448 // 4 - 8
#: Guards the launch count, which several threads may bump at once.
_COUNT_LOCK = threading.Lock()


def check_widths(*, embed_dim: int, hidden: int, n_dense: int, readout: int, k: int) -> None:
    """Raise :class:`~socceraction_tpu_torch.ops.cuda_build.KernelRefused`,
    naming the widths, for a head the kernel cannot run at ``k`` tokens.

    Every head with widths of at least 1 runs: up to ``hidden`` 64, where
    its weights fit a block's shared memory, on the tensor cores; any other
    on the general kernel, which holds a tile of rows in shared memory, so
    that one row's token embedding, three copies of ``h`` (``h``, ``r·h``
    and the next ``h``) and dense columns, each rounded up to a multiple of
    4 floats, and its ``k`` ids must fit a block: 58,104 floats (``hidden``
    up to about 19,000). The C entry picks the kernel."""
    from .cuda_build import KernelRefused

    for name, value in (('embed_dim', embed_dim), ('hidden', hidden), ('readout', readout), ('k', k)):
        if value < 1:
            raise KernelRefused(f'seq_head takes {name} >= 1, got {value}')
    if n_dense < 0:
        raise KernelRefused(f'seq_head takes n_dense >= 0, got {n_dense}')
    row = _align4(embed_dim) + 3 * _align4(hidden) + _align4(n_dense) + k
    if row > _ROW_FLOATS:
        raise KernelRefused(
            f'seq_head refused embed_dim = {embed_dim}, hidden = {hidden}, n_dense = {n_dense}, '
            f'k = {k}: a row of its tile takes {row} floats of shared memory (embed_dim, 3 x hidden '
            f'and n_dense, each rounded up to 4, and k), above the {_ROW_FLOATS} a block can give one'
        )


def _align4(n: int) -> int:
    return (n + 3) // 4 * 4


def _params(module: Any) -> tuple:
    """The head's 14 parameter tensors in the C entry's order."""
    g, ro = module.gru, module.readout
    return (module.embed, g.wz, g.wr, g.wh, g.uz, g.ur, g.uh, g.bz, g.br, g.bh,
            ro.w1, ro.b1, ro.w2, ro.b2)


def seq_head(
    module: Any,
    x_dense: torch.Tensor,
    ids: torch.Tensor,
    dense_mean: torch.Tensor,
    dense_std: torch.Tensor,
) -> torch.Tensor:
    """Logits ``(N,)`` of the seq head ``module`` (a
    :class:`~socceraction_tpu_torch.seq.model.SeqModule`) over the rows
    ``x_dense`` ``(N, D)`` f32 and ``ids`` ``(N, k)`` int32, with the
    dense columns' ``(mean, std)`` ``(D,)``: one launch of
    ``csrc/seq_head.cu``. Adds one to ``seq_head.launches``. Anything that
    stops the launch raises
    :class:`~socceraction_tpu_torch.ops.cuda_build.KernelError`.
    """
    from .cuda_build import KernelRefused, kernel_boundary

    dims = module.dims()
    n, k = ids.shape
    check_widths(embed_dim=dims['embed_dim'], hidden=dims['hidden'], n_dense=dims['n_dense'],
                 readout=dims['readout'], k=k)
    if tuple(x_dense.shape) != (n, dims['n_dense']):
        raise KernelRefused(
            f"seq_head takes x_dense as ({n}, {dims['n_dense']}) beside ids {tuple(ids.shape)}, "
            f'got {tuple(x_dense.shape)}'
        )
    device = x_dense.device
    if device.type != 'cuda':
        raise KernelRefused(f'no kernel for device {device}')
    params = _params(module)
    floats = (x_dense, dense_mean, dense_std) + params
    if ids.dtype != torch.int32 or any(t.dtype != torch.float32 for t in floats):
        raise KernelRefused(
            f'seq_head takes int32 ids and float32 rows, statistics and parameters, got ids '
            f'{ids.dtype}, rows {x_dense.dtype}, parameters {sorted({str(p.dtype) for p in params})}'
        )
    if any(t.device != device for t in (ids,) + floats):
        raise KernelRefused(f'seq_head takes every operand on {device}')
    with kernel_boundary('seq_head'):
        return _launch(params, x_dense, ids, dense_mean, dense_std, dims)


@functools.lru_cache(maxsize=None)
def _kernel() -> Any:
    """``seq_head_f32`` of the built library, its argument types set (a
    library that fails to load is not cached, and raises again)."""
    from .cuda_build import load_library

    fn = load_library('seq_head').seq_head_f32
    fn.argtypes = (
        [ctypes.POINTER(ctypes.c_void_p)] + [ctypes.c_void_p] * 5 + [ctypes.c_longlong]
        + [ctypes.c_int] * 6 + [ctypes.c_void_p]
    )
    fn.restype = ctypes.c_int
    return fn


def _launch(params: tuple, x_dense: torch.Tensor, ids: torch.Tensor, mean: torch.Tensor,
            std: torch.Tensor, dims: dict) -> torch.Tensor:
    """:func:`seq_head` on the card: contiguous operands, the output, the launch."""
    from .cuda_build import KernelError, KernelRefused

    n, k = ids.shape
    device = x_dense.device
    out = torch.empty((n,), dtype=torch.float32, device=device)
    if n == 0:
        return out
    fn = _kernel()
    x_dense, ids, mean, std, *params = (
        t if t.is_contiguous() else t.contiguous() for t in (x_dense, ids, mean, std, *params)
    )
    pointers = (ctypes.c_void_p * len(params))(*(p.data_ptr() for p in params))
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream(device).cuda_stream
        rc = fn(
            pointers, x_dense.data_ptr(), ids.data_ptr(), mean.data_ptr(), std.data_ptr(),
            out.data_ptr(), n, k, dims['combo_size'], dims['embed_dim'], dims['hidden'],
            dims['n_dense'], dims['readout'], stream,
        )
    if rc == _INVALID_VALUE:
        raise KernelRefused(f'seq_head refused the widths {dims} at k = {k}')
    if rc != 0:
        raise KernelError(f'seq_head kernel launch failed: cudaError_t {rc}')
    # several flusher threads launch at once (the service's lanes)
    with _COUNT_LOCK:
        seq_head.launches += 1
    return out


#: Kernel launches made through :func:`seq_head` (CUDA only).
seq_head.launches = 0
