"""Segment sum (scatter-add): ``out[s] = Σ vals[c]·[ids[c] == s]``.

Port of ``socceraction_tpu/ops/segment.py``. The xT count matrices and
every sweep of the matrix-free value iteration are segment sums over the
flat action stream. On a CUDA tensor :func:`segment_sum` launches the
hand-written kernel ``csrc/segment_sum.cu`` (built for ``sm_90a`` at first
use) at any segment count; on a CPU tensor it runs
:func:`segment_sum_reference`, the plain PyTorch version of the same
function, which the tests hold against the JAX package. There is no
fallback from one to the other: a CUDA call launches the kernel or raises.

Ids outside ``[0, num_segments)``, negatives included, contribute nothing
on both paths. The caller never indexes with ``-1``: PyTorch, like XLA's
scatter, wraps negative indices onto the last segment.
"""

from __future__ import annotations

import ctypes
import functools
from typing import Any, Dict, List, Tuple

import torch

__all__ = [
    'launch_plan',
    'segment_sum',
    'segment_sum_2d',
    'segment_sum_reference',
    'segment_sum_rows',
]

_INT32_MAX = 2**31 - 1


def _flat(values: torch.Tensor, segment_ids: torch.Tensor) -> tuple:
    vals = values.reshape(-1)
    ids = segment_ids.reshape(-1)
    if vals.shape != ids.shape:
        raise ValueError(
            f'values ({values.numel()}) and segment_ids ({segment_ids.numel()}) '
            'differ in length'
        )
    if vals.device != ids.device:
        raise ValueError(f'values on {vals.device}, segment_ids on {ids.device}')
    if ids.dtype.is_floating_point or ids.dtype == torch.bool:
        raise TypeError(f'segment_ids must be integers, got {ids.dtype}')
    return vals, ids


def segment_sum_reference(
    values: torch.Tensor, segment_ids: torch.Tensor, num_segments: int
) -> torch.Tensor:
    """The plain PyTorch version: ``(num_segments,)`` f32.

    ``index_add_`` into zeros, with out-of-range ids (negatives included)
    masked to a zero contribution to segment 0. On the CPU it adds in
    stream order, as the JAX package's XLA scatter does.
    """
    vals, ids = _flat(values, segment_ids)
    vals = vals.to(torch.float32)
    ids = ids.long()
    ok = (ids >= 0) & (ids < num_segments)
    out = torch.zeros(num_segments, dtype=torch.float32, device=vals.device)
    if num_segments == 0:
        return out
    return out.index_add_(0, torch.where(ok, ids, 0), torch.where(ok, vals, 0.0))


def segment_sum(
    values: torch.Tensor, segment_ids: torch.Tensor, num_segments: int
) -> torch.Tensor:
    """Sum ``values`` into ``num_segments`` buckets by ``segment_ids``.

    Any shape; both are flattened. CPU tensors run the plain version; CUDA
    tensors launch kernel B2 on the current stream and add one to
    ``segment_sum.launches``. Values are taken in f32 and ids in int32
    (int64 ids outside the range are clamped to ``-1`` first, so they stay
    out of range after the narrowing).
    """
    vals, ids = _flat(values, segment_ids)
    device = vals.device
    if device.type == 'cpu':
        return segment_sum_reference(vals, ids, num_segments)
    if device.type != 'cuda':
        raise ValueError(f'no kernel for device {device}')
    if not 0 <= num_segments <= _INT32_MAX:
        raise ValueError(f'num_segments={num_segments} is outside [0, 2**31)')
    if ids.dtype != torch.int32:
        ids = torch.where((ids < 0) | (ids >= num_segments), -1, ids).to(torch.int32)
    vals = vals.to(torch.float32).contiguous()
    ids = ids.contiguous()
    out = torch.empty(num_segments, dtype=torch.float32, device=device)
    n = vals.numel()
    with torch.cuda.device(device):
        grid, regime, _ = _plan(device.index, n, num_segments)
        stream = torch.cuda.current_stream(device).cuda_stream
        rc = _kernel()(
            vals.data_ptr(), ids.data_ptr(), out.data_ptr(),
            n, num_segments, grid, regime, stream,
        )
    if rc != 0:
        raise RuntimeError(f'segment_sum kernel launch failed: cudaError_t {rc}')
    if n and num_segments:  # an empty stream is only the memset
        segment_sum.launches += 1
    return out


#: Kernel launches made through :func:`segment_sum` (CUDA only).
segment_sum.launches = 0

_KERNEL: List[Any] = []
#: The kernel's regimes, by the number its launch plan gives.
_REGIMES = ('global', 'shared')


def _kernel() -> Any:
    """``segment_sum_f32`` of the built library, its argument types set."""
    if not _KERNEL:
        from .cuda_build import load_library

        fn = load_library('segment_sum').segment_sum_f32
        fn.argtypes = [ctypes.c_void_p] * 3 + [ctypes.c_longlong] + [ctypes.c_int] * 3 + [
            ctypes.c_void_p
        ]
        fn.restype = ctypes.c_int
        _KERNEL.append(fn)
    return _KERNEL[0]


@functools.lru_cache(maxsize=256)
def _plan(device_index: int, n: int, num_segments: int) -> Tuple[int, int, int]:
    """``(grid, regime, blocks_per_sm)`` of a launch of ``n`` items into
    ``num_segments`` buckets on one card: the library's occupancy and
    attribute queries run once per key, not once per call."""
    from .cuda_build import load_library

    fn = load_library('segment_sum').segment_sum_plan
    fn.argtypes = [ctypes.c_longlong, ctypes.c_int] + [ctypes.POINTER(ctypes.c_int)] * 3
    fn.restype = ctypes.c_int
    grid, regime, per_sm = ctypes.c_int(), ctypes.c_int(), ctypes.c_int()
    with torch.cuda.device(device_index):
        rc = fn(n, num_segments, ctypes.byref(grid), ctypes.byref(regime), ctypes.byref(per_sm))
    if rc != 0:
        raise RuntimeError(f'segment_sum launch plan failed: cudaError_t {rc}')
    return grid.value, regime.value, per_sm.value


def launch_plan(n: int, num_segments: int) -> Dict[str, Any]:
    """How the kernel launches for ``n`` items into ``num_segments``
    buckets on the current card: grid, regime and resident blocks per SM,
    as :func:`segment_sum` uses them."""
    grid, regime, per_sm = _plan(torch.cuda.current_device(), n, num_segments)
    return {
        'grid': grid,
        'regime': _REGIMES[regime],
        'blocks_per_sm': per_sm,
    }


def segment_sum_2d(
    values: torch.Tensor,
    row_ids: torch.Tensor,
    col_ids: torch.Tensor,
    n_rows: int,
    n_cols: int,
) -> torch.Tensor:
    """Sum ``values`` into an ``(n_rows, n_cols)`` grid by ``(row, col)`` id.

    One :func:`segment_sum` over the flat id ``row * n_cols + col``, so a
    stack of segment sums (the grouped xT counts) is one launch. A pair
    with either id outside its own axis's range contributes nothing: it is
    remapped to ``-1`` before flattening (``row=2, col=-1`` would
    otherwise flatten onto the last cell of row 1). ``n_rows * n_cols``
    must fit int32, the flat ids' type; a larger grid raises instead of
    wrapping ids into the wrong bucket.
    """
    if n_rows * n_cols > _INT32_MAX:
        raise ValueError(
            f'segment_sum_2d grid {n_rows} x {n_cols} overflows int32 flat '
            'indices; shrink the grid (for grouped xT transition counts: '
            'fewer groups, or the matrix-free solver which never builds '
            'the dense stack)'
        )
    row = row_ids.reshape(-1).to(torch.int32)
    col = col_ids.reshape(-1).to(torch.int32)
    bad = (row < 0) | (row >= n_rows) | (col < 0) | (col >= n_cols)
    flat = torch.where(bad, -1, row * n_cols + col)
    return segment_sum(values, flat, n_rows * n_cols).reshape(n_rows, n_cols)


def segment_sum_rows(
    values: torch.Tensor, segment_ids: torch.Tensor, num_segments: int
) -> torch.Tensor:
    """Sum ``(N, H)`` rows into ``(num_segments, H)`` buckets by id.

    The backward of the fused first layer's table gather, in plain
    PyTorch and split by device as the JAX package's ``segment_sum_rows``
    is (XLA, not Pallas): on the card the product of the ids' transposed
    one-hot matrix with the rows (``segment_sum_rows_onehot``, its TPU
    form), on the CPU ``index_add_`` in row order. Ids outside ``[0,
    num_segments)`` add nothing. Both add in a fixed order on every run:
    the card's ``index_add_`` would add with atomics, in another order
    each run, and a fit whose parameters move from run to run cannot be
    held to the CPU's.
    """
    values = values.reshape(-1, values.shape[-1])
    ids = segment_ids.reshape(-1).long()
    if values.is_cuda:
        segments = torch.arange(num_segments, device=ids.device)
        return (segments[:, None] == ids[None, :]).to(values.dtype) @ values
    ok = (ids >= 0) & (ids < num_segments)
    out = torch.zeros(
        (num_segments, values.shape[-1]), dtype=values.dtype, device=values.device
    )
    if num_segments == 0:
        return out
    return out.index_add_(0, torch.where(ok, ids, 0), values.masked_fill(~ok[:, None], 0))
