"""Fused gather + dense first layer: ``bias + Σ tables[i][ids[:, i]] + x @ W``.

Port of ``socceraction_tpu/ops/gather_matmul.py``. On a CUDA tensor
:func:`fused_first_layer_quant` launches the hand-written kernel
``csrc/gather_matmul.cu`` (built for ``sm_90a`` at first use); on a CPU
tensor it runs :func:`fused_first_layer_reference`, the plain PyTorch
version of the same function, which the tests hold against the JAX
package. There is no fallback from one to the other: a CUDA call launches
the kernel or raises.

:func:`fused_first_layer` is the differentiable entry the trainer uses:
its forward is the same kernel on f32 operands, its backward plain
PyTorch, as the JAX package's custom VJP computes it with XLA: a row
segment sum per table and two products.
"""

from __future__ import annotations

import ctypes
from typing import Any, Optional, Tuple

import torch

from .segment import segment_sum_rows

__all__ = ['fused_first_layer', 'fused_first_layer_quant', 'fused_first_layer_reference']

#: Shared memory a block may use on Hopper (bytes, opt-in dynamic limit).
_MAX_SMEM = 232448

_TABLE_DTYPES = {torch.float32: 'gather_matmul_f32', torch.bfloat16: 'gather_matmul_bf16'}


def fused_first_layer_reference(
    tables: torch.Tensor,
    w_dense: torch.Tensor,
    bias: torch.Tensor,
    ids: torch.Tensor,
    x_dense: torch.Tensor,
) -> torch.Tensor:
    """The plain PyTorch version: ``(N, H)`` f32 first-layer activations.

    Accumulates in the JAX lowering's order (bias, each state's gathered
    row, then the dense product). An id outside ``[0, R)`` adds nothing:
    it is masked explicitly, because ``table[-1]`` would read the last
    real row (the JAX lowering instead pads the table with a zero row).
    """
    k, r, h = tables.shape
    out = bias.to(torch.float32).expand(ids.shape[0], h).clone()
    for i in range(k):
        col = ids[:, i].long()
        valid = (col >= 0) & (col < r)
        rows = tables[i].to(torch.float32)[col.clamp(0, max(r - 1, 0))]
        out = out + rows.masked_fill(~valid[:, None], 0.0)
    if x_dense.shape[1]:
        out = out + x_dense @ w_dense.to(torch.float32)
    return out


def _check(
    tables: torch.Tensor,
    w_dense: torch.Tensor,
    bias: torch.Tensor,
    ids: torch.Tensor,
    x_dense: torch.Tensor,
) -> None:
    """Raise on any operand the kernel does not take."""
    if tables.dim() != 3:
        raise ValueError(f'tables must be (k, R, H), got shape {tuple(tables.shape)}')
    k, _r, h = tables.shape
    n = ids.shape[0]
    if tables.dtype not in _TABLE_DTYPES:
        raise TypeError(f'tables must be float32 or bfloat16, got {tables.dtype}')
    if w_dense.dtype != tables.dtype:
        raise TypeError(
            f'w_dense dtype {w_dense.dtype} differs from the tables {tables.dtype}'
        )
    want = {
        'bias': (bias, (h,), torch.float32),
        'ids': (ids, (n, k), torch.int32),
        'x_dense': (x_dense, (n, x_dense.shape[-1]), torch.float32),
        'w_dense': (w_dense, (x_dense.shape[-1], h), w_dense.dtype),
    }
    for name, (t, shape, dtype) in want.items():
        if t.dim() != len(shape) or tuple(t.shape) != shape:
            raise ValueError(f'{name} must have shape {shape}, got {tuple(t.shape)}')
        if t.dtype != dtype:
            raise TypeError(f'{name} must be {dtype}, got {t.dtype}')
    devices = {t.device for t in (tables, w_dense, bias, ids, x_dense)}
    if len(devices) != 1:
        raise ValueError(f'operands live on several devices: {sorted(map(str, devices))}')


def fused_first_layer_quant(
    tables: torch.Tensor,
    w_dense: torch.Tensor,
    bias: torch.Tensor,
    ids: torch.Tensor,
    x_dense: torch.Tensor,
) -> torch.Tensor:
    """Fused first layer over narrow storage -> ``(N, H)`` f32.

    ``tables`` ``(k, R, H)`` and ``w_dense`` ``(D, H)`` are both f32 or
    both bf16 (int8 storage is dequantized to f32 by the caller); ``bias``
    ``(H,)`` and ``x_dense`` ``(N, D)`` are f32, ``ids`` ``(N, k)`` int32.
    CPU operands run the plain version; CUDA operands (contiguous) launch
    the kernel on the current stream and add one to
    ``fused_first_layer_quant.launches``.
    """
    _check(tables, w_dense, bias, ids, x_dense)
    device = tables.device
    if device.type == 'cpu':
        return fused_first_layer_reference(tables, w_dense, bias, ids, x_dense)
    if device.type != 'cuda':
        raise ValueError(f'no kernel for device {device}')
    operands = (tables, w_dense, bias, ids, x_dense)
    if not all(t.is_contiguous() for t in operands):
        raise ValueError('fused_first_layer_quant needs contiguous operands')
    from .cuda_build import load_library

    lib = load_library('gather_matmul')
    k, r, h = tables.shape
    n, d = x_dense.shape
    smem_fn = lib.gather_matmul_smem_bytes
    smem_fn.argtypes = [ctypes.c_int] * 3
    smem_fn.restype = ctypes.c_size_t
    smem = smem_fn(k, h, d)
    if smem > _MAX_SMEM:
        raise ValueError(
            f'a launch for D = {d} dense columns and k = {k} tables needs {smem} bytes '
            f'of shared memory per block, over the {_MAX_SMEM} a block can use'
        )
    out = torch.empty((n, h), dtype=torch.float32, device=device)
    if n == 0 or h == 0:
        return out
    fn = getattr(lib, _TABLE_DTYPES[tables.dtype])
    fn.argtypes = [ctypes.c_void_p] * 6 + [ctypes.c_int] * 5 + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream(device).cuda_stream
        rc = fn(
            *(t.data_ptr() for t in operands), out.data_ptr(),
            n, k, r, h, d, stream,
        )
    if rc != 0:
        raise RuntimeError(f'gather_matmul kernel launch failed: cudaError_t {rc}')
    fused_first_layer_quant.launches += 1
    return out


#: Kernel launches made through :func:`fused_first_layer_quant` (CUDA only).
fused_first_layer_quant.launches = 0


class _FusedFirstLayer(torch.autograd.Function):
    """Forward: kernel B1 (or its plain version on the CPU). Backward: the
    JAX package's ``_ffl_bwd``, in plain PyTorch."""

    @staticmethod
    def forward(
        ctx: Any,
        tables: torch.Tensor,
        w_dense: torch.Tensor,
        bias: torch.Tensor,
        ids: torch.Tensor,
        x_dense: torch.Tensor,
    ) -> torch.Tensor:
        ctx.save_for_backward(ids, x_dense, w_dense)
        ctx.num_rows = tables.shape[1]
        return fused_first_layer_quant(tables, w_dense, bias, ids, x_dense)

    @staticmethod
    def backward(ctx: Any, g: torch.Tensor) -> Tuple[Optional[torch.Tensor], ...]:
        ids, x_dense, w_dense = ctx.saved_tensors
        need = ctx.needs_input_grad
        g = g.to(torch.float32)
        d_tables = d_w = d_bias = d_x = None
        if need[0]:
            d_tables = torch.stack(
                [segment_sum_rows(g, ids[:, i], ctx.num_rows) for i in range(ids.shape[1])]
            )
        if need[1]:
            d_w = x_dense.t() @ g
        if need[2]:
            d_bias = g.sum(0)
        if need[4]:  # in training x_dense is data: skipped
            d_x = g @ w_dense.t()
        return d_tables, d_w, d_bias, None, d_x


def fused_first_layer(
    tables: torch.Tensor,
    w_dense: torch.Tensor,
    bias: torch.Tensor,
    ids: torch.Tensor,
    x_dense: torch.Tensor,
) -> torch.Tensor:
    """Differentiable fused first layer over packed rows -> ``(N, H)`` f32.

    ``tables`` ``(k, R, H)``, ``w_dense`` ``(D, H)``, ``bias`` ``(H,)`` and
    ``x_dense`` ``(N, D)`` are f32, ``ids`` ``(N, k)`` int32. The forward is
    :func:`fused_first_layer_quant` (kernel B1 on a CUDA tensor, counted in
    ``fused_first_layer_quant.launches``). The backward gives
    ``d_tables[i]``, the row segment sum of the cotangent by ``ids[:, i]``
    (ids outside ``[0, R)`` add nothing), ``d_w_dense = x_denseᵀ g``,
    ``d_bias = Σ g`` and, only where autograd asks for it,
    ``d_x_dense = g W_denseᵀ``. The products follow the global matmul
    precision: the parity contract wants TF32 off on the card.
    """
    if tables.dtype != torch.float32:
        raise TypeError(f'the differentiable first layer takes f32 tables, got {tables.dtype}')
    return _FusedFirstLayer.apply(tables, w_dense, bias, ids, x_dense)
