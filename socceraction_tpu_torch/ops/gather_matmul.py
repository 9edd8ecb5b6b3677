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
import threading
from typing import Any, Dict, Optional, Tuple

import torch

from .segment import segment_sum_rows

__all__ = [
    'first_layer_cost', 'fused_first_layer', 'fused_first_layer_quant', 'fused_first_layer_reference',
]

#: Shared memory a block may use on Hopper (bytes, opt-in dynamic limit).
_MAX_SMEM = 232448
#: Guards the launch counts, which several threads may bump at once.
_COUNT_LOCK = threading.Lock()

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


def first_layer_cost(
    n: int, k: int, r: int, h: int, d: int, *,
    table_dtype: torch.dtype = torch.float32, valid: Optional[int] = None,
) -> Dict[str, float]:
    """What one launch of B1 must move and compute, from its shapes.

    ``bytes``: every operand read once (``k`` tables ``(R, H)`` and
    ``W`` ``(D, H)`` in ``table_dtype``, the f32 bias, ``(N, k)`` int32
    ids, ``(N, D)`` f32 ``x``) and the ``(N, H)`` f32 output written
    once. ``tf32_flops``: the dense product as the kernel computes it,
    in 3xTF32 on the tensor cores (three TF32 products of ``2·N·D·H``,
    two for a bf16 ``W``, which is exact in TF32). ``f32_flops``: one
    add per gathered element of the ``valid`` ids (default: all
    ``N·k``, the most a call can need; pass the count of ids in
    ``[0, R)`` where the data is at hand). ``flops``: the function's own
    arithmetic, ``2·N·D·H`` plus the adds.
    """
    esize = torch.empty((), dtype=table_dtype).element_size()
    valid = n * k if valid is None else valid
    products = 3 if table_dtype == torch.float32 else 2
    return {
        'bytes': float((k * r * h + d * h) * esize + h * 4 + n * k * 4 + n * d * 4 + n * h * 4),
        'tf32_flops': float(products * 2 * n * d * h),
        'f32_flops': float(valid * h),
        'flops': float(2 * n * d * h + valid * h),
    }


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
    ``fused_first_layer_quant.launches``. Anything that stops the launch
    raises :class:`~socceraction_tpu_torch.ops.cuda_build.KernelError`.
    """
    _check(tables, w_dense, bias, ids, x_dense)
    if tables.device.type == 'cpu':
        return fused_first_layer_reference(tables, w_dense, bias, ids, x_dense)
    from .cuda_build import kernel_boundary

    with kernel_boundary('gather_matmul'):
        return _forward_cuda(tables, w_dense, bias, ids, x_dense)


def _forward_cuda(
    tables: torch.Tensor,
    w_dense: torch.Tensor,
    bias: torch.Tensor,
    ids: torch.Tensor,
    x_dense: torch.Tensor,
) -> torch.Tensor:
    """:func:`fused_first_layer_quant` on the card: build, check and launch."""
    from .cuda_build import KernelRefused, load_library

    device = tables.device
    if device.type != 'cuda':
        raise KernelRefused(f'no kernel for device {device}')
    operands = (tables, w_dense, bias, ids, x_dense)
    if not all(t.is_contiguous() for t in operands):
        raise KernelRefused('fused_first_layer_quant needs contiguous operands')
    lib = load_library('gather_matmul')
    k, r, h = tables.shape
    n, d = x_dense.shape
    _check_smem(lib, k, h, d)
    out = torch.empty((n, h), dtype=torch.float32, device=device)
    if n == 0 or h == 0:
        return out
    fn = getattr(lib, _TABLE_DTYPES[tables.dtype])
    fn.argtypes = [ctypes.c_void_p] * 6 + [ctypes.c_int] * 5 + [ctypes.c_void_p] * 2
    fn.restype = ctypes.c_int
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream(device).cuda_stream
        plan = _launch(fn, operands, out, (n, k, r, h, d), stream)
    name = plan_name(plan)
    # several flusher threads launch at once (the service's lanes): the
    # counts are read-modify-writes, so they take a lock
    with _COUNT_LOCK:
        fused_first_layer_quant.launches += 1
        fused_first_layer_quant.plans[name] = fused_first_layer_quant.plans.get(name, 0) + 1
    return out


def _check_smem(lib: Any, k: int, h: int, d: int) -> None:
    """Raise :class:`~socceraction_tpu_torch.ops.cuda_build.KernelRefused`
    when a block of the library's B1 would need more shared memory for
    these widths than a Hopper block can use."""
    smem_fn = lib.gather_matmul_smem_bytes
    smem_fn.argtypes = [ctypes.c_int] * 3
    smem_fn.restype = ctypes.c_size_t
    smem = smem_fn(k, h, d)
    if smem > _MAX_SMEM:
        from .cuda_build import KernelRefused

        raise KernelRefused(
            f'a launch for D = {d} dense columns and k = {k} tables needs {smem} bytes '
            f'of shared memory per block, over the {_MAX_SMEM} a block can use'
        )


def _launch(
    fn: Any, operands: Tuple[torch.Tensor, ...], out: torch.Tensor,
    dims: Tuple[int, ...], stream: int,
) -> int:
    """One launch of B1 through the library's entry ``fn``; returns the
    plan the kernel reported. A ``cudaError_t`` raises :class:`KernelError`."""
    from .cuda_build import KernelError

    plan = ctypes.c_int(0)
    rc = fn(*(t.data_ptr() for t in operands), out.data_ptr(), *dims, stream, ctypes.byref(plan))
    if rc != 0:
        raise KernelError(f'gather_matmul kernel launch failed: cudaError_t {rc}')
    return plan.value


def plan_name(plan: int) -> str:
    """The instantiation of B1 a launch reported (bit 0 vector access,
    bit 1 several passes over D, bit 2 x by bulk copies), in words."""
    return ', '.join((
        'vector' if plan & 1 else 'scalar',
        'several passes over D' if plan & 2 else 'one pass over D',
        'x by bulk copies' if plan & 4 else 'x row by row',
    ))


#: Kernel launches made through :func:`fused_first_layer_quant` (CUDA only).
fused_first_layer_quant.launches = 0
#: The same launches by the instantiation the kernel reported
#: (:func:`plan_name` -> count).
fused_first_layer_quant.plans = {}


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
