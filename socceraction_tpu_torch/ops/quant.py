"""Narrow-precision storage for the fused combined tables.

Port of ``socceraction_tpu/ops/quant.py``. Three formats:

- ``'none'``: f32 storage;
- ``'bf16'``: bfloat16 storage, widened inside the first-layer kernel;
- ``'int8'``: symmetric per-row int8 (one f32 scale per table row) plus a
  packed 2-bit refinement plane of the rounding residual, four codes per
  byte, expanded to a transient f32 table per dispatch by
  :func:`dequantize`.

Accumulation stays f32 everywhere. From the same f32 tables the port
produces the same bytes as the JAX package: every step is an elementwise
f32 operation with the same rounding (round half to even). Training
sees the same rounding through :func:`fake_quant`.
"""

from __future__ import annotations

from typing import Any, NamedTuple, Optional, Tuple

import torch

__all__ = [
    'INT8_QMAX',
    'QUANTIZE_MODES',
    'QuantizedArray',
    'check_quantize_mode',
    'dequantize',
    'fake_quant',
    'quantize_columns',
    'quantize_with_scale',
    'quantized_nbytes',
]

#: The supported table storage formats, in widening order of error band.
QUANTIZE_MODES = ('none', 'bf16', 'int8')

#: Symmetric int8 clip bound (-128 is excluded so ``-t`` quantizes to ``-q(t)``).
INT8_QMAX = 127.0

#: Codes per packed refinement byte (2 bits each).
_CODES_PER_BYTE = 4


class QuantizedArray(NamedTuple):
    """One array in quantized storage: data plane, refinement, scales.

    ``resid`` and ``scale`` are ``None`` except for ``'int8'``: ``data``
    int8 ``(..., R, H)``, ``resid`` uint8 ``(..., R, ceil(H/4))`` packed
    2-bit codes, ``scale`` f32 ``(..., R, 1)``. ``'bf16'`` stores ``data``
    as bfloat16, ``'none'`` as f32.
    """

    data: torch.Tensor
    resid: Optional[torch.Tensor]
    scale: Optional[torch.Tensor]


def check_quantize_mode(mode: str) -> str:
    """Validate (and return) a quantization mode string."""
    if mode not in QUANTIZE_MODES:
        raise ValueError(
            f'unknown quantize mode {mode!r} (want one of {QUANTIZE_MODES})'
        )
    return mode


def _pack_codes(codes: torch.Tensor) -> torch.Tensor:
    """Pack 4-level codes (0..3) four per byte along the last axis.

    The last axis is split into ``ceil(H/4)`` quarter blocks: byte ``c``
    holds the codes of columns ``c``, ``c + Hq``, ``c + 2·Hq``, ``c + 3·Hq``
    in bit pairs 0-1 … 6-7 (columns past ``H`` pad as code 0).
    """
    h = codes.shape[-1]
    hq = -(-h // _CODES_PER_BYTE)
    pad = hq * _CODES_PER_BYTE - h
    if pad:
        codes = torch.nn.functional.pad(codes, (0, pad))
    packed = torch.zeros(codes.shape[:-1] + (hq,), dtype=torch.uint8, device=codes.device)
    for j in range(_CODES_PER_BYTE):
        block = codes[..., j * hq : (j + 1) * hq].to(torch.uint8)
        packed = packed | (block << (2 * j))
    return packed


def _unpack_codes(packed: torch.Tensor, h: int) -> torch.Tensor:
    """Inverse of :func:`_pack_codes` -> f32 codes ``(..., h)``."""
    parts = [
        ((packed >> (2 * j)) & 3).to(torch.float32) for j in range(_CODES_PER_BYTE)
    ]
    return torch.cat(parts, dim=-1)[..., :h]


def quantize_columns(t: torch.Tensor, mode: str) -> QuantizedArray:
    """Quantize ``(..., R, H)`` f32 tables to ``mode`` storage.

    For ``'int8'`` the scale is per row (reduced over the hidden axis); an
    all-zero row gets scale 0 and reconstructs to exact zeros.
    """
    check_quantize_mode(mode)
    t = t.to(torch.float32)
    if mode == 'none':
        return QuantizedArray(t, None, None)
    if mode == 'bf16':
        return QuantizedArray(t.to(torch.bfloat16), None, None)
    amax = t.abs().amax(dim=-1, keepdim=True)
    scale = torch.where(amax > 0, amax / INT8_QMAX, 0.0)
    data, resid = quantize_with_scale(t, scale)
    return QuantizedArray(data, resid, scale)


def quantize_with_scale(
    t: torch.Tensor, scale: torch.Tensor
) -> Tuple[torch.Tensor, torch.Tensor]:
    """int8 base plane + packed refinement for ``t`` under FIXED f32 scales.

    A model loaded from a checkpoint re-quantizes with the scales the
    checkpoint persisted (``models/quant_scales.npz``), so it serves the
    bytes the saved version served. Returns ``(data int8, resid uint8)``.
    """
    t = t.to(torch.float32)
    positive = scale > 0
    grid = torch.where(positive, t / torch.where(positive, scale, 1.0), 0.0)
    base = torch.clamp(torch.round(grid), -INT8_QMAX, INT8_QMAX)
    # rounding residual in grid units, onto a centred 4-level grid
    # (codes 0..3 -> levels (code - 1.5) / 4)
    r = grid - base
    codes = torch.clamp(torch.round(r * _CODES_PER_BYTE + 1.5), 0, 3)
    return base.to(torch.int8), _pack_codes(codes)


def dequantize(
    data: torch.Tensor,
    resid: Optional[torch.Tensor] = None,
    scale: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """f32 view of quantized storage (transient, built per dispatch)."""
    x = data.to(torch.float32)
    if scale is None:
        return x
    if resid is not None:
        x = x + (_unpack_codes(resid, x.shape[-1]) - 1.5) / _CODES_PER_BYTE
    return x * scale


class _FakeQuant(torch.autograd.Function):
    """Quantize -> dequantize forward, identity backward."""

    @staticmethod
    def forward(ctx: Any, t: torch.Tensor, mode: str) -> torch.Tensor:
        return dequantize(*quantize_columns(t, mode))

    @staticmethod
    def backward(ctx: Any, g: torch.Tensor) -> Tuple[torch.Tensor, None]:
        return g, None


def fake_quant(t: torch.Tensor, mode: str) -> torch.Tensor:
    """Quantize-dequantize round trip with a straight-through gradient.

    The quantization-aware training hook of the fused training fold: the
    per-state tables and the dense sub-kernel pass through it every step,
    so the loss sees exactly the values quantized serving gathers, while
    the backward skips the (non-differentiable) rounding:
    ``d fake_quant / d t = 1``. ``mode='none'`` is the identity.
    """
    if check_quantize_mode(mode) == 'none':
        return t
    return _FakeQuant.apply(t, mode)


def quantized_nbytes(q: QuantizedArray) -> int:
    """Device bytes of one :class:`QuantizedArray` (planes + scales)."""
    return sum(a.numel() * a.element_size() for a in q if a is not None)
