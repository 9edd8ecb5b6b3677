"""Calibration metrics: reliability curves, ECE, Brier, bootstrap CIs.

Port of ``socceraction_tpu/learn/calibration.py``. The promotion gate of
the learning loop judges a probability head by its *calibration* (do its
predicted probabilities match observed frequencies?) with a bootstrap
interval beside every point estimate:

- :func:`reliability_curve`: equal-width probability bins with the
  weighted mean prediction (confidence) and observed positive rate
  (accuracy) of each;
- :func:`calibration_summary`: the expected calibration error (ECE), the
  Brier score and its binned Murphy decomposition, and bootstrap
  intervals of ECE and Brier over ``n_boot`` row resamples.

The binned sums go through :func:`~socceraction_tpu_torch.ops.segment.
segment_sum` (kernel B2 on the card): count, Σp and Σy of every bin in one
launch, over ids ``bin + n_bins · stat``, and the resamples' bins in one
launch per chunk of resamples. The resamples' row indices are drawn from a
CPU ``torch.Generator`` seeded with ``seed`` and moved to the data's
device as int32, so the card and the CPU give the same intervals (the
JAX package draws with ``jax.random``: same distribution, other draws).
Chunks keep about 1 GB of resample data in flight.

Weights make padding free: a zero-weight row counts in no bin, no score
and no resample.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch

from ..device import DeviceLike, resolve_device
from ..ops.segment import segment_sum, segment_sum_reference

__all__ = ['CalibrationSummary', 'calibration_summary', 'reliability_curve']

_EPS = 1e-12
#: Bytes of resample data a chunk of the bootstrap may hold on its device.
_CHUNK_BYTES = 1 << 30
#: Bytes a chunk holds per resampled row: the int32 index, the gathered
#: (p, y, w, bin), the stacked values and their int32 ids.
_BYTES_PER_ROW = 4 + 16 + 12 + 12


def _as_tensor(a: Any, device: torch.device, dtype: torch.dtype = torch.float32) -> torch.Tensor:
    if isinstance(a, torch.Tensor):
        return a.to(device=device, dtype=dtype).reshape(-1)
    host = np.float32 if dtype == torch.float32 else np.float64
    return torch.as_tensor(np.asarray(a, dtype=host), device=device).reshape(-1)


def _flatten(
    probs: Any, labels: Any, weights: Any, device: DeviceLike,
    dtype: torch.dtype = torch.float32,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """``(p, y, w)`` flat in ``dtype`` (f32) on the device of ``probs`` when
    it is a tensor, else on ``device`` (default ``cuda``)."""
    dev = probs.device if isinstance(probs, torch.Tensor) else resolve_device(device)
    p = _as_tensor(probs, dev, dtype)
    y = _as_tensor(labels, dev, dtype)
    w = torch.ones_like(p) if weights is None else _as_tensor(weights, dev, dtype)
    if p.shape != y.shape or p.shape != w.shape:
        raise ValueError(
            f'probs/labels/weights disagree on shape: {tuple(p.shape)} vs '
            f'{tuple(y.shape)} vs {tuple(w.shape)}'
        )
    return p, y, w


def _bins(p: torch.Tensor, n_bins: int) -> torch.Tensor:
    """Equal-width bin of each probability: truncated toward zero, then
    clipped, as the JAX package's ``astype(int32)`` and ``clip``."""
    return (p * n_bins).to(torch.int32).clamp(0, n_bins - 1)


def _binned_sums(
    p: torch.Tensor, y: torch.Tensor, w: torch.Tensor, bins: torch.Tensor, n_bins: int
) -> torch.Tensor:
    """``(..., 3, n_bins)``: weighted mass, Σw·p and Σw·y of each bin, for
    every leading row of ``(..., N)`` inputs, in one segment sum."""
    lead = p.shape[:-1]
    rows = int(np.prod(lead)) if lead else 1
    vals = torch.stack([w, w * p, w * y], dim=-2)  # (..., 3, N)
    base = torch.arange(rows * 3, dtype=torch.int32, device=p.device).reshape(*lead, 3, 1)
    ids = bins.unsqueeze(-2) + base * n_bins
    if vals.dtype == torch.float64:  # the f64 reference of a check: the plain sums, unnarrowed
        if vals.device.type != 'cpu':
            raise ValueError(
                f'float64 statistics are a CPU reference; got tensors on {vals.device}'
            )
        return segment_sum_reference(vals, ids, rows * 3 * n_bins, dtype=torch.float64).reshape(
            *lead, 3, n_bins)
    return segment_sum(vals, ids, rows * 3 * n_bins).reshape(*lead, 3, n_bins)


def _point_metrics(
    p: torch.Tensor, y: torch.Tensor, w: torch.Tensor, sums: torch.Tensor
) -> Tuple[torch.Tensor, ...]:
    """``(n, ece, brier, reliability, resolution, uncertainty)`` over the
    last axis of ``(..., N)`` rows with their ``(..., 3, n_bins)`` sums."""
    wsum, psum, ysum = sums.unbind(-2)
    n = torch.clamp(w.sum(-1), min=_EPS)
    conf = psum / torch.clamp(wsum, min=_EPS)
    acc = ysum / torch.clamp(wsum, min=_EPS)
    ece = (wsum / n[..., None] * (conf - acc).abs()).sum(-1)
    brier = (w * torch.square(p - y)).sum(-1) / n
    base = (w * y).sum(-1) / n
    reliability = (wsum * torch.square(conf - acc)).sum(-1) / n
    resolution = (wsum * torch.square(acc - base[..., None])).sum(-1) / n
    uncertainty = base * (1.0 - base)
    return n, ece, brier, reliability, resolution, uncertainty


def reliability_curve(
    probs: Any,
    labels: Any,
    weights: Any = None,
    *,
    n_bins: int = 10,
    device: DeviceLike = None,
) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Weighted reliability curve over ``n_bins`` equal-width bins.

    Returns host arrays ``(confidence, accuracy, bin_weight)`` of length
    ``n_bins``; an empty bin reports zero confidence and accuracy with
    zero weight. Computed on the device of ``probs`` when it is a tensor,
    else on ``device`` (default ``cuda``).
    """
    p, y, w = _flatten(probs, labels, weights, device)
    wsum, psum, ysum = _binned_sums(p, y, w, _bins(p, n_bins), n_bins).unbind(0)
    conf = psum / torch.clamp(wsum, min=_EPS)
    acc = ysum / torch.clamp(wsum, min=_EPS)
    out = torch.stack([conf, acc, wsum]).cpu().numpy()
    return out[0], out[1], out[2]


@dataclass(frozen=True)
class CalibrationSummary:
    """Point calibration metrics plus bootstrap uncertainty for one head.

    ``ece`` is the expected calibration error (bin-weighted |confidence −
    accuracy|); ``brier`` the weighted Brier score with its binned Murphy
    decomposition (``brier ≈ reliability − resolution + uncertainty``, up
    to within-bin variance); ``ece_ci``/``brier_ci`` are bootstrap
    ``ci_level`` intervals from the resample ensemble.
    """

    n: float
    ece: float
    brier: float
    brier_reliability: float
    brier_resolution: float
    brier_uncertainty: float
    ece_ci: Tuple[float, float]
    brier_ci: Tuple[float, float]
    n_bins: int = 10
    n_boot: int = 200
    ci_level: float = 0.95
    extra: Dict[str, Any] = field(default_factory=dict)

    def to_dict(self) -> Dict[str, Any]:
        """A flat, JSON-ready rendering (promotion reports embed this)."""
        return {
            'n': self.n,
            'ece': self.ece,
            'brier': self.brier,
            'brier_reliability': self.brier_reliability,
            'brier_resolution': self.brier_resolution,
            'brier_uncertainty': self.brier_uncertainty,
            'ece_ci': list(self.ece_ci),
            'brier_ci': list(self.brier_ci),
            'n_bins': self.n_bins,
            'n_boot': self.n_boot,
            'ci_level': self.ci_level,
            **self.extra,
        }


def _resample_indices(seed: int, n_boot: int, n: int, chunk: int) -> List[torch.Tensor]:
    """``n_boot`` rows of ``n`` indices in ``[0, n)``, drawn on the CPU
    from one generator seeded with ``seed``, in chunks of ``chunk`` rows."""
    gen = torch.Generator().manual_seed(int(seed))
    return [
        torch.randint(0, n, (min(chunk, n_boot - lo), n), generator=gen, dtype=torch.int32)
        for lo in range(0, n_boot, chunk)
    ]


def calibration_summary(
    probs: Any,
    labels: Any,
    weights: Any = None,
    *,
    n_bins: int = 10,
    n_boot: int = 200,
    seed: int = 0,
    ci_level: float = 0.95,
    device: DeviceLike = None,
    _indices: Optional[Any] = None,
    _dtype: torch.dtype = torch.float32,
) -> CalibrationSummary:
    """Calibration summary of one probability head.

    Parameters
    ----------
    probs, labels, weights
        Any matching leading shape (``(G, A)`` packed tensors or flat
        rows); ``weights`` (e.g. the packed batch mask) zero out padding.
    n_bins : int
        Equal-width reliability bins.
    n_boot : int
        Bootstrap resamples of the rows.
    seed : int
        Seed of the resamples' CPU generator: a fixed seed and input give
        fixed intervals, on the card and on the CPU alike.
    ci_level : float
        Central interval mass (default 0.95); the interval's ends are
        linearly interpolated quantiles, as ``jnp.quantile`` gives them.
    device
        Where to compute when ``probs`` is not a tensor (default ``cuda``).
    _indices
        ``(n_boot, N)`` row indices to use instead of drawing them (tests
        inject the JAX package's draws).
    _dtype
        The arithmetic: ``torch.float32`` (the gate's, the JAX package's),
        or ``torch.float64`` on the CPU only, the exact sums a check holds
        an f32 result to (long f32 sums in two orders drift apart by more
        than either drifts from f64). f64 tensors on a card raise.
    """
    if n_bins < 2:
        raise ValueError(f'need at least 2 bins, got {n_bins}')
    if n_boot < 1:
        raise ValueError(f'need at least 1 bootstrap resample, got {n_boot}')
    if _dtype not in (torch.float32, torch.float64):
        raise ValueError(f'_dtype must be float32 or float64, got {_dtype}')
    p, y, w = _flatten(probs, labels, weights, device, _dtype)
    bins = _bins(p.to(torch.float32), n_bins)
    point = _point_metrics(p, y, w, _binned_sums(p, y, w, bins, n_bins))
    n_rows = p.shape[0]
    chunk = max(1, _CHUNK_BYTES // (_BYTES_PER_ROW * max(n_rows, 1)))
    if _indices is None:
        chunks = _resample_indices(seed, n_boot, n_rows, chunk)
    else:
        idx = torch.from_numpy(np.array(_indices, dtype=np.int32))
        if tuple(idx.shape) != (n_boot, n_rows):
            raise ValueError(f'_indices must have shape {(n_boot, n_rows)}, got {tuple(idx.shape)}')
        chunks = list(idx.split(chunk))
    # one row gather per chunk: (p, y, w, bin) side by side (bins < 2**24
    # are exact in f32)
    cols = torch.stack([p, y, w, bins.to(p.dtype)], dim=1)
    eces, briers = [], []
    for rows in chunks:
        drawn = cols.index_select(0, rows.to(p.device).reshape(-1)).reshape(*rows.shape, 4)
        pr, yr, wr, br = drawn.unbind(-1)
        br = br.to(torch.int32)
        _, e, b, _, _, _ = _point_metrics(pr, yr, wr, _binned_sums(pr, yr, wr, br, n_bins))
        eces.append(e)
        briers.append(b)
    lo = (1.0 - ci_level) / 2.0
    q = torch.tensor([lo, 1.0 - lo], dtype=p.dtype, device=p.device)
    ece_ci = torch.quantile(torch.cat(eces), q)
    brier_ci = torch.quantile(torch.cat(briers), q)
    host = torch.cat([torch.stack(point), ece_ci, brier_ci]).tolist()
    n, ece, brier, rel, res, unc = host[:6]
    return CalibrationSummary(
        n=n,
        ece=ece,
        brier=brier,
        brier_reliability=rel,
        brier_resolution=res,
        brier_uncertainty=unc,
        ece_ci=(host[6], host[7]),
        brier_ci=(host[8], host[9]),
        n_bins=int(n_bins),
        n_boot=int(n_boot),
        ci_level=float(ci_level),
    )
