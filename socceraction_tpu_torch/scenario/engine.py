"""One-dispatch counterfactual valuation: fold ``P`` perturbations into ``G``.

Port of the JAX package's ``socceraction_tpu/scenario/engine.py``. The
engine rests on one identity: every VAEP kernel (feature transformers,
the fused pair fold, the formula) is **elementwise in the game axis** —
game ``g``'s values are a function of game ``g``'s rows only. So ``P``
perturbed copies of a ``(G, A)`` batch, stacked along the game axis into
``(P·G, A)``, are valued by ONE
:meth:`~socceraction_tpu_torch.vaep.base.VAEP.rate_batch` call (one
launch of the fused first-layer kernel) whose output, reshaped to
``(P, G, A, 3)``, equals ``P`` separate ``rate_batch`` calls — bitwise on
the CPU. On the card the hidden layers' matrix products may pick another
algorithm for another row count, so the fold and the loop agree there to
the f32 contract (1e-5), not bitwise.

Unlike the JAX package, the fold runs on the batch's device: fields are
repeated along the game axis and rewritten there, and caller overrides
are tiled there, so a batch on the card never crosses PCIe. Values come
back as a tensor on the model's device. A host staging batch (numpy
fields, as the rating service packs a request) folds on the host, into
numpy, as in the JAX package.
"""

from __future__ import annotations

import time
from typing import Any, Dict, Mapping, Optional, Tuple

import numpy as np
import torch

from ..core.batch import bucket_games, bucket_ladder
from ..obs import counter, gauge, histogram, span
from .grid import ScenarioGrid

__all__ = [
    'bucket_perturbations',
    'expand_scenarios',
    'perturbation_ladder',
    'rate_scenarios_batch',
    'rate_scenarios_looped',
    'rate_scenarios_reference',
]


def bucket_perturbations(n: int) -> int:
    """Round a perturbation count up to its power-of-two shape bucket
    (the perturbation axis *is* the game axis after the fold)."""
    return bucket_games(n)


def perturbation_ladder(max_perturbations: int) -> Tuple[int, ...]:
    """The perturbation bucket ladder ``(1, 2, 4, ..., B)`` up to the max."""
    return bucket_ladder(max_perturbations)


def _conflict(name: str) -> ValueError:
    return ValueError(f'dense override {name!r} supplied both by the grid and the caller')


def expand_scenarios(
    batch: Any,
    grid: ScenarioGrid,
    *,
    dense_overrides: Optional[Mapping[str, Any]] = None,
) -> Tuple[Any, Dict[str, torch.Tensor]]:
    """Fold a grid's perturbation axis into the batch's game axis.

    Returns ``(expanded_batch, expanded_overrides)``: a batch of the same
    class with ``P·G`` games (perturbation-major: games ``[p*G, (p+1)*G)``
    are perturbation ``p``), on the batch's device, plus the matching
    ``(P·G, A, width)`` dense-override blocks — the grid's own blocks
    reshaped, and any caller-supplied per-game ``(G, A, width)`` blocks
    (e.g. a serving goalscore override) tiled across perturbations.

    Fields named in ``grid.field_updates`` are rewritten (each update
    cast to the field's dtype); every other field, ``mask``/``n_actions``
    bookkeeping included, is repeated verbatim, so padding stays padding
    in every copy. Updates to fields the batch does not have (an atomic
    batch has no ``result_id``) are ignored. A host staging batch (numpy
    fields) expands on the host into numpy fields and blocks.
    """
    if isinstance(batch.type_id, np.ndarray):
        return _expand_host(batch, grid, dense_overrides)
    P = grid.n_perturbations
    G, A = batch.n_games, batch.max_actions
    dev = batch.device
    fields: Dict[str, torch.Tensor] = {}
    for name, a in batch.fields().items():
        upd = grid.field_updates.get(name)
        if upd is not None and a.ndim == 2:
            u = torch.as_tensor(upd, device=dev)
            if u.ndim == 1:
                full = u[:, None, None].expand(P, G, A)
            elif tuple(u.shape) != (P, G, A):
                raise ValueError(
                    f'field update {name!r} has shape {tuple(u.shape)}, '
                    f'batch needs (P, G, A) = ({P}, {G}, {A})'
                )
            else:
                full = u
            fields[name] = full.reshape(P * G, A).to(a.dtype)
        else:
            fields[name] = a.repeat(P, *([1] * (a.ndim - 1)))
    known = batch._host_total
    expanded = type(batch)(**fields).with_total(None if known is None else P * known)

    overrides: Dict[str, torch.Tensor] = {}
    for name, block in _grid_blocks(grid, G, A).items():
        overrides[name] = torch.as_tensor(block, device=dev)
    for name, block in dict(dense_overrides or {}).items():
        if name in overrides:
            raise _conflict(name)
        overrides[name] = torch.as_tensor(block, device=dev).repeat(P, 1, 1)
    return expanded, overrides


def _grid_blocks(grid: ScenarioGrid, G: int, A: int) -> Dict[str, np.ndarray]:
    """The grid's dense blocks checked against ``(G, A)`` and reshaped to
    ``(P·G, A, width)``."""
    P = grid.n_perturbations
    out = {}
    for name, block in grid.dense_overrides.items():
        if block.shape[1] != G or block.shape[2] != A:
            raise ValueError(
                f'dense override {name!r} has shape {block.shape}, '
                f'batch needs (P, G, A, width) with (G, A) = ({G}, {A})'
            )
        out[name] = np.ascontiguousarray(block.reshape(P * G, A, block.shape[3]))
    return out


def _expand_host(
    batch: Any, grid: ScenarioGrid, dense_overrides: Optional[Mapping[str, Any]]
) -> Tuple[Any, Dict[str, np.ndarray]]:
    """:func:`expand_scenarios` of a host staging batch, in numpy."""
    P = grid.n_perturbations
    G, A = batch.n_games, batch.max_actions
    fields: Dict[str, np.ndarray] = {}
    for name, a in batch.fields().items():
        upd = grid.field_updates.get(name)
        if upd is not None and a.ndim == 2:
            if upd.ndim == 1:
                full = np.broadcast_to(upd[:, None, None], (P, G, A))
            elif upd.shape != (P, G, A):
                raise ValueError(
                    f'field update {name!r} has shape {upd.shape}, '
                    f'batch needs (P, G, A) = ({P}, {G}, {A})'
                )
            else:
                full = upd
            fields[name] = np.ascontiguousarray(full.reshape(P * G, A)).astype(a.dtype, copy=False)
        else:
            fields[name] = np.tile(a, (P,) + (1,) * (a.ndim - 1))
    overrides = _grid_blocks(grid, G, A)
    for name, block in dict(dense_overrides or {}).items():
        if name in overrides:
            raise _conflict(name)
        overrides[name] = np.tile(np.asarray(block), (P, 1, 1))
    return type(batch)(**fields), overrides


def _perturbed_batch(batch: Any, grid: ScenarioGrid, p: int) -> Any:
    """Apply perturbation ``p`` alone to a batch (the looped reference)."""
    G, A = batch.n_games, batch.max_actions
    fields: Dict[str, torch.Tensor] = {}
    for name, a in batch.fields().items():
        upd = grid.field_updates.get(name)
        if upd is not None and a.ndim == 2:
            if upd.ndim == 1:
                fields[name] = a.new_full((G, A), upd[p].item())
            else:
                fields[name] = torch.as_tensor(upd[p], device=a.device).to(a.dtype)
        else:
            fields[name] = a
    return type(batch)(**fields).with_total(batch._host_total)


def _overrides_at(
    grid: ScenarioGrid, dense_overrides: Optional[Mapping[str, Any]], p: int
) -> Optional[Dict[str, Any]]:
    """Per-game dense overrides for perturbation ``p`` (looped reference)."""
    out: Dict[str, Any] = {name: block[p] for name, block in grid.dense_overrides.items()}
    for name, block in dict(dense_overrides or {}).items():
        if name in out:
            raise _conflict(name)
        out[name] = block
    return out or None


def rate_scenarios_batch(
    model: Any,
    batch: Any,
    grid: ScenarioGrid,
    *,
    dense_overrides: Optional[Mapping[str, Any]] = None,
    bucket: bool = True,
) -> torch.Tensor:
    """Value every perturbation of every game state in ONE ``rate_batch``.

    Expands ``(batch, grid)`` to ``P·G`` games on the batch's device,
    makes a single ``model.rate_batch`` call (bucketed to the power-of-two
    ladder by default) and returns the values as a ``(P, G, A, 3)``
    tensor. Reports under the ``scenario`` metric area: request count by
    verb, dispatch seconds by perturbation bucket (synchronized with the
    call's device work), and a counterfactual-values throughput gauge. The
    expansion runs inside a ``scenario/expand`` span, the call inside
    ``scenario/dispatch``.
    """
    P = grid.n_perturbations
    G, A = batch.n_games, batch.max_actions
    with span('scenario/expand'):
        expanded, overrides = expand_scenarios(batch, grid, dense_overrides=dense_overrides)
    counter('scenario/requests', unit='count').inc(1, verb='batch')
    p_bucket = str(bucket_perturbations(P))
    t0 = time.perf_counter()
    with span('scenario/dispatch', n_perturbations_bucket=p_bucket) as sp:
        values = sp.sync(
            model.rate_batch(expanded, dense_overrides=overrides or None, bucket=bucket)
        )
    dt = time.perf_counter() - t0
    histogram('scenario/dispatch_seconds', unit='s').observe(dt, n_perturbations_bucket=p_bucket)
    counter('scenario/values', unit='values').inc(P * G * A)
    if dt > 0:
        gauge('scenario/values_per_sec', unit='values/s').set(
            (P * G * A) / dt, n_perturbations_bucket=p_bucket
        )
    return values.reshape(P, G, A, 3)


def rate_scenarios_looped(
    model: Any,
    batch: Any,
    grid: ScenarioGrid,
    *,
    dense_overrides: Optional[Mapping[str, Any]] = None,
    bucket: bool = True,
) -> torch.Tensor:
    """The ``P``-call baseline: one ``rate_batch`` call per perturbation.

    The parity oracle of :func:`rate_scenarios_batch` (bitwise on the
    CPU) and its throughput baseline; ``(P, G, A, 3)``.
    """
    counter('scenario/requests', unit='count').inc(1, verb='looped')
    return torch.stack([
        model.rate_batch(
            _perturbed_batch(batch, grid, p),
            dense_overrides=_overrides_at(grid, dense_overrides, p),
            bucket=bucket,
        )
        for p in range(grid.n_perturbations)
    ])


def rate_scenarios_reference(
    model: Any,
    batch: Any,
    grid: ScenarioGrid,
    *,
    dense_overrides: Optional[Mapping[str, Any]] = None,
) -> torch.Tensor:
    """Looped *materialized* oracle: one ``rate_batch_reference`` call per
    perturbation — correct but slow, never fused; ``(P, G, A, 3)``."""
    counter('scenario/requests', unit='count').inc(1, verb='reference')
    return torch.stack([
        model.rate_batch_reference(
            _perturbed_batch(batch, grid, p),
            dense_overrides=_overrides_at(grid, dense_overrides, p),
        )
        for p in range(grid.n_perturbations)
    ])

