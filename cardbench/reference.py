"""The plain reference that decides ``correct``, and its lower-precision control.

The reference recomputes a configuration's values from the raw season
columns and the weights the harness made: the features of the action
language (:mod:`cardbench.families`), the standardization, both heads
(:mod:`cardbench.heads`) and the value formula, in float64, in blocks of
games so that it fits beside the season. It imports nothing of the program
under test and takes nothing the program made.

A value's gap is its distance to the nearer of the reference's two values:
from features computed in float64, and from features computed in float32
(the precision the configurations state; see :func:`gaps`).

The control is the same reference in the precision just below the one the
configurations state (float32 with TF32 off): float32 with every product of
a layer in TF32, that is with both operands rounded to TF32's 10-bit
mantissa and the products summed in float32.
"""

from __future__ import annotations

import importlib
from typing import Any, Dict, List, NamedTuple

import torch

#: Games a block of the reference computes at once.
BLOCK_GAMES = 64


def tf32(x: torch.Tensor) -> torch.Tensor:
    """``x`` (float32) rounded to TF32 (10 mantissa bits, to nearest)."""
    bits = x.contiguous().view(torch.int32)
    return ((bits + 0x1000) & -0x2000).view(torch.float32)


def tf32_matmul(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """``a @ b`` as a TF32 tensor core computes it: operands in TF32, exact
    products, float32 sums."""
    return torch.matmul(tf32(a.float()), tf32(b.float()))


class Model(NamedTuple):
    """What the reference needs of one configuration: its language and head
    modules, the configuration, the weights and the standardization."""

    family: Any
    head: Any
    config: Dict[str, Any]
    weights: Dict[str, List[Any]]
    mean: torch.Tensor
    std: torch.Tensor


def modules(config: Dict[str, Any]) -> Any:
    """The action-language and head modules a configuration names."""
    return (importlib.import_module(f"cardbench.families.{config['family']}"),
            importlib.import_module(f"cardbench.heads.{config['head']}"))


def features(family: Any, config: Dict[str, Any], fields: Dict[str, torch.Tensor]) -> Any:
    """``(features, one-hot mask)`` of a configuration's transformers."""
    return family.features(fields, config['xfns'], config['nb_prev_actions'])


def cast(fields: Dict[str, torch.Tensor], dtype: torch.dtype) -> Dict[str, torch.Tensor]:
    """The fields with every float column in ``dtype``."""
    return {n: t.to(dtype) if t.is_floating_point() else t for n, t in fields.items()}


def standardization(family: Any, config: Dict[str, Any], fields: Dict[str, torch.Tensor],
                    mask: torch.Tensor) -> Any:
    """float32 means and standard deviations of the features of the valid
    rows of ``fields`` (computed in float64; a constant column gets 1),
    and the one-hot mask."""
    x, onehot = features(family, config, cast(fields, torch.float64))
    rows = x[mask]
    std = rows.std(0, unbiased=False)
    std = torch.where(std > 0, std, torch.ones_like(std))
    return rows.mean(0).float(), std.float(), onehot


def values(model: Model, fields: Dict[str, torch.Tensor], *, feature_dtype: torch.dtype = torch.float64,
           control: bool = False) -> torch.Tensor:
    """``(G, A, 3)`` values of the games in ``fields``: the features in
    ``feature_dtype``, the rest in float64; with ``control`` everything in
    float32 with TF32 products."""
    dtype = torch.float32 if control else torch.float64
    feature_dtype = torch.float32 if control else feature_dtype
    matmul = tf32_matmul if control else torch.matmul
    mean, std = model.mean.to(dtype), model.std.to(dtype)
    n_games = next(iter(fields.values())).shape[0]
    out = []
    for g0 in range(0, n_games, BLOCK_GAMES):
        f = {n: t[g0:g0 + BLOCK_GAMES] for n, t in fields.items()}
        x, _ = features(model.family, model.config, cast(f, feature_dtype))
        x = (x.to(dtype) - mean) / std
        p = [model.head.probs(x, model.weights[col], matmul) for col in model.head.HEADS]
        out.append(model.family.values(cast(f, dtype), *p))
        del x
    return torch.cat(out)


def gaps(model: Model, fields: Dict[str, torch.Tensor], got: torch.Tensor) -> torch.Tensor:
    """``(G, A, 3)`` gap of each value of ``got`` (float64): its distance to
    the nearer of the reference's two values, from features computed in
    float64 and from features computed in float32, the configurations'
    precision, with everything after the features in float64.

    The two agree within about 1e-7 except where a feature is badly
    conditioned in float32: an angle to goal, ``atan(dy / dx)``, of a
    location within centimetres of the goal's centre after the
    left-to-right mirror, where ``dx = |L - (L - x)|`` loses the mirror's
    rounding. There a float32 program is right to either value.
    """
    exact = (got - values(model, fields)).abs()
    rounded = (got - values(model, fields, feature_dtype=torch.float32)).abs()
    return torch.minimum(exact, rounded)


def perturbed(fields: Dict[str, torch.Tensor], updates: Dict[str, List[float]]) -> Dict[str, torch.Tensor]:
    """``P`` copies of the games in ``fields`` stacked along the game axis
    (perturbation-major), field ``name`` of copy ``p`` set to
    ``updates[name][p]`` on every row."""
    n_perturbations = len(next(iter(updates.values())))
    out = {}
    for name, t in fields.items():
        tiled = t.repeat(n_perturbations, *([1] * (t.dim() - 1)))
        if name in updates:
            value = torch.tensor(updates[name], dtype=t.dtype, device=t.device)
            tiled = value.repeat_interleave(t.shape[0])[:, None].expand_as(tiled).contiguous()
        out[name] = tiled
    return out
