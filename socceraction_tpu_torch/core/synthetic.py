"""Synthetic SPADL action batches for the smoke run and the tests.

Port of ``synthetic_batch`` and ``_draw_spadl_columns`` from
``socceraction_tpu/core/synthetic.py``. The draws are numpy's, in the same
order, so one seed gives a batch bitwise equal to the JAX package's.
"""

from __future__ import annotations

from typing import Any, Dict

import numpy as np

from ..device import DeviceLike, resolve_device
from ..spadl import config as spadlconfig
from .batch import ActionBatch, _from_numpy

__all__ = ['synthetic_batch']


def _draw_spadl_columns(
    rng: np.random.Generator, G: int, A: int, float_dtype: Any, int_dtype: Any
) -> Dict[str, np.ndarray]:
    """Draw the marginal SPADL column distributions for a ``(G, A)`` grid.

    Passes dominate, then dribbles, then a tail over the other types;
    period and clock are monotone; end points are noisy displacements of
    start points.
    """
    n_types = len(spadlconfig.actiontypes)
    probs = np.full(n_types, 0.02)
    probs[spadlconfig.PASS] = 0.45
    probs[spadlconfig.DRIBBLE] = 0.25
    probs[spadlconfig.SHOT] = 0.03
    probs /= probs.sum()

    L, W = spadlconfig.field_length, spadlconfig.field_width
    type_id = rng.choice(n_types, size=(G, A), p=probs).astype(int_dtype)
    result_id = rng.choice(
        len(spadlconfig.results), size=(G, A), p=[0.25, 0.68, 0.02, 0.02, 0.02, 0.01]
    ).astype(int_dtype)
    bodypart_id = rng.choice(
        len(spadlconfig.bodyparts), size=(G, A), p=[0.85, 0.08, 0.05, 0.02]
    ).astype(int_dtype)
    period_id = np.sort(rng.integers(1, 5, size=(G, A)), axis=1).astype(int_dtype)
    time_seconds = np.sort(
        rng.uniform(0, 3000, size=(G, A)).astype(float_dtype), axis=1
    )
    start_x = rng.uniform(0, L, size=(G, A)).astype(float_dtype)
    start_y = rng.uniform(0, W, size=(G, A)).astype(float_dtype)
    end_x = np.clip(start_x + rng.normal(0, 12, size=(G, A)), 0, L).astype(float_dtype)
    end_y = np.clip(start_y + rng.normal(0, 8, size=(G, A)), 0, W).astype(float_dtype)
    is_home = rng.integers(0, 2, size=(G, A)).astype(bool)
    return {
        'type_id': type_id,
        'result_id': result_id,
        'bodypart_id': bodypart_id,
        'period_id': period_id,
        'time_seconds': time_seconds,
        'start_x': start_x,
        'start_y': start_y,
        'end_x': end_x,
        'end_y': end_y,
        'is_home': is_home,
    }


def synthetic_batch(
    n_games: int = 64,
    n_actions: int = 1664,
    *,
    fill: float = 1.0,
    seed: int = 0,
    device: DeviceLike = None,
) -> ActionBatch:
    """A random but schema-valid ``(G, A)`` batch on ``device`` (default ``cuda``).

    ``n_actions`` defaults to 1664 (13 x 128), a typical SPADL game length
    rounded to the lane multiple; ``fill`` is the valid fraction of each
    game's action axis (the rest is padding).
    """
    dev = resolve_device(device)
    rng = np.random.default_rng(seed)
    G, A = n_games, n_actions
    n_valid = max(2, int(A * fill))

    cols = _draw_spadl_columns(rng, G, A, np.float32, np.int32)
    mask = np.zeros((G, A), dtype=bool)
    mask[:, :n_valid] = True
    row_index = np.full((G, A), -1, dtype=np.int32)
    row_index[mask] = np.arange(G * n_valid, dtype=np.int32)
    cols['mask'] = mask
    cols['n_actions'] = np.full(G, n_valid, dtype=np.int32)
    cols['game_id'] = np.arange(G, dtype=np.int32)
    cols['row_index'] = row_index
    return _from_numpy(cols, dev)
