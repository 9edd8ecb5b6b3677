"""The padded ``(G games, A actions)`` bundle of SPADL or Atomic-SPADL
actions, as tensors.

Port of ``socceraction_tpu/core/batch.py`` with the same semantics: games
are left-aligned along the action axis and padded to a multiple of
:data:`~socceraction_tpu_torch.config.ACTION_AXIS_ALIGNMENT`; team identity
is reduced to ``is_home``; ``mask`` marks valid rows, ``row_index`` is each
row's position in the packed frame (``-1`` on padding) and ``game_id`` is
the game's index in the batch.
"""

from __future__ import annotations

import dataclasses
from typing import TYPE_CHECKING, Any, Dict, List, Optional, Tuple

import numpy as np
import torch

from ..config import ACTION_AXIS_ALIGNMENT
from ..device import DeviceLike, resolve_device

if TYPE_CHECKING:  # pandas is imported inside pack_actions only
    import pandas as pd

__all__ = [
    'ActionBatch',
    'AtomicActionBatch',
    'bucket_games',
    'bucket_ladder',
    'pack_actions',
    'pack_atomic_actions',
    'pack_row_values',
    'pad_batch_games',
    'pad_length',
    'unpack_values',
]

_LANE = ACTION_AXIS_ALIGNMENT

_FLOAT_COLS = ('time_seconds', 'start_x', 'start_y', 'end_x', 'end_y')
_INT_COLS = ('type_id', 'result_id', 'bodypart_id', 'period_id')
_ATOMIC_FLOAT_COLS = ('time_seconds', 'x', 'y', 'dx', 'dy')
_ATOMIC_INT_COLS = ('type_id', 'bodypart_id', 'period_id')


def pad_length(n: int, multiple: int = _LANE) -> int:
    """Round ``n`` up to a multiple of ``multiple`` (minimum one tile)."""
    return max(multiple, ((n + multiple - 1) // multiple) * multiple)


def torch_dtype(dtype: Any) -> torch.dtype:
    """The torch dtype of ``dtype``: a torch dtype as it is, else whatever
    numpy reads as a dtype (``'float32'``, ``np.float64``, ...)."""
    if isinstance(dtype, torch.dtype):
        return dtype
    return torch.from_numpy(np.empty(0, dtype=np.dtype(dtype))).dtype


class _PackedBatch:
    """What every packed batch class shares: shape properties, its fields
    in declaration order and a move to another device. Per-action fields
    have shape ``(G, A)``; ``n_actions`` and ``game_id`` are ``(G,)``.
    Every field lives on one device."""

    #: For a batch shipped to the card on a side stream
    #: (``pipeline/packed.py``): the CUDA event after which its fields hold
    #: their values. Not a field; ``None`` on every batch made otherwise.
    ready: Any = None

    @property
    def n_games(self) -> int:
        """Number of games (leading axis)."""
        return self.type_id.shape[0]

    @property
    def max_actions(self) -> int:
        """Padded per-game action capacity (second axis)."""
        return self.type_id.shape[1]

    @property
    def total_actions(self) -> int:
        """Total number of valid (unpadded) actions, as a host int."""
        return int(self.n_actions.sum())

    @property
    def device(self) -> torch.device:
        """The device every field lives on."""
        return self.type_id.device

    def fields(self) -> Dict[str, torch.Tensor]:
        """``{name: tensor}`` of every field, in declaration order."""
        return {f.name: getattr(self, f.name) for f in dataclasses.fields(self)}

    def to(self, device: DeviceLike) -> Any:
        """A copy with every field on ``device``."""
        dev = resolve_device(device)
        return type(self)(**{n: t.to(dev) for n, t in self.fields().items()})

    def astype(self, float_dtype: Any) -> Any:
        """A copy with the continuous fields cast to ``float_dtype`` (a
        torch dtype or anything numpy reads as a dtype); every other field
        is shared."""
        dtype = torch_dtype(float_dtype)
        return dataclasses.replace(
            self, **{c: getattr(self, c).to(dtype) for c in self._float_fields}
        )


@dataclasses.dataclass(frozen=True)
class ActionBatch(_PackedBatch):
    """A padded ``(G, A)`` struct-of-tensors bundle of SPADL actions."""

    _float_fields = _FLOAT_COLS

    type_id: torch.Tensor  # int32
    result_id: torch.Tensor  # int32
    bodypart_id: torch.Tensor  # int32
    period_id: torch.Tensor  # int32
    is_home: torch.Tensor  # bool: team_id == home_team_id
    time_seconds: torch.Tensor  # float
    start_x: torch.Tensor  # float
    start_y: torch.Tensor  # float
    end_x: torch.Tensor  # float
    end_y: torch.Tensor  # float
    mask: torch.Tensor  # bool (G, A): True on valid rows
    n_actions: torch.Tensor  # int32 (G,): valid rows per game
    game_id: torch.Tensor  # int32 (G,): game index in the batch
    row_index: torch.Tensor  # int32 (G, A): row in the packed frame (-1 pad)


@dataclasses.dataclass(frozen=True)
class AtomicActionBatch(_PackedBatch):
    """A padded ``(G, A)`` struct-of-tensors bundle of Atomic-SPADL actions:
    a location and a displacement ``(x, y, dx, dy)`` per row and no result
    (outcomes are action types)."""

    _float_fields = _ATOMIC_FLOAT_COLS

    type_id: torch.Tensor  # int32
    bodypart_id: torch.Tensor  # int32
    period_id: torch.Tensor  # int32
    is_home: torch.Tensor  # bool
    time_seconds: torch.Tensor  # float
    x: torch.Tensor  # float
    y: torch.Tensor  # float
    dx: torch.Tensor  # float
    dy: torch.Tensor  # float
    mask: torch.Tensor  # bool (G, A)
    n_actions: torch.Tensor  # int32 (G,)
    game_id: torch.Tensor  # int32 (G,)
    row_index: torch.Tensor  # int32 (G, A), -1 on padding


def _from_numpy(
    cols: Dict[str, np.ndarray], device: torch.device, cls: Any = ActionBatch
) -> Any:
    return cls(
        **{n: torch.from_numpy(np.ascontiguousarray(a)).to(device) for n, a in cols.items()}
    )


def _pack_frame(
    actions: 'pd.DataFrame',
    home_team_ids: Optional[Dict[Any, Any]],
    home_team_id: Optional[Any],
    max_actions: Optional[int],
    float_dtype: Any,
    device: DeviceLike,
    float_cols: Tuple[str, ...],
    int_cols: Tuple[str, ...],
    cls: Any,
    as_numpy: bool = False,
) -> Tuple[Any, List[Any]]:
    """The packing shared by both action languages: group the frame by
    game, left-align, pad, and build a ``cls`` batch from ``float_cols``,
    ``int_cols`` and the derived fields.

    ``as_numpy=True`` returns a host *staging* batch whose fields are
    numpy arrays, with no device copy: the streaming feed ships it over
    the minimal wire itself, and the packed-cache writer writes it
    straight into its memmaps. Exclusive with ``device``.
    """
    import pandas as pd

    if as_numpy and device is not None:
        raise ValueError('as_numpy and device are mutually exclusive')
    dev = None if as_numpy else resolve_device(device)
    if 'game_id' not in actions.columns:
        raise ValueError('actions frame must contain a game_id column')
    if len(actions) == 0:
        raise ValueError('cannot pack an empty actions frame')

    gi, game_index = pd.factorize(actions['game_id'], sort=False)
    game_ids = list(game_index)
    n_games = len(game_ids)
    pos = actions.groupby(gi, sort=False).cumcount().to_numpy()
    n_actions = np.bincount(gi, minlength=n_games).astype(np.int32)

    if home_team_ids is None:
        if home_team_id is not None:
            home_team_ids = {g: home_team_id for g in game_ids}
        elif 'home_team_id' in actions.columns:
            home_team_ids = (
                actions.groupby('game_id', sort=False)['home_team_id'].first().to_dict()
            )
        else:
            raise ValueError('home_team_ids (or home_team_id) is required')

    longest = int(n_actions.max())
    A = max_actions if max_actions is not None else pad_length(longest)
    if longest > A:
        raise ValueError(f'game of length {longest} exceeds max_actions={A}')

    flat = gi * A + pos  # destination of every source row in a (G, A) grid

    def scatter(values: np.ndarray, dtype: Any, fill: Any = 0) -> np.ndarray:
        out = np.full(n_games * A, fill, dtype=dtype)
        out[flat] = values
        return out.reshape(n_games, A)

    cols = {
        c: scatter(actions[c].to_numpy(dtype=float_dtype), float_dtype)
        for c in float_cols
    }
    cols.update(
        {
            c: scatter(actions[c].to_numpy(dtype=np.int64).astype(np.int32), np.int32)
            for c in int_cols
        }
    )
    home_of_game = np.asarray([home_team_ids[g] for g in game_ids])
    cols['is_home'] = scatter(
        actions['team_id'].to_numpy() == home_of_game[gi], bool, False
    )
    cols['mask'] = scatter(np.ones(len(actions), dtype=bool), bool, False)
    cols['n_actions'] = n_actions
    cols['game_id'] = np.arange(n_games, dtype=np.int32)
    cols['row_index'] = scatter(np.arange(len(actions), dtype=np.int32), np.int32, -1)
    if as_numpy:
        return cls(**cols), game_ids
    return _from_numpy(cols, dev, cls), game_ids


def pack_actions(
    actions: 'pd.DataFrame',
    home_team_ids: Optional[Dict[Any, Any]] = None,
    *,
    home_team_id: Optional[Any] = None,
    max_actions: Optional[int] = None,
    float_dtype: Any = np.float32,
    device: DeviceLike = None,
    as_numpy: bool = False,
) -> Tuple[ActionBatch, List[Any]]:
    """Pack a SPADL DataFrame (one or many games) into an :class:`ActionBatch`.

    Same contract as the JAX package's ``pack_actions``: games keep their
    order of first appearance, rows their order within the game; pass
    ``home_team_ids`` (``game_id -> home_team_id``), a single
    ``home_team_id``, or a frame with a ``home_team_id`` column. Returns the
    batch (on ``device``, default ``cuda``) and the game ids in game-axis
    order. ``as_numpy=True`` returns a host staging batch of numpy arrays
    instead (no device copy; exclusive with ``device``).
    """
    return _pack_frame(
        actions, home_team_ids, home_team_id, max_actions, float_dtype, device,
        _FLOAT_COLS, _INT_COLS, ActionBatch, as_numpy,
    )


def pack_atomic_actions(
    actions: 'pd.DataFrame',
    home_team_ids: Optional[Dict[Any, Any]] = None,
    *,
    home_team_id: Optional[Any] = None,
    max_actions: Optional[int] = None,
    float_dtype: Any = np.float32,
    device: DeviceLike = None,
    as_numpy: bool = False,
) -> Tuple[AtomicActionBatch, List[Any]]:
    """Pack an Atomic-SPADL DataFrame into an :class:`AtomicActionBatch`:
    :func:`pack_actions`'s contract for frames with ``x, y, dx, dy`` and no
    result column."""
    return _pack_frame(
        actions, home_team_ids, home_team_id, max_actions, float_dtype, device,
        _ATOMIC_FLOAT_COLS, _ATOMIC_INT_COLS, AtomicActionBatch, as_numpy,
    )


def bucket_games(n: int) -> int:
    """Round a game count up to its shape bucket (the next power of two)."""
    if n < 1:
        raise ValueError(f'need at least one game, got {n}')
    return 1 << (n - 1).bit_length()


def bucket_ladder(max_games: int) -> Tuple[int, ...]:
    """The full bucket ladder up to ``max_games``: ``(1, 2, 4, ..., B)``.

    ``max_games`` itself is rounded up to a bucket, so the top rung always
    admits a full batch.
    """
    top = bucket_games(max_games)
    return tuple(1 << i for i in range(top.bit_length()))


def pad_batch_games(batch: Any, n_games: int) -> Any:
    """Pad a batch's game axis to ``n_games`` with masked padding games.

    Works on either batch class and returns the batch's own class.
    Padding games carry all-False masks, ``n_actions == 0`` and
    ``row_index == -1``; their computed values are garbage by contract and
    must be sliced away by the caller.
    """
    G = batch.n_games
    if n_games == G:
        return batch
    if n_games < G:
        raise ValueError(f'cannot pad {G} games down to {n_games}')

    def pad(name: str, a: torch.Tensor) -> torch.Tensor:
        fill = -1 if name == 'row_index' else 0
        tail = a.new_full((n_games - G, *a.shape[1:]), fill)
        return torch.cat([a, tail])

    return type(batch)(**{n: pad(n, t) for n, t in batch.fields().items()})


def pack_row_values(values: Any, batch: Any, *, fill: Any = 0) -> np.ndarray:
    """Scatter per-row values into a batch's ``(G, A)`` layout, as numpy.

    The inverse of :func:`unpack_values`: ``values`` has one entry per
    valid action, in the positional row order of the packed frame, and
    comes back as a ``(G, A)`` host array with ``fill`` in every padding
    slot (grouped xT uses ``-1``, the "in no group" id every kernel drops).
    The layout is read from ``batch.row_index``.
    """
    vals = np.asarray(values)
    ri = batch.row_index.cpu().numpy()
    valid = ri >= 0
    if vals.shape[:1] != (int(valid.sum()),):
        raise ValueError(
            f'got {vals.shape[0]} values for a batch of {int(valid.sum())} '
            'valid actions'
        )
    out = np.full(ri.shape, fill, dtype=vals.dtype)
    out[valid] = vals[ri[valid]]
    return out


def unpack_values(values: torch.Tensor, batch: Any) -> np.ndarray:
    """Per-action output in the packed frame's row order, as numpy.

    Padding rows are dropped and valid rows scattered back to the
    positional order of the DataFrame that was packed. ``values`` has
    shape ``(G, A)`` or ``(G, A, F)``.
    """
    arr = values.detach().cpu().numpy()
    mask = batch.mask.cpu().numpy()
    rows = batch.row_index.cpu().numpy()[mask]
    picked = arr[mask]
    out = np.empty_like(picked)
    out[rows] = picked
    return out
