"""Device meshes and batch sharding (port of ``socceraction_tpu/parallel/mesh.py``).

PyTorch runs one process per device. A mesh is a
:class:`~torch.distributed.device_mesh.DeviceMesh` over the ranks of the
default process group (:func:`~socceraction_tpu_torch.utils.env.init_distributed`),
with the JAX package's axis names:

- ``'games'``, the data-parallel axis: games are independent for every
  transform, so each rank holds whole games;
- ``'model'``, the optional tensor-parallel axis of the MLP heads' hidden
  widths (:mod:`.vaep`).

The calling contract is the JAX package's multi-process one: every rank
calls an entry point with the same global batch, and the entry point
takes this rank's shard (:func:`shard_batch`). A batch is padded with
inert games up to a multiple of the ``'games'`` axis first.

The serving fan-out (:mod:`.serve`) needs no process group: its
:func:`make_replica_mesh` is a list of devices in one process.
"""

from __future__ import annotations

from typing import Any, NamedTuple, Optional, Sequence, Tuple

import torch

from ..core.batch import pad_batch_games
from ..device import resolve_device

__all__ = [
    'ReplicaMesh',
    'axis_group',
    'axis_index',
    'axis_size',
    'make_mesh',
    'make_replica_mesh',
    'batch_sharding',
    'pad_games',
    'replicated',
    'shard_batch',
]


def make_mesh(
    n_devices: Optional[int] = None,
    model_parallel: int = 1,
    *,
    device_type: str = 'cuda',
) -> Any:
    """A ``(games, model)`` mesh over every rank of the default group.

    ``n_devices`` defaults to the world size and must equal it (a rank
    outside the mesh would hold no shard). ``model_parallel``, the size of
    the ``'model'`` axis, must divide it. ``device_type`` is ``'cuda'``
    (one card per rank) or ``'cpu'``.
    """
    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh

    if not dist.is_initialized():
        raise RuntimeError('no process group: call utils.env.init_distributed() first')
    n = dist.get_world_size()
    if n_devices is not None and n_devices != n:
        raise ValueError(f'n_devices={n_devices} differs from the world size {n}')
    if model_parallel < 1 or n % model_parallel != 0:
        raise ValueError(f'model_parallel={model_parallel} does not divide {n} devices')
    return init_device_mesh(
        device_type, (n // model_parallel, model_parallel), mesh_dim_names=('games', 'model')
    )


class ReplicaMesh(NamedTuple):
    """The 1-D ``('replicas',)`` serving mesh: devices of one process."""

    devices: Tuple[torch.device, ...]

    @property
    def axis_names(self) -> Tuple[str]:
        return ('replicas',)

    @property
    def shape(self) -> dict:
        return {'replicas': len(self.devices)}


def make_replica_mesh(
    n_replicas: Optional[int] = None,
    *,
    devices: Optional[Sequence[Any]] = None,
    device_type: str = 'cuda',
) -> ReplicaMesh:
    """The serving fan-out's mesh: the first ``n_replicas`` devices.

    ``devices`` defaults to every card of this process (one CPU device for
    ``device_type='cpu'``). Asking for more replicas than there are
    devices raises. No process group is involved, and no collective ever
    crosses the axis.
    """
    if devices is None:
        if device_type == 'cuda':
            resolve_device('cuda')  # raises without a card
            devices = [torch.device('cuda', i) for i in range(torch.cuda.device_count())]
        else:
            devices = [torch.device(device_type)]
    devices = [resolve_device(d) for d in devices]
    if n_replicas is not None:
        if len(devices) < n_replicas:
            raise ValueError(
                f'{n_replicas} replicas requested but only {len(devices)} devices are '
                'available (pass devices= to place several lanes on one device)'
            )
        devices = devices[:n_replicas]
    return ReplicaMesh(tuple(devices))


def axis_size(mesh: Any, name: str) -> int:
    """Ranks along mesh axis ``name``."""
    return int(mesh.shape[mesh.mesh_dim_names.index(name)])


def axis_index(mesh: Any, name: str) -> int:
    """This rank's coordinate along mesh axis ``name``."""
    return int(mesh.get_local_rank(name))


def axis_group(mesh: Any, name: str) -> Any:
    """The process group of this rank's line along axis ``name``."""
    return mesh.get_group(name)


def batch_sharding(mesh: Any) -> Tuple[Any, ...]:
    """Placements of per-action ``(G, A)`` tensors: the game axis split
    over ``'games'``, replicated over every other axis."""
    from torch.distributed.tensor import Replicate, Shard

    return tuple(Shard(0) if n == 'games' else Replicate() for n in mesh.mesh_dim_names)


def replicated(mesh: Any) -> Tuple[Any, ...]:
    """Placements of a fully replicated tensor (grids, parameters)."""
    from torch.distributed.tensor import Replicate

    return tuple(Replicate() for _ in mesh.mesh_dim_names)


def pad_games(batch: Any, multiple: int) -> Any:
    """Pad the game axis up to a multiple of ``multiple`` with inert games.

    Padding games carry ``mask`` False, ``n_actions`` 0 and ``row_index``
    -1 (:func:`~socceraction_tpu_torch.core.batch.pad_batch_games`); the
    padded batch keeps the host action count, so asking for it reads
    nothing back from the card.
    """
    G = batch.n_games
    return pad_batch_games(batch, -(-G // multiple) * multiple)


def _take(t: torch.Tensor, dim: int, i: int, n: int) -> torch.Tensor:
    per = t.shape[dim] // n
    return t.narrow(dim, i * per, per).contiguous()


def is_shard(batch: Any, mesh: Any) -> bool:
    """True when ``batch`` is already this rank's shard over ``mesh``."""
    return getattr(batch, '_mesh_shard', None) is mesh


def mark_shard(batch: Any, mesh: Any) -> Any:
    """Mark ``batch`` as this rank's shard over ``mesh``; returns it."""
    object.__setattr__(batch, '_mesh_shard', mesh)
    return batch


def shard_batch(batch: Any, mesh: Any) -> Any:
    """This rank's shard of a global batch, game axis over ``'games'``.

    The game axis is padded with inert games (:func:`pad_games`) to a
    multiple of the ``'games'`` axis, so every rank holds as many games;
    ranks that differ only along other axes hold the same games. Either
    batch class. A shard passed back in is returned as it is.
    """
    if is_shard(batch, mesh):
        return batch
    n, i = axis_size(mesh, 'games'), axis_index(mesh, 'games')
    padded = pad_games(batch, n)
    # a CPU shard counts its own actions; a card shard's count stays
    # unknown until asked (one read of its lengths)
    shard = type(batch)(**{name: _take(t, 0, i, n) for name, t in padded.fields().items()})
    return mark_shard(shard, mesh)


def shard_games(x: torch.Tensor, mesh: Any, fill: Any = 0) -> torch.Tensor:
    """This rank's game rows of a per-game or per-action array ``x`` laid
    out like the global batch: padded with ``fill`` to the multiple
    :func:`shard_batch` pads to, then split over ``'games'``."""
    n, i = axis_size(mesh, 'games'), axis_index(mesh, 'games')
    G = x.shape[0]
    pad = -(-G // n) * n - G
    if pad:
        x = torch.cat([x, x.new_full((pad, *x.shape[1:]), fill)])
    return _take(x, 0, i, n)
