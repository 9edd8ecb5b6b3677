"""The collectives of the scale-out layer, over one process group.

The JAX package writes its collectives as ``psum``, ``ppermute`` and
``all_gather`` over a named mesh axis inside ``shard_map``. Here each is
a ``torch.distributed`` call over the group of one axis of a
:class:`~torch.distributed.device_mesh.DeviceMesh`
(``mesh.get_group(name)``):

- ``psum`` is :func:`all_reduce_sum` (several tensors of one dtype ride
  one flat buffer);
- ``all_gather`` is :func:`all_gather`, stacked on a new leading axis in
  group order;
- ``ppermute``'s neighbour shift is :func:`shift_to_next` /
  :func:`shift_to_previous`, point-to-point sends through
  ``batch_isend_irecv``.

``group=None`` and a group of one rank reduce nothing and move nothing, so
a single-process caller runs exactly the arithmetic of the unsharded path.
NCCL moves card tensors directly. Under gloo a card tensor is staged
through host memory (gloo sends host buffers, and two ranks that share
one card must use gloo: NCCL refuses them); the values are unchanged, so
every rank still ends a collective holding the same bits.
"""

from __future__ import annotations

from typing import Any, List, Optional, Sequence

import torch
import torch.distributed as dist

__all__ = [
    'all_gather',
    'all_reduce_sum',
    'group_rank',
    'group_size',
    'shift_to_next',
    'shift_to_previous',
]

Group = Optional[Any]


def group_size(group: Group) -> int:
    """Ranks in ``group`` (1 for ``None``)."""
    return 1 if group is None else dist.get_world_size(group)


def group_rank(group: Group) -> int:
    """This process's index in ``group`` (0 for ``None``)."""
    return 0 if group is None else dist.get_rank(group)


def _staged(t: torch.Tensor, group: Group) -> bool:
    return t.device.type != 'cpu' and dist.get_backend(group) == 'gloo'


def all_reduce_sum(tensors: Sequence[torch.Tensor], group: Group) -> List[torch.Tensor]:
    """Each tensor summed over ``group`` (new tensors; one collective).

    The tensors must share a dtype and a device; they travel as one flat
    buffer. With one rank they come back as they are.
    """
    tensors = list(tensors)
    if group_size(group) == 1 or not tensors:
        return tensors
    flat = torch.cat([t.reshape(-1) for t in tensors])
    staged = _staged(flat, group)
    buf = flat.cpu() if staged else flat
    dist.all_reduce(buf, op=dist.ReduceOp.SUM, group=group)
    if staged:
        buf = buf.to(flat.device)
    out, off = [], 0
    for t in tensors:
        out.append(buf[off : off + t.numel()].reshape(t.shape))
        off += t.numel()
    return out


def all_gather(t: torch.Tensor, group: Group) -> torch.Tensor:
    """``(group size, *t.shape)``: every rank's ``t``, in group order."""
    n = group_size(group)
    if n == 1:
        return t[None]
    staged = _staged(t, group)
    src = (t.cpu() if staged else t).contiguous()
    parts = [torch.empty_like(src) for _ in range(n)]
    dist.all_gather(parts, src, group=group)
    out = torch.stack(parts)
    return out.to(t.device) if staged else out


def _shift(t: torch.Tensor, group: Group, step: int) -> torch.Tensor:
    """Send ``t`` to the rank ``step`` places on in ``group`` and receive
    from the rank ``step`` places back; the end that has no sender gets
    ``t`` itself back (its caller replaces it with its edge fill)."""
    n = group_size(group)
    if n == 1:
        return t
    i = group_rank(group)
    staged = _staged(t, group)
    # bytes, not values: every dtype (bool included) crosses unchanged
    src = (t.cpu() if staged else t).contiguous()
    wire = src.view(torch.uint8) if src.dtype != torch.bool else src.to(torch.uint8)
    recv = torch.empty_like(wire)
    ops = []
    if 0 <= i + step < n:
        ops.append(dist.P2POp(dist.isend, wire, dist.get_global_rank(group, i + step), group=group))
    if 0 <= i - step < n:
        ops.append(dist.P2POp(dist.irecv, recv, dist.get_global_rank(group, i - step), group=group))
    for req in dist.batch_isend_irecv(ops):
        req.wait()
    if not 0 <= i - step < n:
        return t
    got = recv.view(src.dtype) if src.dtype != torch.bool else recv.to(torch.bool)
    return got.to(t.device) if staged else got


def shift_to_next(t: torch.Tensor, group: Group) -> torch.Tensor:
    """``ppermute`` by one: rank ``i`` receives rank ``i - 1``'s ``t``
    (rank 0 gets its own ``t`` back)."""
    return _shift(t, group, 1)


def shift_to_previous(t: torch.Tensor, group: Group) -> torch.Tensor:
    """``ppermute`` by minus one: rank ``i`` receives rank ``i + 1``'s ``t``
    (the last rank gets its own ``t`` back)."""
    return _shift(t, group, -1)
