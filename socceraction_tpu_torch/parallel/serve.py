"""Replica fan-out of the fused rating dispatch (port of
``socceraction_tpu/parallel/serve.py``).

One process rates on several devices, with no process group: the JAX tier
has one controller too. The model's serving fold (the prepared combined
tables, dense sub-kernel and bias, in its quantize mode) and both heads'
hidden layers are resolved once, when the dispatcher is built, and
committed to every replica's device; a dispatch ships only the batch.

- **lanes** (:meth:`ReplicaDispatcher.rate_replica`): one padded staging
  batch rated on one replica's device, through the same instrumented pair
  dispatch and formula kernel ``VAEP.rate_batch`` runs, so a lane returns
  bitwise what ``rate_batch(batch, bucket=False)`` returns on that device;
- **gang** (:meth:`ReplicaDispatcher.rate_mesh`): one batch per replica,
  each lane's dispatch issued before any result is read, so the devices
  work at once. Rating is game-local, so no collective crosses the
  replicas.

The tier is policy-free: admission, queues, breakers, swaps and telemetry
belong to the serving layer; this module only answers "rate this batch on
replica ``i`` (or one batch on each) and give me host values".
"""

from __future__ import annotations

import copy
from typing import Any, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from ..ops.fused import PreparedPair, _pair_dispatch
from ..ops.profile import FUSED_PATH_HIDDEN_DTYPES, hidden_dtype_for
from ..ops.quant import QuantizedArray
from .mesh import make_replica_mesh

__all__ = ['ReplicaDispatcher']


def _fold_on(prep: PreparedPair, device: torch.device) -> PreparedPair:
    """The serving fold with every tensor on ``device`` (the same tensors
    where they already live there)."""

    def move(q: QuantizedArray) -> QuantizedArray:
        return QuantizedArray(*(None if t is None else t.to(device) for t in q))

    return prep._replace(tables=move(prep.tables), w_dense=move(prep.w_dense), bias=prep.bias.to(device))


def _goalscore(gs: Optional[Any]) -> Optional[Dict[str, Any]]:
    """A goalscore block as the dense overrides it stands for."""
    return None if gs is None else {'goalscore': gs}


class ReplicaDispatcher:
    """Replicated serving fold, one lane per device, for one fitted model.

    Parameters
    ----------
    model : VAEP
        A fitted model whose heads serve through the fused pair dispatch
        (two MLP heads and a fused rating path). The materialized path has
        no replica tier: it is the breaker's fallback, not the scale-out.
    n_replicas : int
        Lanes, one per device.
    devices : sequence, optional
        The lanes' devices (default: the first ``n_replicas`` cards, or the
        one CPU device for a model on the CPU). Asking for more lanes than
        devices raises; a list may name one device several times.
    """

    def __init__(
        self,
        model: Any,
        n_replicas: int = 1,
        *,
        devices: Optional[Sequence[Any]] = None,
    ) -> None:
        n_replicas = int(n_replicas)
        if n_replicas < 1:
            raise ValueError('n_replicas must be >= 1')
        path = model._rating_path() if model._can_fuse() else 'materialized'
        if path not in FUSED_PATH_HIDDEN_DTYPES:
            raise ValueError(
                'replica fan-out serves the fused dispatch path only; this model '
                f'resolves the {path!r} rating path (materialized serving stays on '
                'one device: it is the breaker fallback, not the scale-out tier)'
            )
        self.model = model
        self.n_replicas = n_replicas
        self.mesh = make_replica_mesh(n_replicas, devices=devices, device_type=model.device.type)
        self.devices: Tuple[torch.device, ...] = self.mesh.devices
        self._hidden_dtype = hidden_dtype_for(path)
        clf_a, clf_b = model._heads()
        prep = model._prepared_pair()
        # resolved once and committed to each lane's device; a lane on the
        # model's own device aliases what the model already holds
        self._lanes: List[Tuple[PreparedPair, Any, Any]] = []
        for d in self.devices:
            mods = [
                m if m.Dense_0.weight.device == d else copy.deepcopy(m).to(d)
                for m in (clf_a.module, clf_b.module)
            ]
            self._lanes.append((_fold_on(prep, d), *mods))

    @torch.no_grad()
    def dispatch(
        self, replica: int, batch: Any, dense_overrides: Optional[Dict[str, Any]] = None
    ) -> torch.Tensor:
        """Lane ``replica``'s dispatch of one padded batch -> ``(G, A, 3)``
        values on the lane's device, not read back: the device-level half
        of :meth:`rate_replica`, on the caller's current stream.

        ``dense_overrides`` maps dense feature names to ``(G, A, width)``
        blocks (the goalscore block, a scenario grid's blocks), moved to the
        lane's device; a serving layer hands the returned values, the batch
        and its blocks to a parity probe before it copies the values back.
        """
        d = self.devices[replica]
        if batch.device != d:
            batch = batch.to(d)
        overrides = {
            name: torch.as_tensor(block, dtype=torch.float32, device=d)
            for name, block in (dense_overrides or {}).items()
        } or None
        prep, mod_a, mod_b = self._lanes[replica]
        model = self.model
        pa, pb = _pair_dispatch(
            prep, mod_a, mod_b, batch, overrides,
            names=tuple(model.xfns), k=model.nb_prev_actions,
            registry_name=model._fused_registry, hidden_dtype=self._hidden_dtype,
        )
        return model._formula_kernel(batch, pa, pb)

    @torch.no_grad()
    def rate_replica(
        self, replica: int, host_batch: Any, gs: Optional[np.ndarray] = None
    ) -> np.ndarray:
        """Rate one padded staging batch on lane ``replica`` -> host
        ``(G, A, 3)`` values, bitwise ``rate_batch(batch, bucket=False)``
        of the same batch on that device. ``gs`` is a ``(G, A, 3)``
        goalscore block that replaces the computed one."""
        return self.dispatch(replica, host_batch, _goalscore(gs)).cpu().numpy()

    @torch.no_grad()
    def rate_mesh(
        self,
        host_batches: Sequence[Any],
        gs_list: Optional[Sequence[Optional[np.ndarray]]] = None,
    ) -> List[np.ndarray]:
        """One dispatch on every lane: ``host_batches[i]`` rated on replica
        ``i``, all issued before any is read back -> one ``(G, A, 3)`` host
        array per batch.

        The batches must share one game count (one bucket rung, as the
        serving ladder pads them). ``gs_list`` gives a goalscore block for
        every lane or for none: an override replaces the computed block,
        so zeros cannot stand for "no override".
        """
        R = self.n_replicas
        if len(host_batches) != R:
            raise ValueError(
                f'{len(host_batches)} flush batches for {R} replicas; '
                'the gang dispatch takes exactly one per replica'
            )
        counts = [b.n_games for b in host_batches]
        if len(set(counts)) != 1:
            raise ValueError(
                'per-replica flush batches must share one bucket rung '
                f'(got game counts {counts}); pad each lane to the common rung first'
            )
        gs: List[Optional[Any]] = [None] * R
        if gs_list is not None and any(g is not None for g in gs_list):
            if any(g is None for g in gs_list):
                raise ValueError(
                    'gang dispatch needs a goalscore block for every replica or for '
                    'none (an override replaces the computed feature; zeros are not '
                    '"no override")'
                )
            gs = list(gs_list)
        values = [self.dispatch(i, b, _goalscore(g)) for i, (b, g) in enumerate(zip(host_batches, gs))]
        return [v.cpu().numpy() for v in values]
