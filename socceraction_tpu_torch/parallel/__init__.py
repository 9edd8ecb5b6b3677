"""Scale-out over several devices (port of ``socceraction_tpu.parallel``).

The JAX package shards under one controller with ``jax.sharding`` and
``shard_map``; the port runs one process per device over
``torch.distributed`` (NCCL on the card, gloo on the CPU), joined by
:func:`~socceraction_tpu_torch.utils.env.init_distributed` and meshed by
:func:`make_mesh`, with the JAX package's axis names:

- the **game axis** of a batch is the data-parallel axis (``'games'``):
  each rank takes its shard of the same global batch;
- xT training sums its per-shard counts, and every matrix-free sweep's
  payoff, with one all-reduce (:mod:`.xt`; kernel B2 under each rank's
  counts and sweeps);
- VAEP training is data-parallel over games and optionally
  tensor-parallel over the heads' hidden widths (``'model'``), with the
  collectives written out (:mod:`.vaep`; kernel B1 in every step);
- for streams too long for one device the **action axis** splits over a
  ``('games', 'seq')`` mesh with halo exchange (:mod:`.sequence`);
- serving fans out over replica lanes in one process, with no
  collective (:mod:`.serve`).
"""

from .mesh import (
    batch_sharding,
    make_mesh,
    make_replica_mesh,
    pad_games,
    replicated,
    shard_batch,
)
from .xt import sharded_xt_counts, sharded_xt_fit, sharded_xt_fit_matrix_free
from .vaep import (
    data_parallel_rate,
    make_train_step,
    sharded_rate,
    train_distributed,
)
from .serve import ReplicaDispatcher
from .sequence import (
    make_sequence_mesh,
    sequence_features,
    sequence_labels,
    sequence_rate,
    sequence_values,
    shard_batch_seq,
)

__all__ = [
    'make_mesh',
    'make_replica_mesh',
    'batch_sharding',
    'pad_games',
    'replicated',
    'shard_batch',
    'sharded_xt_counts',
    'sharded_xt_fit',
    'sharded_xt_fit_matrix_free',
    'data_parallel_rate',
    'make_train_step',
    'sharded_rate',
    'train_distributed',
    'ReplicaDispatcher',
    'make_sequence_mesh',
    'shard_batch_seq',
    'sequence_features',
    'sequence_labels',
    'sequence_rate',
    'sequence_values',
]
