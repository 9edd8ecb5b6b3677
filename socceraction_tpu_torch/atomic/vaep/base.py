"""The Atomic-VAEP model class.

Port of ``socceraction_tpu/atomic/vaep/base.py``: a
:class:`~socceraction_tpu_torch.vaep.base.VAEP` whose feature family
handles are the atomic ones (:mod:`~socceraction_tpu_torch.ops.atomic`
kernels, labels and formula, the ``'atomic'`` fused layout, the
:class:`~socceraction_tpu_torch.core.batch.AtomicActionBatch` and its
packer). Training, serving and checkpoints are the parent's.
"""

from __future__ import annotations

from typing import Tuple

from ...core.batch import AtomicActionBatch, pack_atomic_actions
from ...ops import atomic as atomicops
from ...vaep.base import VAEP

__all__ = ['AtomicVAEP', 'XFNS_DEFAULT']

#: The reference's 12 default atomic feature transformers, by kernel name.
XFNS_DEFAULT: Tuple[str, ...] = (
    'actiontype',
    'actiontype_onehot',
    'bodypart',
    'bodypart_onehot',
    'time',
    'team',
    'time_delta',
    'location',
    'polar',
    'movement_polar',
    'direction',
    'goalscore',
)


class AtomicVAEP(VAEP):
    """VAEP over atomic actions: it values the player who starts an action
    (gives the pass) apart from the one who completes it (receives it).
    The API is :class:`VAEP`'s, on :class:`AtomicActionBatch` inputs."""

    _default_xfns = XFNS_DEFAULT
    _kernels = atomicops.ATOMIC_KERNELS
    _compute_features_kernel = staticmethod(atomicops.compute_features)
    _labels_kernel = staticmethod(atomicops.scores_concedes)
    _formula_kernel = staticmethod(atomicops.vaep_values)
    _fused_registry = 'atomic'
    _batch_class = AtomicActionBatch
    _pack = staticmethod(pack_atomic_actions)
