"""The Atomic-VAEP model class.

Port of ``socceraction_tpu/atomic/vaep/base.py``: a
:class:`~socceraction_tpu_torch.vaep.base.VAEP` whose feature family
handles are the atomic ones (:mod:`~socceraction_tpu_torch.ops.atomic`
kernels, labels and formula, the ``'atomic'`` fused layout, the
:class:`~socceraction_tpu_torch.core.batch.AtomicActionBatch` and its
packer, and the pandas oracle of :mod:`.features`, :mod:`.labels` and
:mod:`.formula`). Training, serving, the DataFrame layer and checkpoints
are the parent's.
"""

from __future__ import annotations

from typing import List, Tuple

from ...core.batch import AtomicActionBatch, pack_atomic_actions
from ...ops import atomic as atomicops
from ...vaep.base import VAEP
from .. import spadl as atomicspadl
from . import features as fs
from . import formula as vaepformula
from . import labels as lab

__all__ = ['AtomicVAEP', 'XFNS_DEFAULT', 'xfns_default']

#: The reference's 12 default atomic feature transformers.
xfns_default: List[fs.FeatureTransfomer] = [
    fs.actiontype,
    fs.actiontype_onehot,
    fs.bodypart,
    fs.bodypart_onehot,
    fs.time,
    fs.team,
    fs.time_delta,
    fs.location,
    fs.polar,
    fs.movement_polar,
    fs.direction,
    fs.goalscore,
]

#: The same transformers by name: the kernels of the device path.
XFNS_DEFAULT: Tuple[str, ...] = tuple(fn.__name__ for fn in xfns_default)


class AtomicVAEP(VAEP):
    """VAEP over atomic actions: it values the player who starts an action
    (gives the pass) apart from the one who completes it (receives it).
    The API is :class:`VAEP`'s, on :class:`AtomicActionBatch` inputs."""

    _default_xfns = XFNS_DEFAULT
    _kernels = atomicops.ATOMIC_KERNELS
    _spadlcfg = atomicspadl
    _fs = fs
    _lab = lab
    _vaep = vaepformula
    _compute_features_kernel = staticmethod(atomicops.compute_features)
    _labels_kernel = staticmethod(atomicops.scores_concedes)
    _formula_kernel = staticmethod(atomicops.vaep_values)
    _fused_registry = 'atomic'
    _batch_class = AtomicActionBatch
    _pack = staticmethod(pack_atomic_actions)
