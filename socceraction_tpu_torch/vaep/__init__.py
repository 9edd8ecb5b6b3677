"""VAEP: training, serving and the DataFrame layer.

Exports the JAX package's ``vaep`` names. ``load_model`` is importable
from here too, as from ``vaep.base``.
"""

from . import features, formula, labels  # noqa: F401
from .base import VAEP, NotFittedError, load_model, xfns_default  # noqa: F401

__all__ = [
    'VAEP',
    'NotFittedError',
    'xfns_default',
    'features',
    'labels',
    'formula',
]
