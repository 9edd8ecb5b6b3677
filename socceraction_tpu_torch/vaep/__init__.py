"""VAEP: training and serving.

Exports the JAX package's ``vaep`` names less its DataFrame layer
(``features``, ``labels``, ``formula``, ``xfns_default``: ROADMAP A8).
``load_model`` is importable from here too, as from ``vaep.base``.
"""

from .base import VAEP, NotFittedError, load_model  # noqa: F401

__all__ = ['VAEP', 'NotFittedError']
