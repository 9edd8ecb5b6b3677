"""Atomic-VAEP: VAEP over Atomic-SPADL actions."""

from . import features, formula, labels  # noqa: F401
from .base import AtomicVAEP

__all__ = ['AtomicVAEP', 'features', 'labels', 'formula']
