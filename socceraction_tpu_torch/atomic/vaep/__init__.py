"""Atomic-VAEP: VAEP over Atomic-SPADL actions."""

from .base import XFNS_DEFAULT, AtomicVAEP

__all__ = ['AtomicVAEP', 'XFNS_DEFAULT']
