"""VAEP: training and serving."""

from .base import VAEP, load_model

__all__ = ['VAEP', 'load_model']
