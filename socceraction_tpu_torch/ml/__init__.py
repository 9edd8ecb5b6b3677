"""Probability heads."""

from .mlp import MLP, MLPClassifier

__all__ = ['MLP', 'MLPClassifier']
