"""Probability heads and their learners."""

from .mlp import MLP, AdamState, MLPClassifier

__all__ = ['AdamState', 'MLP', 'MLPClassifier']
