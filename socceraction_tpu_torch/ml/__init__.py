"""Probability heads and their learners."""

from .learners import LEARNERS
from .mlp import MLP, AdamState, MLPClassifier

__all__ = ['AdamState', 'LEARNERS', 'MLP', 'MLPClassifier']
