"""Packed action batches."""

from .batch import (
    ActionBatch,
    AtomicActionBatch,
    bucket_games,
    bucket_window,
    pack_actions,
    pack_atomic_actions,
    pack_row_values,
    pad_batch_games,
    pad_length,
    unpack_values,
    window_ladder,
)
from .synthetic import synthetic_batch

__all__ = [
    'ActionBatch',
    'AtomicActionBatch',
    'bucket_games',
    'bucket_window',
    'pack_actions',
    'pack_atomic_actions',
    'pack_row_values',
    'pad_batch_games',
    'pad_length',
    'synthetic_batch',
    'unpack_values',
    'window_ladder',
]
