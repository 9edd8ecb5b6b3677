"""The PyTorch port's packed batches against the JAX package's.

Same frames and seeds go through both packages; every field must be
element-wise equal (same dtype, same values), because every kernel
downstream reads these fields.
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pandas as pd
import pytest
import torch

from socceraction_tpu.core import batch as jbatch
from socceraction_tpu.core.synthetic import synthetic_batch as jax_synthetic_batch
from socceraction_tpu_torch.core import batch as tbatch
from socceraction_tpu_torch.core.synthetic import synthetic_batch

FIELDS = [f.name for f in dataclasses.fields(tbatch.ActionBatch)]


def assert_batches_equal(jb, tb):
    assert FIELDS == [f.name for f in dataclasses.fields(jbatch.ActionBatch)]
    for name in FIELDS:
        j = np.asarray(getattr(jb, name))
        t = getattr(tb, name).numpy()
        assert t.dtype == j.dtype, name
        np.testing.assert_array_equal(t, j, err_msg=name)


def test_pack_actions_golden_game(spadl_actions):
    jb, jids = jbatch.pack_actions(spadl_actions, home_team_id=782)
    tb, tids = tbatch.pack_actions(spadl_actions, home_team_id=782, device='cpu')
    assert tids == jids
    assert_batches_equal(jb, tb)
    assert tb.total_actions == len(spadl_actions)


def _two_interleaved_games(spadl_actions):
    a = spadl_actions.assign(game_id=1)
    b = spadl_actions.iloc[:150].assign(game_id=2)
    frame = pd.concat([a, b], ignore_index=True)
    # alternate the two games' rows, each game keeping its own order
    pos = frame.groupby('game_id').cumcount()
    return frame.iloc[np.lexsort((frame['game_id'].to_numpy(), pos.to_numpy()))]


@pytest.mark.parametrize('max_actions', [None, 384])
def test_pack_actions_interleaved_games(spadl_actions, max_actions):
    frame = _two_interleaved_games(spadl_actions)
    homes = {1: 782, 2: 768}
    jb, jids = jbatch.pack_actions(frame, homes, max_actions=max_actions)
    tb, tids = tbatch.pack_actions(frame, homes, max_actions=max_actions, device='cpu')
    assert tids == jids
    assert_batches_equal(jb, tb)


def test_pack_actions_rejects_overlong_game(spadl_actions):
    with pytest.raises(ValueError, match='exceeds max_actions'):
        tbatch.pack_actions(spadl_actions, home_team_id=782, max_actions=128, device='cpu')


@pytest.mark.parametrize('fill', [1.0, 0.55])
@pytest.mark.parametrize('seed', [0, 7])
def test_synthetic_batch_bitwise(seed, fill):
    jb = jax_synthetic_batch(3, 256, fill=fill, seed=seed)
    tb = synthetic_batch(3, 256, fill=fill, seed=seed, device='cpu')
    assert_batches_equal(jb, tb)


@pytest.mark.parametrize('n', [1, 2, 3, 5, 8, 9, 100, 512])
def test_bucket_games_matches(n):
    assert tbatch.bucket_games(n) == jbatch.bucket_games(n)


def test_bucket_games_rejects_zero():
    with pytest.raises(ValueError):
        tbatch.bucket_games(0)


@pytest.mark.parametrize('n', [1, 127, 128, 129, 1664])
def test_pad_length_matches(n):
    assert tbatch.pad_length(n) == jbatch.pad_length(n)


@pytest.mark.parametrize('target', [3, 4, 8])
def test_pad_batch_games_matches(target):
    jb = jbatch.pad_batch_games(jax_synthetic_batch(3, 128, fill=0.5, seed=2), target)
    tb = tbatch.pad_batch_games(
        synthetic_batch(3, 128, fill=0.5, seed=2, device='cpu'), target
    )
    assert_batches_equal(jb, tb)


def test_pad_batch_games_rejects_shrinking():
    with pytest.raises(ValueError):
        tbatch.pad_batch_games(synthetic_batch(3, 128, device='cpu'), 2)


@pytest.mark.parametrize('trailing', [(), (3,)])
def test_unpack_values_matches(spadl_actions, trailing):
    frame = _two_interleaved_games(spadl_actions)
    homes = {1: 782, 2: 768}
    jb, _ = jbatch.pack_actions(frame, homes)
    tb, _ = tbatch.pack_actions(frame, homes, device='cpu')
    vals = np.random.default_rng(3).normal(
        size=(tb.n_games, tb.max_actions, *trailing)
    ).astype(np.float32)
    got = tbatch.unpack_values(torch.from_numpy(vals), tb)
    want = jbatch.unpack_values(jnp.asarray(vals), jb)
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize('target', [3, 4, 8])
def test_pad_batch_games_pads_host_staging_batches(spadl_actions, target):
    """A host staging batch (numpy fields, ``as_numpy=True``) pads to the
    same numpy fields as the JAX package's, keeping its host count: the
    rating service pads every flush so, before anything reaches a device
    (a repair: the port padded tensors only)."""
    frame = _two_interleaved_games(spadl_actions)
    homes = {1: 782, 2: 768}
    jb, _ = jbatch.pack_actions(frame, homes, max_actions=len(spadl_actions), as_numpy=True)
    tb, _ = tbatch.pack_actions(frame, homes, max_actions=len(spadl_actions), as_numpy=True)
    jp, tp = jbatch.pad_batch_games(jb, target), tbatch.pad_batch_games(tb, target)
    for name in FIELDS:
        got, want = getattr(tp, name), getattr(jp, name)
        assert isinstance(got, np.ndarray) and got.dtype == want.dtype, name
        np.testing.assert_array_equal(got, want, err_msg=name)
    assert tp.total_actions == tb.total_actions == len(frame)


@pytest.mark.parametrize('trailing', [(), (3,)])
def test_unpack_values_reads_host_arrays(spadl_actions, trailing):
    """numpy values against a host staging batch, as the rating service
    unpacks a flush (a repair: the port took tensors only)."""
    frame = _two_interleaved_games(spadl_actions)
    homes = {1: 782, 2: 768}
    jb, _ = jbatch.pack_actions(frame, homes, as_numpy=True)
    tb, _ = tbatch.pack_actions(frame, homes, as_numpy=True)
    vals = np.random.default_rng(4).normal(
        size=(tb.n_games, tb.max_actions, *trailing)
    ).astype(np.float32)
    want = jbatch.unpack_values(vals, jb)
    np.testing.assert_array_equal(tbatch.unpack_values(vals, tb), want)
    np.testing.assert_array_equal(tbatch.unpack_values(torch.from_numpy(vals), tb), want)


def test_batch_to_keeps_fields():
    tb = synthetic_batch(2, 128, seed=4, device='cpu')
    moved = tb.to('cpu')
    for name in FIELDS:
        assert getattr(moved, name).device.type == 'cpu'
        np.testing.assert_array_equal(getattr(moved, name).numpy(), getattr(tb, name).numpy())
