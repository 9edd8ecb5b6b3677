"""The streaming feed on the card: copies on a side stream, handed over safely.

Every test here needs a CUDA card and skips without one; the machine with
the card has no JAX, pandas or pyarrow, so this file imports none of them
and runs without the suite's conftest:

    python -m pytest tests/test_torch_feed_card.py -m gpu --noconftest -q

A packed cache is written from arrays (a stand-in store over an empty
directory) and streamed two chunks ahead while the consumer's stream is
kept busy: a spin kernel runs before every check, the consumer drops each
batch before its checks have run, and it allocates and frees in a loop.
Without the consumer's wait on each batch's ``ready`` event the checks
could read a chunk before its copies landed; without ``record_stream``
the next chunk's copies could overwrite a dropped chunk's memory while
the checks still read it. Every chunk is held bitwise, on the card, to
the batch built directly from the same arrays.
"""

import os

import numpy as np
import pytest
import torch

from socceraction_tpu_torch.core.batch import ActionBatch
from socceraction_tpu_torch.core.synthetic import synthetic_batch
from socceraction_tpu_torch.pipeline.feed import iter_batches
from socceraction_tpu_torch.pipeline.packed import PackedSeasonWriter, copy_stream

GAMES, ACTIONS, CHUNK = 96, 1664, 16


@pytest.fixture
def cuda():
    """The card, or a skip where there is none (decided per test, not at
    import, so every worker collects the same tests)."""
    if not torch.cuda.is_available():
        pytest.skip('needs a CUDA card')
    return torch.device('cuda', torch.cuda.current_device())


class _Store:
    """What a packed cache needs of a store: a path and the game listing."""

    def __init__(self, path):
        os.makedirs(path)
        self.path = path

    def game_ids(self):
        return list(range(GAMES))

    def home_team_ids(self):
        return {g: 0 for g in range(GAMES)}


def _ragged_draw():
    """A seeded draw with game lengths between 1000 and 1664, padding
    zeroed as the packer leaves it, and chunk-local ids."""
    batch = synthetic_batch(GAMES, ACTIONS, seed=9, device='cpu')
    lengths = np.random.default_rng(9).integers(1000, ACTIONS + 1, size=GAMES)
    mask = np.arange(ACTIONS)[None, :] < lengths[:, None]
    fields = {}
    for name, t in batch.fields().items():
        a = t.numpy().copy()
        if a.ndim == 2:
            a[~mask] = 0
        fields[name] = a
    fields['mask'] = mask
    fields['n_actions'] = lengths.astype(np.int32)
    return fields


def _direct(fields, lo, hi):
    """Games lo:hi as the packer makes them (chunk-local row and game ids)."""
    f = {n: a[lo:hi] for n, a in fields.items()}
    row_index = np.full(f['mask'].shape, -1, dtype=np.int32)
    row_index[f['mask']] = np.arange(int(f['mask'].sum()), dtype=np.int32)
    f['row_index'] = row_index
    f['game_id'] = np.arange(hi - lo, dtype=np.int32)
    return ActionBatch(**{n: torch.from_numpy(np.ascontiguousarray(a)) for n, a in f.items()})


@pytest.fixture
def cache(tmp_path):
    fields = _ragged_draw()
    store = _Store(str(tmp_path / 'store'))
    writer = PackedSeasonWriter(store, max_actions=ACTIONS, cache_dir=str(tmp_path / 'cache'))
    directs = [_direct(fields, lo, lo + CHUNK) for lo in range(0, GAMES, CHUNK)]
    for lo, d in zip(range(0, GAMES, CHUNK), directs):
        writer.write_chunk(lo, d)
    writer.finalize()
    return store, str(tmp_path / 'cache'), directs


@pytest.mark.gpu
@pytest.mark.parametrize('prefetch', [2, 0])
def test_streamed_chunks_survive_a_busy_consumer(cuda, cache, prefetch):
    """Every chunk bitwise to its direct batch, with the checks queued
    behind a spin kernel on the consumer's stream and the batch dropped
    before they run; the copies ran on the copy stream, not the
    consumer's."""
    store, cache_dir, directs = cache
    consumer = torch.cuda.current_stream(cuda)
    checks, n = [], 0
    for (batch, ids), direct in zip(
        iter_batches(store, CHUNK, max_actions=ACTIONS, packed_cache=cache_dir,
                     prefetch=prefetch, device=cuda),
        directs,
    ):
        assert batch.ready is not None and batch.device == cuda
        want = direct.to(cuda)
        torch.cuda._sleep(20_000_000)  # some milliseconds of spinning
        for name, a in batch.fields().items():
            b = getattr(want, name)
            assert a.dtype == b.dtype and a.shape == b.shape, name
            checks.append((n, name, (a == b).all()))
        del batch, a, want
        for _ in range(8):  # the consumer allocates and frees meanwhile
            scratch = torch.empty(CHUNK * ACTIONS * 25, dtype=torch.uint8, device=cuda)
            scratch.fill_(0xA5)
            del scratch
        n += 1
    assert n == len(directs)
    assert torch.cuda.current_stream(cuda) == consumer
    torch.cuda.synchronize(cuda)
    bad = [(i, name) for i, name, ok in checks if not bool(ok)]
    assert not bad, f'chunks differ from their direct batches: {bad}'


@pytest.mark.gpu
def test_the_copy_stream_is_not_the_consumers(cuda):
    """The dedicated copy stream is one per card and never the default."""
    s = copy_stream(cuda)
    assert s is copy_stream(cuda)
    assert s != torch.cuda.default_stream(cuda)
