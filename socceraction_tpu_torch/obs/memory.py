"""Device-memory accounting: allocator gauges, span watermarks, tensor census.

Port of the JAX package's ``socceraction_tpu/obs/memory.py`` onto the
card's caching allocator. A memory creep (a leaked cache, an
accidentally resident feature matrix) is invisible to wall-clock
telemetry until an allocation fails; this module makes device memory an
observable:

- :func:`device_memory_stats` — one card's allocator statistics, under
  the JAX package's keys: ``bytes_in_use`` and ``peak_bytes_in_use``
  (``torch.cuda.memory_stats()``'s ``allocated_bytes.all.current`` and
  ``.peak``, the bytes live tensors hold) and ``bytes_limit`` (the
  card's capacity, ``torch.cuda.mem_get_info``), plus
  ``bytes_reserved``: what the caching allocator has reserved on the card
  (``reserved_bytes.all.current``). Reserved bytes beyond the allocated
  ones are cached free blocks, kept for reuse, not a leak.
- :func:`live_array_census` — the live CUDA tensors, found by walking
  the garbage collector's objects on demand (never on a hot path),
  grouped by ``(dtype, shape)``.

Where there is no card (``torch.cuda.is_available()`` false, or torch
not imported) these functions record nothing: :func:`device_memory_stats`
returns None and the census reports ``{'supported': False}``, as the
JAX package's do off-chip. On a card a failing ``torch.cuda`` call
raises; it never turns into a silent None.

The peak is the allocator's process-wide high-water mark, read and never
reset (``torch.cuda.reset_peak_memory_stats`` would break the peak of an
enclosing span).

Recorded metrics (``mem`` area, labeled ``device=<index>``):

| metric | kind (unit) | meaning |
|---|---|---|
| ``mem/bytes_in_use`` | gauge (bytes) | bytes held by live tensors |
| ``mem/peak_bytes`` | gauge (bytes) | the allocator's high-water mark |
| ``mem/bytes_limit`` | gauge (bytes) | the card's capacity |
| ``mem/reserved_bytes`` | gauge (bytes) | bytes the caching allocator holds |
| ``mem/span_peak_bytes`` | histogram (bytes) | per-span high-water (``Span.memory``), labeled ``span`` |
"""

from __future__ import annotations

import gc
import sys
import threading
import warnings
from typing import Any, Dict, List, Optional

from .metrics import REGISTRY, MetricRegistry

__all__ = [
    'MemorySampler',
    'device_memory_stats',
    'live_array_census',
    'sample_device_memory',
]

#: allocator-stat keys worth exporting, mapped to governed metric names
_STAT_GAUGES = (
    ('bytes_in_use', 'mem/bytes_in_use'),
    ('peak_bytes_in_use', 'mem/peak_bytes'),
    ('bytes_limit', 'mem/bytes_limit'),
    ('bytes_reserved', 'mem/reserved_bytes'),
)


def _cuda() -> Any:
    """``torch.cuda`` when torch is loaded and a card is present, else None."""
    torch = sys.modules.get('torch')
    if torch is None or not torch.cuda.is_available():
        return None
    return torch.cuda


def device_memory_stats(device: Any = None) -> Optional[Dict[str, float]]:
    """One card's allocator statistics, or None where there is no card.

    ``device`` defaults to the current card. Keys: ``bytes_in_use``,
    ``peak_bytes_in_use``, ``bytes_reserved`` and ``bytes_limit`` (see
    the module docstring).
    """
    cuda = _cuda()
    if cuda is None:
        return None
    if device is None:
        device = cuda.current_device()
    stats = cuda.memory_stats(device)
    _free, total = cuda.mem_get_info(device)
    return {
        'bytes_in_use': float(stats.get('allocated_bytes.all.current', 0)),
        'peak_bytes_in_use': float(stats.get('allocated_bytes.all.peak', 0)),
        'bytes_reserved': float(stats.get('reserved_bytes.all.current', 0)),
        'bytes_limit': float(total),
    }


def sample_device_memory(
    registry: Optional[MetricRegistry] = None,
) -> Dict[str, Dict[str, float]]:
    """Record every card's allocator stats as ``mem/*`` gauges.

    Returns ``{device_index: stats}``; ``{}`` (recording nothing) where
    there is no card.
    """
    cuda = _cuda()
    if cuda is None:
        return {}
    reg = registry if registry is not None else REGISTRY
    out: Dict[str, Dict[str, float]] = {}
    for i in range(cuda.device_count()):
        stats = device_memory_stats(i)
        out[str(i)] = stats
        for key, metric in _STAT_GAUGES:
            reg.gauge(metric, unit='bytes').set(stats[key], device=str(i))
    return out


def live_array_census(top: int = 10) -> Dict[str, Any]:
    """The live CUDA tensors, grouped by ``(dtype, shape)``, on demand.

    Walks the garbage collector's objects; each storage counts once
    (views of one storage share its bytes, under the first tensor seen),
    so the total never exceeds the allocator's allocated bytes. Tensors
    no Python object holds (autograd's saved tensors, a CUDA graph's
    pool) are not seen. Returns ``{'supported', 'n_arrays',
    'total_bytes', 'top': [...], 'other'}``: the ``top`` largest groups
    (count, total bytes) and everything past them summarized into one
    ``other`` bucket (``{'groups', 'count', 'total_bytes'}``, None when
    nothing overflowed), so the report stays a fixed size whose totals
    still account for every byte. ``{'supported': False}`` where there
    is no card.
    """
    cuda = _cuda()
    if cuda is None:
        return {'supported': False}
    import torch

    seen = set()
    groups: Dict[Any, List[int]] = {}
    total = 0
    n_arrays = 0
    with warnings.catch_warnings():
        # testing the class of some objects (deprecated aliases) warns
        warnings.simplefilter('ignore')
        tensors = []
        for obj in gc.get_objects():
            try:
                if isinstance(obj, torch.Tensor) and obj.is_cuda:
                    tensors.append(obj)
            except ReferenceError:  # a dead weakref proxy has no class to test
                continue
    for obj in tensors:
        storage = obj.untyped_storage()
        key = (storage.device.index, storage.data_ptr())
        if key in seen:
            continue
        seen.add(key)
        nbytes = storage.nbytes()
        n_arrays += 1
        total += nbytes
        entry = groups.setdefault((str(obj.dtype).replace('torch.', ''), tuple(obj.shape)), [0, 0])
        entry[0] += 1
        entry[1] += nbytes
    ranked = sorted(groups.items(), key=lambda kv: kv[1][1], reverse=True)
    kept = ranked[: max(top, 0)]
    rest = ranked[len(kept):]
    other = None
    if rest:
        other = {
            'groups': len(rest),
            'count': sum(count for _key, (count, _b) in rest),
            'total_bytes': sum(nbytes for _key, (_c, nbytes) in rest),
        }
    return {
        'supported': True,
        'n_arrays': n_arrays,
        'total_bytes': total,
        'top': [
            {
                'dtype': dtype,
                'shape': list(shape),
                'count': count,
                'total_bytes': nbytes,
            }
            for (dtype, shape), (count, nbytes) in kept
        ],
        'other': other,
    }


class MemorySampler:
    """Background thread sampling device memory into the registry.

    Usage::

        with MemorySampler(interval_s=1.0):
            train(...)

    Each tick runs :func:`sample_device_memory`; where there is no card
    the first tick discovers it and the thread exits, so the sampler is
    safe to leave in place on every platform. ``sampler.supported`` is
    None before the first tick, then True/False.
    """

    def __init__(
        self,
        interval_s: float = 1.0,
        *,
        registry: Optional[MetricRegistry] = None,
    ) -> None:
        self.interval_s = float(interval_s)
        self._registry = registry
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None
        self.supported: Optional[bool] = None
        self.samples = 0

    def start(self) -> 'MemorySampler':
        """Start the daemon sampling thread (idempotent)."""
        if self._thread is None:
            self._stop.clear()
            self._thread = threading.Thread(
                target=self._run, name='mem-sampler', daemon=True
            )
            self._thread.start()
        return self

    def _run(self) -> None:
        while not self._stop.is_set():
            out = sample_device_memory(self._registry)
            if self.supported is None:
                self.supported = bool(out)
            if not out:
                return  # no card: nothing will ever change
            self.samples += 1
            self._stop.wait(self.interval_s)

    def stop(self) -> None:
        """Stop and join the sampling thread."""
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=10.0)
            self._thread = None

    def __enter__(self) -> 'MemorySampler':
        return self.start()

    def __exit__(self, *exc: Any) -> None:
        self.stop()
