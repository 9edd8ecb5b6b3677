"""Online serving: micro-batched, shape-bucketed live rating.

Ports of the JAX package's ``socceraction_tpu/serve`` modules:

- :mod:`.batcher` — the thread-safe micro-batching queue
  (:class:`MicroBatcher`): deadline-bounded coalescing, power-of-two
  shape buckets, bounded-queue admission control (:class:`Overloaded`),
  one flusher thread per lane.
- :mod:`.session` — :class:`MatchSession`, live per-match streaming:
  O(new actions) incremental rating with the whole-match ``goalscore``
  carry injected as a dense override.
- :mod:`.service` — :class:`RatingService`, the in-process front end
  (``rate() -> Future``, ``rate_scenarios``, ``open_session``,
  ``swap_model``, ``rollback_model``, ``health``, ``telemetry``,
  ``warmup``, ``load_aot``) over kernel B1, with SLO admission
  (:class:`SLOShed`), a traffic capture hook, a sampled parity probe, a
  circuit breaker per replica lane that degrades failing flushes but
  never a kernel that cannot run, and replica lanes (``n_replicas``).
- :mod:`.registry` — :class:`ModelRegistry`: versioned checkpoints, warm
  device residency, atomic activation and rollback, the candidate
  lifecycle, the warm tier's ``aot/`` artifacts.
- :mod:`.aot` — the warm tier: the kernel libraries shipped with a
  version, checked against this process's fingerprint and installed.
- :mod:`.frontend` — :class:`ServingFrontend` / :class:`FrontendClient`,
  the unix-socket front door for client processes.
- :mod:`.capture` — :class:`TrafficCapture`, the ring of served traffic.

Names load lazily, on first access (as in the JAX package): importing
this package (for example for :func:`.aot.read_manifest`) needs neither
torch, numpy, pandas nor msgpack.
"""

from typing import Any

__all__ = [
    'DeadlineExceeded',
    'MicroBatcher',
    'Overloaded',
    'ModelRegistry',
    'RatingService',
    'SLOShed',
    'MatchSession',
    'TrafficCapture',
    'ServingFrontend',
    'FrontendClient',
    'FrontendError',
]

#: exported name -> (submodule, attribute) for the lazy loader
_LAZY = {
    'DeadlineExceeded': ('socceraction_tpu_torch.obs.context', 'DeadlineExceeded'),
    'MicroBatcher': ('socceraction_tpu_torch.serve.batcher', 'MicroBatcher'),
    'Overloaded': ('socceraction_tpu_torch.serve.batcher', 'Overloaded'),
    'ModelRegistry': ('socceraction_tpu_torch.serve.registry', 'ModelRegistry'),
    'RatingService': ('socceraction_tpu_torch.serve.service', 'RatingService'),
    'SLOShed': ('socceraction_tpu_torch.serve.service', 'SLOShed'),
    'MatchSession': ('socceraction_tpu_torch.serve.session', 'MatchSession'),
    'TrafficCapture': ('socceraction_tpu_torch.serve.capture', 'TrafficCapture'),
    'ServingFrontend': ('socceraction_tpu_torch.serve.frontend', 'ServingFrontend'),
    'FrontendClient': ('socceraction_tpu_torch.serve.frontend', 'FrontendClient'),
    'FrontendError': ('socceraction_tpu_torch.serve.frontend', 'FrontendError'),
}

_SUBMODULES = {'aot', 'batcher', 'capture', 'frontend', 'registry', 'service', 'session'}


def __getattr__(name: str) -> Any:
    import importlib

    if name in _SUBMODULES:
        return importlib.import_module(f'{__name__}.{name}')
    try:
        module_name, attr = _LAZY[name]
    except KeyError:
        raise AttributeError(f'module {__name__!r} has no attribute {name!r}') from None
    value = getattr(importlib.import_module(module_name), attr)
    globals()[name] = value  # cache: the next access skips the hook
    return value


def __dir__() -> list:
    return sorted(set(globals()) | set(__all__))
