"""Dispatch observatory: per-function signature accounting, kernel builds,
analytic cost and retrace-storm detection.

The counterpart of the JAX package's compile observatory
(``socceraction_tpu/obs/xla.py``). The port compiles nothing through XLA:
what it can count is the first call of each new argument signature of a
hot dispatch (in PyTorch a new shape means new cuBLAS plans, new caching
allocator blocks and, for a CUDA graph or ``torch.compile`` tier, a new
capture) and each ``nvcc`` build of a hand-written kernel
(:mod:`socceraction_tpu_torch.ops.cuda_build`).

- :func:`instrument` wraps a function with signature accounting. Every
  *new* signature (the tree of arguments: tensor leaves by dtype, shape
  and device, Python scalars by type, strings and other leaves by value)
  records into governed ``dispatch/*`` metrics labeled ``fn``:

  | metric | kind (unit) | meaning |
  |---|---|---|
  | ``dispatch/signatures`` | gauge (shapes) | signatures seen per function |
  | ``dispatch/first_call_seconds`` | histogram (s) | host wall of a signature's first call |
  | ``dispatch/cost_flops`` | gauge (flops) | analytic FLOPs of one dispatch |
  | ``dispatch/cost_bytes`` | gauge (bytes) | analytic bytes of one dispatch |
  | ``dispatch/retrace_storm`` | counter (count) | storm-detector trips |
  | ``dispatch/kernel_builds`` | counter (count) | ``nvcc`` builds, labeled ``kernel`` |
  | ``dispatch/build_seconds`` | histogram (s) | seconds of each build, labeled ``kernel`` |

- the cost is analytic (torch has no ``cost_analysis()``): the wrapped
  function's ``cost(*args, **kwargs) -> (flops, bytes)`` works out what
  one dispatch computes and moves from its operands' shapes alone, so
  it never reads the card. It runs at every new signature.
  :func:`fn_cost` hands the latest to the live roofline
  (:mod:`socceraction_tpu_torch.obs.perf`).
- a **retrace-storm detector** with the JAX package's semantics:
  ``storm_threshold`` new signatures within ``storm_window_s`` raises
  ``dispatch/retrace_storm`` and emits a ``retrace_storm`` event (run log
  + flight recorder) naming the :func:`signature_diff`.

:func:`call_key`, :func:`signature_of` and :func:`signature_diff` keep
the JAX package's semantics: a leaf on the default device (the current
card, or the CPU where there is none) carries no device suffix, a leaf
elsewhere ``@cpu`` or ``@d<index>``; a Python scalar keys by type, not
value; dict keys are sorted, as ``jax.tree_util`` sorts them.
"""

from __future__ import annotations

import dataclasses
import functools
import re
import sys
import threading
import time
from collections import deque
from typing import Any, Callable, Dict, Iterator, List, Optional, Tuple

from .metrics import REGISTRY, MetricRegistry

__all__ = [
    'InstrumentedFn',
    'call_key',
    'fn_cost',
    'instrument',
    'observatory_snapshot',
    'record_kernel_build',
    'signature_diff',
    'signature_of',
]

#: process-lifetime per-``fn`` totals behind :func:`observatory_snapshot`
#: (short-lived instances, such as per-fit epoch trainers, add to them at
#: their first calls, so their accounting survives them)
_TOTALS: Dict[str, Dict[str, Any]] = {}
_TOTALS_LOCK = threading.Lock()
_MAX_SIGNATURES_KEPT = 64

_FN_LABEL_OK = re.compile(r'^[a-z][a-z0-9_]*$')


def _bump_totals(
    name: str,
    *,
    compiles: int = 0,
    seconds: float = 0.0,
    storms: int = 0,
    cost: Optional[Tuple[float, float]] = None,
    signature: Optional[str] = None,
) -> None:
    with _TOTALS_LOCK:
        t = _TOTALS.setdefault(
            name,
            {
                'fn': name,
                'compiles': 0,
                'compile_seconds_total': 0.0,
                'retrace_storms': 0,
                'signatures': [],
            },
        )
        t['compiles'] += compiles
        t['compile_seconds_total'] = round(t['compile_seconds_total'] + seconds, 4)
        t['retrace_storms'] += storms
        if cost is not None:
            t['cost_flops'], t['cost_bytes'] = cost
        if signature is not None and len(t['signatures']) < _MAX_SIGNATURES_KEPT:
            t['signatures'].append(signature)


# -- signatures ------------------------------------------------------------------


def _default_device() -> Any:
    """The device a leaf may live on without a suffix: the current card,
    or the CPU where torch sees none."""
    torch = sys.modules.get('torch')
    if torch is not None and torch.cuda.is_available():
        return torch.device('cuda', torch.cuda.current_device())
    return None


def _device_suffix(x: Any, default: Any) -> str:
    device = getattr(x, 'device', None)
    torch = sys.modules.get('torch')
    if torch is None or not isinstance(device, torch.device):
        return ''  # a numpy array is host data, like the JAX package's
    if default is None:
        return '' if device.type == 'cpu' else f'@{device}'
    if device == default:
        return ''
    return '@cpu' if device.type == 'cpu' else f'@d{device.index}'


def _dtype_name(dtype: Any) -> str:
    return str(dtype).replace('torch.', '')


def _flatten(tree: Any, path: str = '') -> Iterator[Tuple[str, Any]]:
    """``(path, leaf)`` pairs of an argument tree, in a stable order.

    Containers: tuples and lists (``[i]``), named tuples and dataclasses
    (``.field``), dicts (``['key']``, keys sorted) and ``nn.Module``\\ s
    (their parameters and buffers, ``.name``). ``None`` has no leaves, as
    in ``jax.tree_util``; everything else is a leaf.
    """
    torch = sys.modules.get('torch')
    if tree is None:
        return
    if torch is not None and isinstance(tree, torch.Tensor):
        yield path, tree
    elif dataclasses.is_dataclass(tree) and not isinstance(tree, type):
        for f in dataclasses.fields(tree):
            yield from _flatten(getattr(tree, f.name), f'{path}.{f.name}')
    elif isinstance(tree, tuple) and hasattr(tree, '_fields'):
        for name in tree._fields:
            yield from _flatten(getattr(tree, name), f'{path}.{name}')
    elif isinstance(tree, (tuple, list)):
        for i, v in enumerate(tree):
            yield from _flatten(v, f'{path}[{i}]')
    elif isinstance(tree, dict):
        for k in sorted(tree, key=repr):
            yield from _flatten(tree[k], f'{path}[{k!r}]')
    elif torch is not None and isinstance(tree, torch.nn.Module):
        for name, t in tree.state_dict(keep_vars=True).items():
            yield f'{path}.{name}', t
    else:
        yield path, tree


def _leaf_key(x: Any, default: Any) -> Any:
    """Hashable cache key of one leaf (no string building)."""
    shape = getattr(x, 'shape', None)
    dtype = getattr(x, 'dtype', None)
    if shape is not None and dtype is not None:
        return (dtype, tuple(shape), _device_suffix(x, default))
    if isinstance(x, (bool, int, float, complex)):
        return type(x)  # a Python scalar: keyed by type, not value
    return repr(x)


def _leaf_desc(x: Any, default: Any) -> str:
    """One leaf of a signature: ``float32[64,1664]`` (plus a device suffix
    off the default device), a scalar *type*, or repr for anything else."""
    shape = getattr(x, 'shape', None)
    dtype = getattr(x, 'dtype', None)
    if shape is not None and dtype is not None:
        desc = f'{_dtype_name(dtype)}[{",".join(str(d) for d in shape)}]'
        return desc + _device_suffix(x, default)
    if isinstance(x, (bool, int, float, complex)):
        return f'py_{type(x).__name__}'
    return repr(x)


def call_key(args: Tuple[Any, ...], kwargs: Dict[str, Any]) -> Any:
    """The hashable signature key of a call (the hot-path form).

    Tensor and array leaves key by ``(dtype, shape, device)``, Python
    scalars by type (value changes do not make a new signature), other
    leaves by ``repr``. Two calls with the same key run the same program
    shape; a key *miss* is the observatory's first-call event. The
    human-readable form (:func:`signature_of`) is built only on a miss.
    """
    default = _default_device()
    return tuple(
        (p, _leaf_key(x, default)) for p, x in _flatten((args, kwargs))
    )


def signature_of(args: Tuple[Any, ...], kwargs: Dict[str, Any]) -> Tuple[Tuple[str, str], ...]:
    """The human-readable signature of a call: ``((arg_path, desc), ...)``.

    Paths read as the JAX package's (``[0][1]``, ``[1]['eps']``,
    ``[0][3].type_id``); descriptions as :func:`_leaf_desc`.
    """
    default = _default_device()
    return tuple((p, _leaf_desc(x, default)) for p, x in _flatten((args, kwargs)))


def signature_diff(
    old: Optional[Tuple[Tuple[str, str], ...]],
    new: Tuple[Tuple[str, str], ...],
) -> Dict[str, Any]:
    """Name what changed between two signatures (the storm event payload).

    Returns ``{'changed': [{'arg', 'was', 'now'}], 'added': [...],
    'removed': [...]}`` — with ``old`` None (the first signature ever)
    everything is added and nothing "churned".
    """
    if old is None:
        return {'changed': [], 'added': [f'{p} = {d}' for p, d in new], 'removed': []}
    old_map = dict(old)
    new_map = dict(new)
    changed = [
        {'arg': p, 'was': old_map[p], 'now': d}
        for p, d in new
        if p in old_map and old_map[p] != d
    ]
    added = [f'{p} = {d}' for p, d in new if p not in old_map]
    removed = [f'{p} = {d}' for p, d in old if p not in new_map]
    return {'changed': changed, 'added': added, 'removed': removed}


# -- the wrapper -----------------------------------------------------------------


class InstrumentedFn:
    """A function wrapper that accounts every new argument signature.

    Calls delegate to the wrapped function; the first call of each new
    signature is timed (host wall, the dispatch is not synced), costed
    and counted. Thread-safe: concurrent first calls of one signature
    record it once.
    """

    def __init__(
        self,
        fn: Callable[..., Any],
        name: str,
        *,
        cost: Any = None,
        storm_threshold: int = 8,
        storm_window_s: float = 60.0,
        registry: Optional[MetricRegistry] = None,
    ) -> None:
        if not _FN_LABEL_OK.match(name):
            raise ValueError(
                f'instrument name {name!r} must be a label-safe function name '
                '([a-z][a-z0-9_]*): it becomes the fn= label of the dispatch/* metrics'
            )
        functools.update_wrapper(self, fn)
        self._fn = fn
        self.name = name
        self._cost = cost or None
        self.storm_threshold = int(storm_threshold)
        self.storm_window_s = float(storm_window_s)
        self._registry = registry if registry is not None else REGISTRY
        self._lock = threading.Lock()
        #: call key -> human-readable signature
        self._signatures: Dict[Any, Tuple[Tuple[str, str], ...]] = {}
        self._last_sig: Optional[Tuple[Tuple[str, str], ...]] = None
        self._recent: 'deque[float]' = deque()
        self.n_storms = 0
        self.compile_seconds_total = 0.0
        self.last_cost: Optional[Tuple[float, float]] = None

    def __call__(self, *args: Any, **kwargs: Any) -> Any:
        key = call_key(args, kwargs)
        if key in self._signatures:
            return self._fn(*args, **kwargs)
        return self._first_call(key, args, kwargs)

    def _first_call(self, key: Any, args: Tuple[Any, ...], kwargs: Dict[str, Any]) -> Any:
        sig = signature_of(args, kwargs)
        with self._lock:
            fresh = key not in self._signatures
            if fresh:
                self._signatures[key] = sig
                prev = self._last_sig
                self._last_sig = sig
                n_sigs = len(self._signatures)
        if not fresh:  # another thread registered it while we waited
            return self._fn(*args, **kwargs)
        cost = None
        if self._cost is not None:
            flops, nbytes = self._cost(*args, **kwargs)
            cost = (float(flops), float(nbytes))
        t0 = time.perf_counter()
        out = self._fn(*args, **kwargs)
        dt = time.perf_counter() - t0

        reg = self._registry
        labels = {'fn': self.name}
        with self._lock:
            self.compile_seconds_total += dt
            if cost is not None:
                self.last_cost = cost
        reg.histogram('dispatch/first_call_seconds', unit='s').observe(dt, **labels)
        reg.gauge('dispatch/signatures', unit='shapes').set(n_sigs, **labels)
        if cost is not None:
            reg.gauge('dispatch/cost_flops', unit='flops').set(cost[0], **labels)
            reg.gauge('dispatch/cost_bytes', unit='bytes').set(cost[1], **labels)
        _bump_totals(
            self.name, compiles=1, seconds=dt, cost=cost,
            signature=' '.join(d for _p, d in sig),
        )
        self._note_first_call(sig, prev, dt, cost)
        return out

    def _note_first_call(
        self, sig: Any, prev: Any, dt: float, cost: Optional[Tuple[float, float]]
    ) -> None:
        """Run-log/recorder events + the rate-over-window storm detector."""
        from .recorder import RECORDER
        from .trace import current_runlog

        event: Dict[str, Any] = {
            'fn': self.name,
            'signature': [f'{p} = {d}' for p, d in sig],
            'first_call_s': dt,
        }
        if cost is not None:
            event['cost_flops'], event['cost_bytes'] = cost
        log = current_runlog()
        if log is not None:
            log.event('first_call', **event)
        RECORDER.record('first_call', **event)

        now = time.monotonic()
        with self._lock:
            self._recent.append(now)
            while self._recent and now - self._recent[0] > self.storm_window_s:
                self._recent.popleft()
            n_recent = len(self._recent)
            storm = n_recent >= self.storm_threshold
            if storm:
                self.n_storms += 1
        if storm:
            self._registry.counter('dispatch/retrace_storm', unit='count').inc(1, fn=self.name)
            _bump_totals(self.name, storms=1)
            storm_event = {
                'fn': self.name,
                'new_signatures_in_window': n_recent,
                'window_s': self.storm_window_s,
                'signature_diff': signature_diff(prev, sig),
            }
            if log is not None:
                log.event('retrace_storm', **storm_event)
            RECORDER.record('retrace_storm', **storm_event)

    # -- introspection -----------------------------------------------------------

    def drain_storm_window(self) -> None:
        """Retire this function's recent first calls from the storm window
        (for a controlled burst of warm-ups); counters, signatures and cost
        books are untouched."""
        with self._lock:
            self._recent.clear()

    @property
    def n_compiles(self) -> int:
        """Distinct signatures dispatched so far (the JAX package's name)."""
        with self._lock:
            return len(self._signatures)

    def signatures(self) -> Tuple[Tuple[Tuple[str, str], ...], ...]:
        """The human-readable signatures seen, in registration order."""
        with self._lock:
            return tuple(self._signatures.values())

    def snapshot(self) -> Dict[str, Any]:
        """One function's observatory entry, in the JAX package's shape."""
        with self._lock:
            sigs = [' '.join(d for _p, d in s) for s in self._signatures.values()]
            storms = self.n_storms
            seconds = self.compile_seconds_total
            last_cost = self.last_cost
        out: Dict[str, Any] = {
            'fn': self.name,
            'compiles': len(sigs),
            'compile_seconds_total': round(seconds, 4),
            'retrace_storms': storms,
            'signatures': sigs,
        }
        if last_cost is not None:
            out['cost_flops'], out['cost_bytes'] = last_cost
        return out

    def __repr__(self) -> str:
        return f'InstrumentedFn({self.name!r}, signatures={self.n_compiles})'


def instrument(
    fn: Optional[Callable[..., Any]] = None,
    name: Optional[str] = None,
    **kwargs: Any,
) -> Any:
    """Wrap ``fn`` with signature accounting (see the module docstring).

    Usable directly (``solve = instrument(_solve, 'solve_xt', cost=...)``)
    or as a configured decorator::

        @functools.partial(instrument, name='pair_probs', cost=_pair_cost)
        def _pair_dispatch(...): ...

    ``cost`` is ``cost(*args, **kwargs) -> (flops, bytes)`` over the
    call's operands (shapes only), or None/False for none.
    ``storm_threshold`` and ``storm_window_s`` tune the storm detector.
    """
    if fn is None:
        return lambda f: instrument(f, name, **kwargs)
    if name is None:
        name = getattr(fn, '__name__', 'fn').strip('_')
    return InstrumentedFn(fn, name, **kwargs)


def record_kernel_build(kernel: str, seconds: float, *, compiled: bool) -> None:
    """Account one load of a hand-written kernel library.

    ``compiled`` says whether ``nvcc`` ran (a library already built on
    disk is only loaded). A build counts into ``dispatch/kernel_builds``
    and ``dispatch/build_seconds`` (labeled ``kernel``); every load lands
    a ``kernel_build`` event in the flight recorder and the run log.
    """
    from .recorder import RECORDER
    from .trace import current_runlog

    if compiled:
        REGISTRY.counter('dispatch/kernel_builds', unit='count').inc(1, kernel=kernel)
        REGISTRY.histogram('dispatch/build_seconds', unit='s').observe(seconds, kernel=kernel)
    event = {'kernel': kernel, 'seconds': seconds, 'compiled': compiled}
    RECORDER.record('kernel_build', **event)
    log = current_runlog()
    if log is not None:
        log.event('kernel_build', **event)


def fn_cost(name: str) -> Optional[Tuple[float, float]]:
    """The last recorded analytic ``(flops, bytes)`` of ``fn``, or None.

    Read from the process-lifetime totals, so it survives the instance
    that recorded it. This is the cost the live roofline divides by
    measured dispatch walls. None until a costed first call of ``name``.
    """
    with _TOTALS_LOCK:
        t = _TOTALS.get(name)
        if t is None or 'cost_flops' not in t:
            return None
        return (t['cost_flops'], t['cost_bytes'])


def observatory_snapshot() -> Dict[str, Any]:
    """Every instrumented function's process-lifetime entry, by ``fn``, in
    the JAX package's shape (``compiles`` counts new signatures,
    ``compile_seconds_total`` their first calls' walls)."""
    with _TOTALS_LOCK:
        return {
            name: dict(t, signatures=list(t['signatures']))
            for name, t in sorted(_TOTALS.items())
        }
