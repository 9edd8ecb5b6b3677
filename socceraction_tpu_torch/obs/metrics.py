"""Typed, labeled process metrics: Counter / Gauge / Histogram in a registry.

A copy of the JAX package's ``socceraction_tpu/obs/metrics.py`` (stdlib
only; the port keeps its own copy and imports nothing of that package):

- **Typed instruments.** :class:`Counter` (monotone total),
  :class:`Gauge` (sampled level: last/min/max/mean of the samples) and
  :class:`Histogram` (fixed log-spaced buckets, count/sum/min/max, and
  streaming quantile *estimates* interpolated from the bucket counts).
  Every instrument carries a ``unit`` ("s", "chunks", "actions", ...), so
  a dimensionless series can never masquerade as seconds.
- **Low-cardinality labels.** ``histogram('pipeline/stage_seconds',
  unit='s').observe(dt, stage='read')`` keeps one instrument per concept
  and one *series* per label set. A cardinality guard (default 64 series
  per instrument) raises :class:`CardinalityError` before an unbounded
  label (a game id, a path) can flood the registry.
- **A thread-safe process registry.** Get-or-create by name with
  kind/unit conflict detection; ``snapshot()`` returns an immutable
  :class:`RegistrySnapshot` (the typed query API) and ``reset()`` zeroes
  every series in place (bound series held by hot loops stay valid
  across measurement passes).

Naming convention: ``area/stage`` — lowercase segments joined by ``/``
(``pipeline/stage_seconds``, ``scenario/values``), enforced at
registration. Metric names are the JAX package's, so one dashboard reads
both packages.

The module is stdlib only on purpose: a data-prep process records stage
timings without importing torch's CUDA runtime, pandas or the JAX
package.
"""

from __future__ import annotations

import bisect
import contextlib
import math
import re
import threading
import time
from typing import (
    Any,
    Dict,
    Iterator,
    List,
    Mapping,
    NamedTuple,
    Optional,
    Tuple,
)

__all__ = [
    'CardinalityError',
    'Counter',
    'Gauge',
    'Histogram',
    'Instrument',
    'InstrumentSnapshot',
    'MetricRegistry',
    'REGISTRY',
    'RegistrySnapshot',
    'Series',
    'SeriesSnapshot',
    'counter',
    'gauge',
    'histogram',
    'quantile_estimate',
    'timed_labels',
]

#: ``area/stage`` naming convention (at least two lowercase segments).
NAME_RE = re.compile(r'^[a-z][a-z0-9_]*(/[a-z][a-z0-9_]*)+$')
_LABEL_KEY_RE = re.compile(r'^[a-z_][a-z0-9_]*$')

#: Default histogram bounds: log-spaced, four buckets per decade from
#: 1 µs to 1000 (seconds, items, ... — unit-agnostic), plus an implicit
#: +Inf overflow bucket. Fixed bounds keep concurrent observes lock-cheap
#: and make series mergeable across processes.
DEFAULT_BUCKETS: Tuple[float, ...] = tuple(
    10.0 ** (k / 4.0) for k in range(-24, 13)
)

_QUANTILES = (0.5, 0.9, 0.99)


def quantile_estimate(
    bounds: Tuple[float, ...],
    counts: Tuple[int, ...],
    count: int,
    min_value: float,
    max_value: float,
    q: float,
) -> float:
    """Estimate the q-quantile from per-bucket counts.

    ``bounds`` are the finite upper edges, ``counts`` the per-bucket
    (non-cumulative) sample counts with one trailing overflow bucket
    (``len(counts) == len(bounds) + 1``). Log-linear interpolation
    inside the containing bucket, clamped to the observed min/max —
    the single estimator behind :class:`Series` quantiles (and, in the
    JAX package, its cross-process histogram merge, so a merged fleet
    histogram quotes exactly the estimate a single series fed the
    concatenated stream would).
    """
    rank = q * count
    cum = 0
    for i, c in enumerate(counts):
        if not c:
            continue
        if cum + c >= rank:
            if i >= len(bounds):  # overflow bucket
                return max_value
            hi = bounds[i]
            lo = bounds[i - 1] if i else hi / 10.0 ** 0.25
            frac = (rank - cum) / c
            est = 10.0 ** (
                math.log10(max(lo, 1e-300))
                + frac
                * (math.log10(max(hi, 1e-300)) - math.log10(max(lo, 1e-300)))
            )
            return min(max(est, min_value), max_value)
        cum += c
    return max_value


class CardinalityError(ValueError):
    """Raised when an instrument exceeds its distinct-label-set budget."""


class SeriesSnapshot(NamedTuple):
    """Immutable view of one labeled series at snapshot time."""

    labels: Mapping[str, str]
    count: int
    total: float
    min: float  # NaN while count == 0
    max: float  # NaN while count == 0
    last: float  # NaN while count == 0
    #: histogram only: ``((le, cumulative_count), ...)``; None otherwise
    buckets: Optional[Tuple[Tuple[float, int], ...]]
    #: histogram only: ``{'p50': ..., 'p90': ..., 'p99': ...}`` estimates
    quantiles: Optional[Mapping[str, float]]
    #: last exemplar attached to an observation (``{'value', 'ts', ...}``,
    #: e.g. a request id) — the trace-linkage hook; None when never set
    exemplar: Optional[Mapping[str, Any]] = None

    @property
    def mean(self) -> float:
        """Mean of the recorded samples (0.0 while empty)."""
        return self.total / self.count if self.count else 0.0


class InstrumentSnapshot(NamedTuple):
    """Immutable view of one instrument and all its series."""

    name: str
    kind: str  # 'counter' | 'gauge' | 'histogram'
    unit: str
    help: str
    series: Tuple[SeriesSnapshot, ...]

    def series_for(self, **labels: Any) -> Optional[SeriesSnapshot]:
        """The series with exactly these labels, or None."""
        want = {k: str(v) for k, v in labels.items()}
        for s in self.series:
            if dict(s.labels) == want:
                return s
        return None


class RegistrySnapshot(NamedTuple):
    """Immutable view of a whole registry — the typed query API.

    Consumers address series by ``(name, labels)`` instead of scraping a
    flat string-keyed report::

        snap = REGISTRY.snapshot()
        read = snap.series('pipeline/stage_seconds', stage='read')
        total_s = read.total if read else 0.0
        # or, with a default in one step:
        total_s = snap.value('pipeline/stage_seconds', stage='read')
    """

    instruments: Mapping[str, InstrumentSnapshot]

    def get(self, name: str) -> Optional[InstrumentSnapshot]:
        """The named instrument, or None."""
        return self.instruments.get(name)

    def series(self, name: str, **labels: Any) -> Optional[SeriesSnapshot]:
        """The ``(name, labels)`` series, or None."""
        inst = self.instruments.get(name)
        return inst.series_for(**labels) if inst is not None else None

    def value(
        self,
        name: str,
        stat: str = 'total',
        default: float = 0.0,
        **labels: Any,
    ) -> float:
        """One statistic (``count``/``total``/``mean``/``min``/``max``/
        ``last``) of the ``(name, labels)`` series, ``default`` when the
        series is absent or empty."""
        s = self.series(name, **labels)
        if s is None or s.count == 0:
            return default
        return float(getattr(s, stat))


def _label_key(labels: Dict[str, Any]) -> Tuple[Tuple[str, str], ...]:
    out = []
    for k in sorted(labels):
        if not _LABEL_KEY_RE.match(k):
            raise ValueError(f'invalid label key {k!r} (want [a-z_][a-z0-9_]*)')
        out.append((k, str(labels[k])))
    return tuple(out)


class Series:
    """One labeled time series: thread-safe scalar accumulators.

    All kinds share the same accumulator set (count / total / min / max /
    last); histograms add per-bucket counts. A per-series lock keeps
    concurrent updates exact — losing samples under contention would make
    the feed's multi-threaded stage timers quietly undercount.
    """

    __slots__ = (
        '_lock', 'labels', 'count', 'total', 'min', 'max', 'last', '_buckets',
        '_bucket_counts', '_exemplar',
    )

    def __init__(
        self,
        labels: Tuple[Tuple[str, str], ...],
        buckets: Optional[Tuple[float, ...]] = None,
    ) -> None:
        self._lock = threading.Lock()
        self.labels = labels
        self._buckets = buckets
        self._bucket_counts: Optional[List[int]] = (
            [0] * (len(buckets) + 1) if buckets is not None else None
        )
        self._zero()

    def _zero(self) -> None:
        self.count = 0
        self.total = 0.0
        self.min = math.nan
        self.max = math.nan
        self.last = math.nan
        self._exemplar: Optional[Dict[str, Any]] = None
        if self._bucket_counts is not None:
            self._bucket_counts = [0] * len(self._bucket_counts)

    def record(self, value: float) -> None:
        """Record one sample (the kind-agnostic core)."""
        v = float(value)
        with self._lock:
            self.count += 1
            self.total += v
            self.last = v
            if not (self.min <= v):  # NaN-aware first-sample init
                self.min = v
            if not (self.max >= v):
                self.max = v
            if self._bucket_counts is not None:
                self._bucket_counts[bisect.bisect_left(self._buckets, v)] += 1

    # counter / gauge verbs ------------------------------------------------

    def inc(self, n: float = 1.0) -> None:
        """Counter increment; ``n`` must be non-negative."""
        if n < 0:
            raise ValueError(f'counter increment must be >= 0, got {n!r}')
        self.record(n)

    def set(self, value: float) -> None:
        """Gauge sample: the level observed now."""
        self.record(value)

    def observe(
        self, value: float, exemplar: Optional[Mapping[str, Any]] = None
    ) -> None:
        """Histogram verb: record one sample, optionally with an exemplar.

        The exemplar (e.g. ``{'request_id': ...}``) is kept per series,
        last-writer-wins, and surfaces in the typed snapshot — enough to
        jump from an aggregate ("queue_wait p99 spiked") to one concrete
        request id.
        """
        self.record(value)
        if exemplar:
            with self._lock:
                self._exemplar = {
                    'value': float(value), 'ts': time.time(), **exemplar
                }

    # snapshot -------------------------------------------------------------

    def _quantile_locked(self, q: float) -> float:
        """Estimate the q-quantile from the bucket counts (see
        :func:`quantile_estimate` — the shared estimator)."""
        assert self._bucket_counts is not None
        return quantile_estimate(
            self._buckets, tuple(self._bucket_counts), self.count,
            self.min, self.max, q,
        )

    def snapshot(self) -> SeriesSnapshot:
        """Consistent point-in-time view of this series."""
        with self._lock:
            buckets = None
            quantiles = None
            if self._bucket_counts is not None:
                cum = 0
                rows = []
                for le, c in zip(self._buckets, self._bucket_counts):
                    cum += c
                    rows.append((le, cum))
                rows.append((math.inf, cum + self._bucket_counts[-1]))
                buckets = tuple(rows)
                if self.count:
                    quantiles = {
                        f'p{int(q * 100)}': self._quantile_locked(q)
                        for q in _QUANTILES
                    }
            return SeriesSnapshot(
                labels=dict(self.labels),
                count=self.count,
                total=self.total,
                min=self.min,
                max=self.max,
                last=self.last,
                buckets=buckets,
                quantiles=quantiles,
                exemplar=(
                    dict(self._exemplar) if self._exemplar is not None else None
                ),
            )

    def reset(self) -> None:
        """Zero the accumulators in place (the series object stays valid)."""
        with self._lock:
            self._zero()


#: reserved label set that collects samples past the cardinality budget
#: under the ``on_overflow='overflow'`` policy
OVERFLOW_LABELS: Tuple[Tuple[str, str], ...] = (('overflow', 'true'),)


class Instrument:
    """One named metric: a family of :class:`Series` keyed by label set.

    ``on_overflow`` selects what happens past the ``max_series`` budget:
    ``'raise'`` (default) raises :class:`CardinalityError` — right for
    labels that are bounded by construction, where overflow means a bug
    (an id leaked into a label). ``'overflow'`` collapses further label
    sets into one reserved ``{overflow="true"}`` series — right for
    instruments recorded from library hot paths with *user-controlled*
    label values (the xT grid size), where telemetry must degrade, never
    turn a working ``fit()`` into a crash.
    """

    kind = 'instrument'

    def __init__(
        self,
        name: str,
        unit: str,
        help: str = '',
        *,
        max_series: int = 64,
        on_overflow: str = 'raise',
        buckets: Optional[Tuple[float, ...]] = None,
    ) -> None:
        if not NAME_RE.match(name):
            raise ValueError(
                f'metric name {name!r} violates the area/stage convention '
                "(lowercase segments joined by '/', e.g. 'pipeline/read')"
            )
        if on_overflow not in ('raise', 'overflow'):
            raise ValueError(f'unknown on_overflow policy {on_overflow!r}')
        self.name = name
        self.unit = unit
        self.help = help
        self.max_series = max_series
        self.on_overflow = on_overflow
        self._buckets = buckets
        self._lock = threading.Lock()
        self._series: Dict[Tuple[Tuple[str, str], ...], Series] = {}

    def labels(self, **labels: Any) -> Series:
        """The series bound to this label set (created on first use)."""
        key = _label_key(labels)
        series = self._series.get(key)
        if series is None:
            with self._lock:
                series = self._series.get(key)
                if series is None:
                    if (
                        len(self._series) >= self.max_series
                        and key != OVERFLOW_LABELS
                    ):
                        if self.on_overflow == 'raise':
                            raise CardinalityError(
                                f'{self.name}: more than {self.max_series} '
                                f'distinct label sets (offending: '
                                f'{dict(labels)!r}); a label value is '
                                'probably unbounded (an id, a path)'
                            )
                        key = OVERFLOW_LABELS
                        series = self._series.get(key)
                    if series is None:
                        series = self._series[key] = Series(key, self._buckets)
        return series

    def snapshot(self) -> InstrumentSnapshot:
        """Immutable view of this instrument and all its series."""
        with self._lock:
            series = list(self._series.values())
        return InstrumentSnapshot(
            name=self.name,
            kind=self.kind,
            unit=self.unit,
            help=self.help,
            series=tuple(s.snapshot() for s in series),
        )

    def reset(self) -> None:
        """Zero every series in place (bound series stay usable)."""
        with self._lock:
            series = list(self._series.values())
        for s in series:
            s.reset()


class Counter(Instrument):
    """Monotone event count; ``total`` is the counter value."""

    kind = 'counter'

    def inc(self, n: float = 1.0, **labels: Any) -> None:
        """Add ``n`` (>= 0) events to the labeled series."""
        self.labels(**labels).inc(n)


class Gauge(Instrument):
    """Sampled level (queue depth, residual): ``last`` is the current
    value; count/mean/max describe the sample history since reset."""

    kind = 'gauge'

    def set(self, value: float, **labels: Any) -> None:
        """Record the level observed now on the labeled series."""
        self.labels(**labels).set(value)


class Histogram(Instrument):
    """Distribution of samples in fixed log-spaced buckets."""

    kind = 'histogram'

    def __init__(
        self,
        name: str,
        unit: str,
        help: str = '',
        *,
        max_series: int = 64,
        on_overflow: str = 'raise',
        buckets: Optional[Tuple[float, ...]] = None,
    ) -> None:
        super().__init__(
            name, unit, help, max_series=max_series, on_overflow=on_overflow,
            buckets=tuple(buckets) if buckets is not None else DEFAULT_BUCKETS,
        )

    def observe(
        self,
        value: float,
        *,
        exemplar: Optional[Mapping[str, Any]] = None,
        **labels: Any,
    ) -> None:
        """Record one sample on the labeled series (optional exemplar)."""
        self.labels(**labels).observe(value, exemplar=exemplar)

    @contextlib.contextmanager
    def time(self, **labels: Any) -> Iterator[Series]:
        """Time the enclosed block into the labeled series (seconds)."""
        series = self.labels(**labels)
        t0 = time.perf_counter()
        try:
            yield series
        finally:
            series.observe(time.perf_counter() - t0)


_KINDS = {'counter': Counter, 'gauge': Gauge, 'histogram': Histogram}


class MetricRegistry:
    """Thread-safe name → :class:`Instrument` registry.

    Get-or-create semantics: re-requesting a name returns the existing
    instrument, but a kind or unit mismatch raises — two call sites must
    never accumulate incompatible series under one name (the
    ``record_value``-gauge-as-seconds bug this subsystem replaces).
    """

    def __init__(self) -> None:
        self._lock = threading.Lock()
        self._instruments: Dict[str, Instrument] = {}
        self._sites: Dict[str, str] = {}
        self._preserved: Tuple[str, ...] = ()

    @staticmethod
    def _caller_site() -> str:
        """``file.py:lineno`` of the first frame outside this module.

        Captured once per instrument *creation* (not per lookup) and on
        the conflict path, so the kind/unit-conflict error can point at
        the two offending registration sites instead of naming only the
        metric — the runtime half of the ``check_metric_names`` gate's
        file:line contract.
        """
        import sys

        frame = sys._getframe(1)
        here = __file__
        while frame is not None and frame.f_code.co_filename == here:
            frame = frame.f_back
        if frame is None:
            return '<unknown>'
        return f'{frame.f_code.co_filename}:{frame.f_lineno}'

    def _instrument(
        self,
        kind: str,
        name: str,
        unit: str,
        help: str,
        **kwargs: Any,
    ) -> Any:
        with self._lock:
            inst = self._instruments.get(name)
            if inst is None:
                inst = self._instruments[name] = _KINDS[kind](
                    name, unit, help, **kwargs
                )
                self._sites[name] = self._caller_site()
            elif inst.kind != kind or inst.unit != unit:
                first = self._sites.get(name, '<unknown>')
                raise ValueError(
                    f'metric {name!r} already registered as '
                    f'{inst.kind}(unit={inst.unit!r}) at {first}; '
                    f'requested {kind}(unit={unit!r}) from '
                    f'{self._caller_site()}'
                )
            return inst

    def get(self, name: str) -> Optional[Instrument]:
        """The registered instrument under ``name``, or None."""
        with self._lock:
            return self._instruments.get(name)

    def counter(
        self,
        name: str,
        *,
        unit: str = 'count',
        help: str = '',
        on_overflow: str = 'raise',
    ) -> Counter:
        """Get or create the named :class:`Counter`."""
        return self._instrument(
            'counter', name, unit, help, on_overflow=on_overflow
        )

    def gauge(
        self,
        name: str,
        *,
        unit: str = 'value',
        help: str = '',
        on_overflow: str = 'raise',
    ) -> Gauge:
        """Get or create the named :class:`Gauge`."""
        return self._instrument(
            'gauge', name, unit, help, on_overflow=on_overflow
        )

    def histogram(
        self,
        name: str,
        *,
        unit: str = 's',
        help: str = '',
        on_overflow: str = 'raise',
        buckets: Optional[Tuple[float, ...]] = None,
    ) -> Histogram:
        """Get or create the named :class:`Histogram`."""
        return self._instrument(
            'histogram', name, unit, help,
            on_overflow=on_overflow, buckets=buckets,
        )

    def snapshot(self) -> RegistrySnapshot:
        """Typed point-in-time view of every instrument."""
        with self._lock:
            instruments = dict(self._instruments)
        return RegistrySnapshot(
            instruments={
                name: inst.snapshot()
                for name, inst in sorted(instruments.items())
            }
        )

    def preserve(self, *prefixes: str) -> None:
        """Shield name prefixes from :meth:`reset`'s in-place zeroing.

        The zeroed-husk hazard, fixed once instead of per-call-site: a
        cold-path pass that resets the registry between streams used to
        wipe previously recorded summary gauges (headline /
        train / serve rates), leaving zeroed husks in the final
        snapshot — each consumer re-recorded them by hand. Declaring
        ``REGISTRY.preserve('summary/')`` makes every later ``reset()``
        skip instruments whose name starts with a preserved prefix
        (exact names work too: a full name is its own prefix).
        ``reset(clear=True)`` remains the full wipe: it drops the
        instruments AND the preserve list.
        """
        with self._lock:
            self._preserved = tuple(dict.fromkeys(self._preserved + prefixes))

    @property
    def preserved(self) -> Tuple[str, ...]:
        """The reset-shielded name prefixes, in declaration order."""
        return self._preserved

    def reset(self, *, clear: bool = False) -> None:
        """Zero every non-preserved series in place; ``clear=True`` wipes.

        The in-place default keeps series objects held by hot loops
        (e.g. a bound stage series inside a running feed) recording into
        the registry across measurement passes, and skips instruments
        shielded by :meth:`preserve`. ``clear=True`` forgets the
        instruments (new registrations may then change kind/unit) and
        the preserve list with them.
        """
        with self._lock:
            if clear:
                self._instruments.clear()
                self._sites.clear()
                self._preserved = ()
                return
            instruments = [
                inst
                for name, inst in self._instruments.items()
                if not name.startswith(self._preserved)
            ]
        for inst in instruments:
            inst.reset()


#: The process-wide default registry (what the instrumented hot paths and
#: the ``utils.profiling`` façade record into).
REGISTRY = MetricRegistry()


def counter(
    name: str, *, unit: str = 'count', help: str = '', on_overflow: str = 'raise'
) -> Counter:
    """Get or create a :class:`Counter` in the default registry."""
    return REGISTRY.counter(name, unit=unit, help=help, on_overflow=on_overflow)


def gauge(
    name: str, *, unit: str = 'value', help: str = '', on_overflow: str = 'raise'
) -> Gauge:
    """Get or create a :class:`Gauge` in the default registry."""
    return REGISTRY.gauge(name, unit=unit, help=help, on_overflow=on_overflow)


def histogram(
    name: str,
    *,
    unit: str = 's',
    help: str = '',
    on_overflow: str = 'raise',
    buckets: Optional[Tuple[float, ...]] = None,
) -> Histogram:
    """Get or create a :class:`Histogram` in the default registry."""
    return REGISTRY.histogram(
        name, unit=unit, help=help, on_overflow=on_overflow, buckets=buckets
    )


@contextlib.contextmanager
def timed_labels(
    name: str,
    *,
    unit: str = 's',
    registry: Optional[MetricRegistry] = None,
    **labels: Any,
) -> Iterator[Series]:
    """Time the enclosed block into a labeled histogram series.

    The one-line form the pipeline stages use::

        with timed_labels('pipeline/stage_seconds', stage='read'):
            table = read(...)
    """
    reg = registry if registry is not None else REGISTRY
    series = reg.histogram(name, unit=unit).labels(**labels)
    t0 = time.perf_counter()
    try:
        yield series
    finally:
        series.observe(time.perf_counter() - t0)
