"""Sampled shadow parity: re-check rated batches against the reference path.

Port of the JAX package's ``socceraction_tpu/obs/parity.py``. The fused
rating path is held to the materialized reference by tests — at test
time, on test shapes. :class:`ParityProbe` turns that contract into a
live meter:

- a caller samples a fraction of its dispatches
  (:meth:`ParityProbe.should_sample`, deterministic 1-in-N — no RNG on
  the hot path) and hands the probe the *already computed* dispatch:
  the batch, its goalscore overrides, the values it returned and an
  exemplar id;
- a daemon worker re-rates the batch through
  :meth:`~socceraction_tpu_torch.vaep.base.VAEP.rate_batch_reference`
  **off the caller's thread**, and on the card **on its own CUDA
  stream**: at submit the probe records an event on the caller's
  current stream and marks every handed-over tensor as used by its
  stream (``record_stream``, so the caching allocator does not hand
  their memory to the caller's next dispatch while the probe still reads
  them); the worker's stream waits on that event before it reads. A
  full probe queue drops the sample and counts it; it never blocks the
  caller;
- per path-pair error histograms land in the governed ``num`` area
  (the JAX package's names) with the exemplar attached:

  | metric | kind | labels | meaning |
  |---|---|---|---|
  | ``num/parity_abs_err`` | histogram (value) | ``pair`` | max abs error of one probed dispatch |
  | ``num/parity_ulp_err`` | histogram (ulps) | ``pair`` | the same error in units-in-last-place |
  | ``num/parity_probes`` | counter | ``pair`` | dispatches probed |
  | ``num/parity_exceedances`` | counter | ``pair`` | probes past the configured band |
  | ``num/parity_dropped`` | counter | — | samples dropped (full queue / errors) |

- a probe past ``max_abs_err`` records a ``parity_exceeded`` event
  (run log + flight recorder) and fires the ``on_exceed`` hook.

``pair`` names the two sides compared: ``fused_vs_materialized`` for the
served path against the reference; :meth:`compare` is public so other
invariants can feed the same machinery. Each probe costs one extra
reference rating of the batch on the probe's stream.
"""

from __future__ import annotations

import queue
import threading
import time
from typing import Any, Callable, Dict, Optional

import numpy as np

from .metrics import REGISTRY

__all__ = ['ParityProbe']


class ParityProbe:
    """Off-thread sampled parity checks between two rating paths.

    Parameters
    ----------
    sample_rate : float
        Fraction of submitted flushes actually probed, implemented as a
        deterministic 1-in-``round(1/rate)`` counter (0 disables, 1.0
        probes everything).
    max_abs_err : float
        The parity band: a probe whose max abs error exceeds it counts
        an exceedance, records a ``parity_exceeded`` event and fires
        ``on_exceed``.
    queue_size : int
        Bound on flushes waiting for the probe worker; a full queue
        drops the sample (``num/parity_dropped``) instead of blocking
        the flusher.
    on_exceed : callable, optional
        ``on_exceed(report_dict)`` invoked (on the probe thread) per
        exceedance; must not raise (it is guarded). The serving layer
        hooks its rate-limited debug-bundle dump here.
    """

    def __init__(
        self,
        sample_rate: float = 0.05,
        max_abs_err: float = 1e-4,
        *,
        queue_size: int = 4,
        on_exceed: Optional[Callable[[Dict[str, Any]], None]] = None,
    ) -> None:
        if not 0.0 <= sample_rate <= 1.0:
            raise ValueError('sample_rate must be in [0, 1]')
        self.sample_rate = float(sample_rate)
        self.max_abs_err = float(max_abs_err)
        self.on_exceed = on_exceed
        self._queue: 'queue.Queue' = queue.Queue(maxsize=int(queue_size))
        self._lock = threading.Lock()
        self._tick = 0
        self._outstanding = 0
        self._probes = 0
        self._exceedances = 0
        self._errors = 0
        self._worst: Optional[float] = None
        self._worst_ulp: Optional[float] = None
        self._last: Optional[Dict[str, Any]] = None
        self._thread: Optional[threading.Thread] = None
        self._closed = False
        #: the probe's own CUDA stream per card, made at first use
        self._streams: Dict[Any, Any] = {}

    # -- sampling + submission (the caller's thread) -----------------------

    def should_sample(self) -> bool:
        """Deterministic 1-in-N sampling decision (cheap, no RNG)."""
        if self.sample_rate <= 0.0 or self._closed:
            return False
        period = max(1, round(1.0 / self.sample_rate))
        with self._lock:
            self._tick += 1
            return (self._tick - 1) % period == 0

    def submit_flush(
        self,
        model: Any,
        batch: Any,
        gs: Any,
        values: Any,
        exemplar: Optional[str] = None,
    ) -> bool:
        """Enqueue one rated dispatch for off-thread reference comparison.

        ``batch`` is the batch the dispatch rated (never mutated after
        it), ``gs`` its goalscore override block (or None), ``values``
        the ``(G, A, 3)`` ratings it returned; tensors on the card or on
        the CPU. Returns False (and counts a drop) when the probe queue
        is full.
        """
        # the served side's table-storage mode is captured NOW, at submit
        # time: an in-place set_quantize() on a live model must not
        # relabel observations whose values the previous mode computed
        try:
            quant = getattr(model, 'quantize', 'none')
        except ValueError:  # heads disagree mid-swap: label unknowable
            quant = 'none'
        with self._lock:
            if self._closed:
                return False
            if self._thread is None:
                self._thread = threading.Thread(
                    target=self._worker, name='parity-probe', daemon=True
                )
                self._thread.start()
            self._outstanding += 1
        ready = None
        device = getattr(values, 'device', None)
        if device is not None and device.type == 'cuda':
            ready = self._hand_over(device, (batch, gs, values))
        item = (model, batch, gs, values, exemplar, quant, ready)
        try:
            self._queue.put_nowait(item)
            return True
        except queue.Full:
            with self._lock:
                self._outstanding -= 1
            REGISTRY.counter('num/parity_dropped', unit='count').inc(1)
            return False

    def _hand_over(self, device: Any, trees: Any) -> Any:
        """The event the probe's stream waits on before reading ``trees``,
        recorded on the caller's current stream; every tensor of
        ``trees`` is marked as used by the probe's stream."""
        import torch

        from .residency import _iter_leaves

        with self._lock:
            stream = self._streams.get(device)
            if stream is None:
                stream = self._streams[device] = torch.cuda.Stream(device)
        for leaf in _iter_leaves(trees):
            if isinstance(leaf, torch.Tensor) and leaf.device == device:
                leaf.record_stream(stream)
        ready = torch.cuda.Event()
        ready.record(torch.cuda.current_stream(device))
        return stream, ready

    # -- the probe worker ---------------------------------------------------

    def _worker(self) -> None:
        while True:
            item = self._queue.get()
            if item is None:
                return
            try:
                self._probe_one(*item)
            except Exception:
                with self._lock:
                    self._errors += 1
                REGISTRY.counter('num/parity_dropped', unit='count').inc(1)
            finally:
                with self._lock:
                    self._outstanding -= 1

    def _probe_one(
        self,
        model: Any,
        batch: Any,
        gs: Any,
        values: Any,
        exemplar: Any,
        quant: str = 'none',
        ready: Any = None,
    ) -> None:
        import contextlib

        import torch

        scope = contextlib.nullcontext()
        if ready is not None:
            stream, event = ready
            torch.cuda.set_device(stream.device)
            stream.wait_event(event)
            scope = torch.cuda.stream(stream)
        with scope:
            overrides = {'goalscore': gs} if gs is not None else None
            want = model.rate_batch_reference(batch, dense_overrides=overrides)
            # host copies on the probe's stream: this waits for the
            # probe's own work only
            want = want.cpu().numpy()
            got = torch.as_tensor(values).cpu().numpy()
            mask = batch.mask.cpu().numpy()
        # the reference side is always f32; the SERVED side carries the
        # table-storage mode captured at submit time, so the error
        # histograms are the quantization error band per mode
        self.compare(
            'fused_vs_materialized', got, want, mask=mask,
            exemplar=exemplar, quant=quant,
        )

    # -- the comparison core (public: other invariants feed it too) --------

    def compare(
        self,
        pair: str,
        got: np.ndarray,
        want: np.ndarray,
        *,
        mask: Optional[np.ndarray] = None,
        exemplar: Optional[str] = None,
        quant: Optional[str] = None,
    ) -> Dict[str, Any]:
        """Record one parity observation between two value tensors.

        ``mask`` (broadcast against the leading axes) restricts the
        comparison to valid rows — padded slots carry garbage by
        contract. ``quant`` labels the observation with the served
        side's table-storage mode (``'bf16'``/``'int8'``) so the error
        histograms split per mode — the in-production quantization
        error band; ``None``/``'none'`` (f32 serving) stays unlabeled,
        keeping the pre-quantization series addresses stable. Returns
        the observation dict (also kept as :attr:`stats`'s ``last``).
        """
        got = np.asarray(got, dtype=np.float64)
        want = np.asarray(want, dtype=np.float64)
        if got.shape != want.shape:
            raise ValueError(
                f'parity shapes disagree: {got.shape} vs {want.shape}'
            )
        if mask is not None:
            valid = np.broadcast_to(
                np.asarray(mask, bool).reshape(
                    mask.shape + (1,) * (got.ndim - np.ndim(mask))
                ),
                got.shape,
            )
        else:
            valid = np.ones(got.shape, bool)
        err = np.where(valid, np.abs(got - want), 0.0)
        # NaN-vs-NaN agrees; NaN on one side only is maximal disagreement
        both_nan = np.isnan(got) & np.isnan(want)
        one_nan = np.isnan(got) ^ np.isnan(want)
        err = np.where(valid & both_nan, 0.0, err)
        err = np.where(valid & one_nan, np.inf, err)
        max_abs = float(np.max(err)) if err.size else 0.0
        # units-in-last-place of the reference value (f32 spacing: the
        # values being compared are f32 computations). A one-sided-NaN
        # reference has no spacing — force the same inf-disagreement
        # verdict as the abs error, never a NaN that would corrupt the
        # histogram and latch the lifetime max
        spacing = np.spacing(
            np.maximum(np.abs(np.nan_to_num(want)), np.float32(1.0)).astype(
                np.float32
            )
        ).astype(np.float64)
        ulp = np.where(valid & ~both_nan, err / spacing, 0.0)
        ulp = np.where(valid & one_nan, np.inf, ulp)
        max_ulp = float(np.max(ulp)) if ulp.size else 0.0

        exceeded = bool(max_abs > self.max_abs_err)
        observation = {
            'pair': pair,
            'quant': quant or 'none',
            'max_abs_err': max_abs,
            'max_ulp_err': max_ulp,
            'band': self.max_abs_err,
            'exceeded': exceeded,
            'request_id': exemplar,
            'n_compared': int(valid.sum()),
        }
        labels = {'pair': pair}
        if quant not in (None, 'none'):
            labels['quant'] = quant
        REGISTRY.histogram('num/parity_abs_err', unit='value').observe(
            max_abs,
            exemplar={'request_id': exemplar} if exemplar else None,
            **labels,
        )
        REGISTRY.histogram('num/parity_ulp_err', unit='ulps').observe(
            max_ulp, **labels
        )
        REGISTRY.counter('num/parity_probes', unit='count').inc(1, **labels)
        with self._lock:
            self._probes += 1
            if self._worst is None or max_abs > self._worst:
                self._worst = max_abs
            if self._worst_ulp is None or max_ulp > self._worst_ulp:
                self._worst_ulp = max_ulp
            if exceeded:
                self._exceedances += 1
            self._last = observation
        if exceeded:
            REGISTRY.counter('num/parity_exceedances', unit='count').inc(
                1, **labels
            )
            self._note_exceedance(observation)
        return observation

    def _note_exceedance(self, observation: Dict[str, Any]) -> None:
        from .numerics import record_health_event

        record_health_event('parity_exceeded', observation)
        if self.on_exceed is not None:
            try:
                self.on_exceed(observation)
            except Exception:
                pass  # the hook must never kill the probe worker

    # -- introspection / gate input -----------------------------------------

    def stats(self) -> Dict[str, Any]:
        """The probe's lifetime summary — the learn gate's parity input.

        ``evaluated`` is True once at least one probe completed;
        ``max_abs_err`` is the worst observed error (None before any
        probe).
        """
        with self._lock:
            return {
                'evaluated': self._probes > 0,
                'probes': self._probes,
                'max_abs_err': self._worst,
                'max_ulp_err': self._worst_ulp,
                'exceedances': self._exceedances,
                'errors': self._errors,
                'band': self.max_abs_err,
                'last': dict(self._last) if self._last else None,
            }

    def flush(self, timeout: Optional[float] = 30.0) -> bool:
        """Wait until every submitted probe has been processed."""
        deadline = None if timeout is None else time.monotonic() + timeout
        while True:
            with self._lock:
                if self._outstanding == 0:
                    return True
            if deadline is not None and time.monotonic() > deadline:
                return False
            time.sleep(0.005)

    def close(self) -> None:
        """Stop the worker thread (pending probes are processed first)."""
        with self._lock:
            if self._closed:
                return
            self._closed = True
            thread = self._thread
        if thread is not None:
            self._queue.put(None)
            thread.join(timeout=30.0)
