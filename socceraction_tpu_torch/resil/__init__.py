"""Resilience layer: fault injection, retries, circuit breaking and the
iteration journal.

Copies of the JAX package's ``socceraction_tpu/resil/faults.py``
(:func:`fault_point`, :class:`FaultPlan`, :class:`FaultSpec`),
``resil/retry.py`` (:class:`RetryPolicy`, :func:`retry_call`), which the
season store and the model registry read through, ``resil/journal.py``
(:class:`IterationJournal`, :class:`JournalState`), the learning loop's
durable record, and ``resil/breaker.py`` (:class:`CircuitBreaker`), which
the rating service wraps its fused dispatch in.
"""

from .breaker import CircuitBreaker
from .faults import FaultPlan, FaultSpec, fault_point, injected_faults
from .journal import IterationJournal, JournalState
from .retry import RetryPolicy, classify_error, retry_call

__all__ = [
    'CircuitBreaker',
    'FaultPlan',
    'FaultSpec',
    'IterationJournal',
    'JournalState',
    'RetryPolicy',
    'classify_error',
    'fault_point',
    'injected_faults',
    'retry_call',
]
