"""Resilience layer: fault injection and retries.

Copies of the JAX package's ``socceraction_tpu/resil/faults.py``
(:func:`fault_point`, :class:`FaultPlan`, :class:`FaultSpec`) and
``resil/retry.py`` (:class:`RetryPolicy`, :func:`retry_call`), which the
season store reads through. The circuit breaker and the iteration
journal come with the serving and learning layers.
"""

from .faults import FaultPlan, FaultSpec, fault_point, injected_faults
from .retry import RetryPolicy, classify_error, retry_call

__all__ = [
    'FaultPlan',
    'FaultSpec',
    'RetryPolicy',
    'classify_error',
    'fault_point',
    'injected_faults',
    'retry_call',
]
