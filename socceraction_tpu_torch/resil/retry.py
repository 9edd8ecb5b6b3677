"""Typed retry engine: classification, jittered backoff, budget accounting.

The transient-error sites of a long-running rating service — parquet
reads under a flaky filesystem, registry checkpoint loads racing an NFS
cache, debug-bundle and ledger writes on a briefly-full disk — share one
failure grammar: *retry what is plausibly transient, immediately raise
what is provably permanent, and when the budget runs out surface the
real error, not a generic timeout*. :func:`retry_call` is that grammar
in one place:

- **classification first** (:func:`classify_error`): permanent types
  are checked *before* transient ones, so ``FileNotFoundError`` (a
  subclass of the transient ``OSError``) never burns retries on a path
  that will not appear, and a schema/layout error (``ValueError`` /
  ``KeyError``) raises on attempt one with zero sleeps;
- **jittered exponential backoff**: delay doubles per attempt, capped
  at ``max_delay_s``, randomized by ``jitter`` (seedable for
  deterministic tests — the chaos suite pins exact schedules);
- **budgets**: ``max_attempts`` bounds tries, ``budget_s`` bounds total
  wall spent retrying (the next sleep must fit in what remains), and
  ``attempt_timeout_s`` bounds one attempt (run on a helper thread and
  abandoned on expiry — only for callables safe to abandon, see the
  policy docs);
- **exhaustion surfaces the last underlying error** — the actual
  ``OSError`` the final attempt saw, with the attempt count attached to
  its message via ``raise ... from`` context, never a synthetic
  "retries exhausted" wrapper that hides the cause.

Every outcome lands in the governed ``resil/retries{site,outcome}``
counter (``outcome`` ∈ ``retried`` | ``recovered`` | ``exhausted`` |
``permanent``) and retries record a ``retry`` event in the flight
recorder and the run log, so a post-mortem shows what has been flapping.

A copy of the JAX package's ``socceraction_tpu/resil/retry.py``.
"""

from __future__ import annotations

import random
import threading
import time
from dataclasses import dataclass
from typing import Any, Callable, Optional, Tuple, TypeVar

__all__ = ['RetryPolicy', 'classify_error', 'retry_call']

T = TypeVar('T')

#: Error types retried by default: plausibly-environmental failures.
DEFAULT_TRANSIENT: Tuple[type, ...] = (OSError, TimeoutError)

#: Error types never retried, checked FIRST (several subclass OSError):
#: a missing file, a permission wall or malformed data does not heal by
#: waiting, and retrying it only delays the actionable error.
DEFAULT_PERMANENT: Tuple[type, ...] = (
    FileNotFoundError,
    IsADirectoryError,
    NotADirectoryError,
    PermissionError,
    KeyError,
    ValueError,
    TypeError,
)


@dataclass(frozen=True)
class RetryPolicy:
    """Knobs of one retry site.

    ``attempt_timeout_s``, when set, runs each attempt on a daemon
    helper thread and gives up waiting after the timeout (classified
    transient). The abandoned attempt keeps running to completion in
    the background — use it only for idempotent, side-effect-safe
    callables (reads), never for writes that must not overlap their
    own retry. ``seed`` pins the jitter sequence (tests); ``None``
    draws from the process RNG.
    """

    max_attempts: int = 3
    base_delay_s: float = 0.05
    max_delay_s: float = 2.0
    #: fraction of each delay randomized away: sleep ∈ [(1-j)·d, d]
    jitter: float = 0.5
    #: total wall-clock budget across sleeps (None = unbounded); the
    #: next backoff must FIT in what remains or the last error surfaces
    budget_s: Optional[float] = None
    attempt_timeout_s: Optional[float] = None
    transient: Tuple[type, ...] = DEFAULT_TRANSIENT
    permanent: Tuple[type, ...] = DEFAULT_PERMANENT
    seed: Optional[int] = None

    def __post_init__(self) -> None:
        if self.max_attempts < 1:
            raise ValueError('max_attempts must be >= 1')
        if not 0.0 <= self.jitter <= 1.0:
            raise ValueError('jitter must be in [0, 1]')

    def delay(self, attempt: int, rng: random.Random) -> float:
        """The jittered backoff before retry number ``attempt`` (1-based)."""
        d = min(self.max_delay_s, self.base_delay_s * (2.0 ** (attempt - 1)))
        return d * (1.0 - self.jitter * rng.random())


def classify_error(exc: BaseException, policy: RetryPolicy) -> str:
    """``'transient'`` or ``'permanent'`` under ``policy``.

    Permanent types win over transient ones (subclass overlap:
    ``FileNotFoundError`` is an ``OSError``); anything matching neither
    tuple is permanent — an unknown failure mode must surface, not spin.
    """
    if isinstance(exc, policy.permanent):
        return 'permanent'
    if isinstance(exc, policy.transient):
        return 'transient'
    return 'permanent'


def _count(site: str, outcome: str) -> None:
    try:
        from ..obs import counter

        counter('resil/retries', unit='count').inc(
            1, site=site, outcome=outcome
        )
    except Exception:
        pass  # accounting must never change the retry outcome


def _record_retry(site: str, attempt: int, exc: BaseException, delay: float) -> None:
    try:
        from ..obs.recorder import RECORDER
        from ..obs.trace import current_runlog

        payload = {
            'site': site,
            'attempt': attempt,
            'error': f'{type(exc).__name__}: {exc}',
            'delay_s': round(delay, 4),
        }
        RECORDER.record('retry', **payload)
        # dual-write to the run log (like fault_injected): the recorder
        # ring dies with the process
        log = current_runlog()
        if log is not None:
            log.event('retry', **payload)
    except Exception:
        pass


def _run_attempt(
    fn: Callable[..., T], args: tuple, kwargs: dict, timeout: Optional[float]
) -> T:
    """One attempt, optionally bounded by a helper-thread timeout."""
    if timeout is None:
        return fn(*args, **kwargs)
    box: dict = {}
    done = threading.Event()

    def _target() -> None:
        try:
            box['out'] = fn(*args, **kwargs)
        except BaseException as e:  # noqa: BLE001 - re-raised on the caller
            box['exc'] = e
        finally:
            done.set()

    t = threading.Thread(target=_target, name='retry-attempt', daemon=True)
    t.start()
    if not done.wait(timeout):
        raise TimeoutError(
            f'attempt exceeded attempt_timeout_s={timeout} '
            '(abandoned; it may still complete in the background)'
        )
    if 'exc' in box:
        raise box['exc']
    return box['out']


def retry_call(
    fn: Callable[..., T],
    *args: Any,
    site: str,
    policy: Optional[RetryPolicy] = None,
    sleep: Callable[[float], None] = time.sleep,
    **kwargs: Any,
) -> T:
    """Call ``fn(*args, **kwargs)`` under ``policy``; see the module docs.

    ``site`` is the governed accounting label (low cardinality: one
    literal per call site — ``'ingest.read'``, ``'recorder.dump'``). ``sleep`` is injectable so
    tests assert exact backoff schedules without waiting them out.
    """
    policy = policy if policy is not None else RetryPolicy()
    rng = random.Random(policy.seed) if policy.seed is not None else random
    budget_left = policy.budget_s
    attempt = 0
    while True:
        attempt += 1
        try:
            out = _run_attempt(fn, args, kwargs, policy.attempt_timeout_s)
        except BaseException as e:  # noqa: BLE001 - classified below
            if classify_error(e, policy) == 'permanent':
                _count(site, 'permanent')
                raise
            delay = policy.delay(attempt, rng)
            out_of_attempts = attempt >= policy.max_attempts
            out_of_budget = budget_left is not None and delay > budget_left
            if out_of_attempts or out_of_budget:
                _count(site, 'exhausted')
                # the LAST underlying error is the actionable one; the
                # note rides along without replacing its type. An
                # errno-carrying OSError renders via errno/strerror (its
                # args tuple is (errno, strerror) and must stay that
                # shape for errno-inspecting callers), so the note goes
                # on strerror there and on args[0] everywhere else
                note = f'(after {attempt} attempt(s) at {site!r})'
                if isinstance(e, OSError) and e.errno is not None:
                    e.strerror = f'{e.strerror or "error"} {note}'
                elif e.args:
                    e.args = (f'{e.args[0]} {note}',) + e.args[1:]
                else:
                    e.args = (f'failed {note}',)
                raise
            _count(site, 'retried')
            _record_retry(site, attempt, e, delay)
            sleep(delay)
            if budget_left is not None:
                budget_left -= delay
            continue
        if attempt > 1:
            _count(site, 'recovered')
        return out
