"""The port's micro-batcher against the JAX package's, on the CPU.

Counterparts of ``tests/test_serve.py``'s batcher cases (flush on full,
the bucket ladder and fill, overload rejection, a runner error failing its
futures, cancelled futures, close draining) and of
``tests/test_obs_runtime.py``'s flusher-death case. Each scenario runs the
same submissions through both packages' ``MicroBatcher`` with the same
pure-Python runner; what the runner saw (payloads, buckets), what every
future resolved to (value, or error type and message), and the ``serve/*``
counter deltas in each package's own registry must be equal.

No scenario depends on two submissions landing within a wall-clock window:
a flush is forced by a full queue, by ``close()``, or by a runner that
holds the flusher on an ``Event`` until the test has queued the rest.
"""

import threading
from types import SimpleNamespace

import pytest

from socceraction_tpu.obs import REGISTRY as JAX_REGISTRY
from socceraction_tpu.obs.context import new_request_context as jax_context
from socceraction_tpu.serve import MicroBatcher as JaxBatcher
from socceraction_tpu.serve import Overloaded as JaxOverloaded
from socceraction_tpu_torch.obs import REGISTRY
from socceraction_tpu_torch.obs.context import new_request_context
from socceraction_tpu_torch.serve import MicroBatcher, Overloaded

PKGS = {
    'jax': SimpleNamespace(Batcher=JaxBatcher, Overloaded=JaxOverloaded, metrics=JAX_REGISTRY,
                           context=jax_context),
    'port': SimpleNamespace(Batcher=MicroBatcher, Overloaded=Overloaded, metrics=REGISTRY,
                            context=new_request_context),
}

#: far beyond any test: no flush is ever due by the clock
NEVER_MS = 600_000.0
WAIT = 30.0

COUNTERS = (
    ('serve/flushes', {'reason': 'full'}),
    ('serve/flushes', {'reason': 'close'}),
    ('serve/flushes', {'reason': 'deadline'}),
    ('serve/rejected_total', {}),
    ('serve/deadline_expired', {'kind': 'rate'}),
    ('serve/flusher_restarts', {}),
    ('serve/flusher_crashes', {}),
)


def _counts(p):
    snap = p.metrics.snapshot()
    return [snap.value(name, **labels) for name, labels in COUNTERS]


def _outcome(fut):
    """What a future resolved to: ``('ok', value)`` or its error."""
    try:
        return ('ok', fut.result(timeout=WAIT))
    except Exception as e:  # the outcome under comparison
        return (type(e).__name__, str(e))


def _both(scenario):
    """``scenario(p)`` on each package, with its counter deltas."""
    out = {}
    for pkg, p in PKGS.items():
        before = _counts(p)
        result = scenario(p)
        out[pkg] = (result, [a - b for a, b in zip(_counts(p), before)])
    assert out['port'] == out['jax']
    return out['port']


def _flush_on_full(p):
    seen = []

    def runner(payloads, bucket):
        seen.append((list(payloads), bucket))
        return [x * 10 for x in payloads]

    with p.Batcher(runner, max_batch_size=4, max_wait_ms=NEVER_MS) as b:
        futs = [b.submit(i) for i in range(4)]
        results = [_outcome(f) for f in futs]
    return results, seen


def _ladder_and_fill(p):
    seen = []

    def runner(payloads, bucket):
        seen.append((len(payloads), bucket))
        return payloads

    b = p.Batcher(runner, max_batch_size=8, max_wait_ms=NEVER_MS)
    ladder = b.ladder
    futs = [b.submit(i) for i in range(3)]
    b.close()  # the close flush takes all three: bucket 4
    fill = p.metrics.snapshot().value('serve/batch_fill_ratio', stat='last')
    return ladder, seen, [_outcome(f) for f in futs], fill


def _overload(p):
    entered, release = threading.Event(), threading.Event()

    def runner(payloads, bucket):
        entered.set()
        release.wait(timeout=WAIT)
        return payloads

    b = p.Batcher(runner, max_batch_size=1, max_wait_ms=0.0, max_queue=2)
    try:
        first = b.submit('a')
        assert entered.wait(timeout=WAIT)  # the flusher holds 'a' in the runner
        held = [b.submit(x) for x in 'bc']  # fills the queue
        try:
            b.submit('d')
            rejected = None
        except p.Overloaded as e:
            rejected = str(e)
        release.set()
        return rejected, _outcome(first), [_outcome(f) for f in held]
    finally:
        release.set()
        b.close()


def _runner_error(p):
    def runner(payloads, bucket):
        raise RuntimeError('boom')

    with p.Batcher(runner, max_batch_size=2, max_wait_ms=NEVER_MS) as b:
        futs = [b.submit(i) for i in range(2)]
        return [_outcome(f) for f in futs]


def _cancelled(p):
    def runner(payloads, bucket):
        return payloads

    with p.Batcher(runner, max_batch_size=8, max_wait_ms=NEVER_MS) as b:
        doomed = b.submit('x')
        cancelled = doomed.cancel()
        b.close()
    with p.Batcher(runner, max_batch_size=3, max_wait_ms=NEVER_MS) as b:
        dead = b.submit('a')
        dead_cancelled = dead.cancel()
        live = [b.submit('b'), b.submit('c')]  # 3 queued -> a full flush
        live_out = [_outcome(f) for f in live]
        d = b.submit('d')
    return cancelled, dead_cancelled, live_out, _outcome(d)


def _close_drains(p):
    def runner(payloads, bucket):
        return payloads

    b = p.Batcher(runner, max_batch_size=64, max_wait_ms=NEVER_MS)
    futs = [b.submit(i) for i in range(3)]
    b.close()
    try:
        b.submit('late')
        late = None
    except RuntimeError as e:
        late = str(e)
    return [_outcome(f) for f in futs], late


def _close_without_drain(p):
    def runner(payloads, bucket):
        return payloads

    b = p.Batcher(runner, max_batch_size=64, max_wait_ms=NEVER_MS)
    futs = [b.submit(i) for i in range(2)]
    b.close(drain=False)
    return [_outcome(f) for f in futs]


def _deadline_expiry(p):
    """A request whose deadline has passed when its flush comes is failed
    without reaching the runner; the live one beside it is served."""
    seen = []

    def runner(payloads, bucket):
        seen.append(list(payloads))
        return payloads

    b = p.Batcher(runner, max_batch_size=2, max_wait_ms=NEVER_MS)
    late = b.submit('late', ctx=p.context('rate', deadline_ms=0.0))
    live = b.submit('live', ctx=p.context('rate'))
    out = [_outcome(late)[0], _outcome(live)]
    b.close()
    return out, seen


def _flusher_death(p):
    crashes = []
    b = p.Batcher(lambda payloads, bucket: payloads, max_batch_size=4, max_wait_ms=NEVER_MS,
                  on_crash=crashes.append)

    def dies():
        raise RuntimeError('injected death')

    b._take = dies
    fut = b.submit('x')
    outcome = _outcome(fut)
    try:
        b.submit('y')
        rejected = None
    except RuntimeError as e:
        rejected = str(e)
    state = (b.flusher_alive, repr(b.crashed), b.flusher_restarts, b.queue_depth)
    b.close()
    return outcome, rejected, state, [repr(e) for e in crashes]


SCENARIOS = {
    'flush_on_full': _flush_on_full,
    'ladder_and_fill': _ladder_and_fill,
    'overload': _overload,
    'runner_error': _runner_error,
    'cancelled_futures': _cancelled,
    'close_drains': _close_drains,
    'close_without_drain': _close_without_drain,
    'deadline_expiry': _deadline_expiry,
    'flusher_death': _flusher_death,
}


@pytest.mark.parametrize('scenario', list(SCENARIOS))
def test_batcher_matches_the_jax_package(scenario):
    _both(SCENARIOS[scenario])


def test_scenarios_show_what_they_claim():
    """The comparisons above are not vacuous (the JAX tests' assertions, on
    the port's runs)."""
    (results, seen), deltas = _both(_flush_on_full)
    assert [r[1] for r in results] == [0, 10, 20, 30] and seen == [([0, 1, 2, 3], 4)]
    assert deltas[0] == 1
    (ladder, seen, _, fill), deltas = _both(_ladder_and_fill)
    assert ladder == (1, 2, 4, 8) and seen == [(3, 4)] and fill == 0.75 and deltas[1] == 1
    (rejected, first, held), deltas = _both(_overload)
    assert 'max_queue=2' in rejected and first == ('ok', 'a') and deltas[3] == 1
    assert held == [('ok', 'b'), ('ok', 'c')]
    (out, seen), deltas = _both(_deadline_expiry)
    assert out == ['DeadlineExceeded', ('ok', 'live')] and seen == [['live']] and deltas[4] == 1
    (outcome, rejected, state, crashes), deltas = _both(_flusher_death)
    assert outcome[0] == 'RuntimeError' and 'flusher thread died' in outcome[1]
    assert 'injected death' in rejected and state[0] is False and state[2] == 3
    assert len(crashes) == 1 and deltas[5:] == [3, 1]
