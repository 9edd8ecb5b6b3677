"""Device-memory residency ledger: named-owner byte claims, reconciled.

Port of the JAX package's ``socceraction_tpu/obs/residency.py``.
``mem/bytes_in_use`` (:mod:`socceraction_tpu_torch.obs.memory`) says how
full the card is and ``live_array_census()`` what shapes are resident;
neither says *whose* bytes they are. This module is the attribution
layer:

- :func:`claim_bytes` — a subsystem that makes tensors device-resident
  registers them under a low-cardinality **owner** name
  (``pipeline_feed``, ``xt_fleet``, ...); the claim's byte size is
  summed over the tree's tensor leaves (``nbytes``) and recorded into
  the governed ``mem/owned_bytes{owner}`` gauge. Three release
  disciplines:

  - **keyed** (``key=...``): re-claiming the same ``(owner, key)``
    replaces the previous claim;
  - **scoped**: hold the returned :class:`Claim` and call
    :meth:`Claim.release` (the xT fleet solve claims its stacks for the
    duration of a fit);
  - **weak** (``weak=True``): per-leaf ``weakref.finalize`` hooks shrink
    the claim as the tensors are garbage-collected (the packed pipeline
    claims each shipped batch and lets consumption release it).

- :func:`residency_report` — the reconciliation: claimed bytes per
  owner against the live-tensor census, with the remainder reported as
  the reserved ``unattributed`` owner
  (``mem/owned_bytes{owner="unattributed"}``). On a card the report
  also carries the caching allocator's allocated and reserved bytes:
  reserved bytes beyond the allocated ones are free blocks the
  allocator keeps for reuse, reported as ``cached_free_bytes`` and
  never counted as unattributed.

The ledger is an attribution estimate, not an allocator: claimed sizes
are ``nbytes`` sums at claim time, so views and deferred frees can make
owners over- or under-read versus the census by transient amounts
(``over_attributed_bytes`` makes the direction visible). Claims of host
tensors are counted too; claim device trees only where device
attribution is the point.
"""

from __future__ import annotations

import dataclasses
import itertools
import re
import threading
import weakref
from collections import deque
from typing import Any, Dict, Iterator, List, Optional

from .metrics import REGISTRY, MetricRegistry

__all__ = [
    'Claim',
    'claim_bytes',
    'owned_bytes',
    'residency_report',
    'reset_residency',
    'tree_nbytes',
]

#: owner names become label values of ``mem/owned_bytes`` — keep them
#: label-safe and bounded by construction (a subsystem name, never an id)
_OWNER_RE = re.compile(r'^[a-z][a-z0-9_]*$')

#: the reconciliation remainder's reserved owner name
UNATTRIBUTED = 'unattributed'

_claim_seq = itertools.count(1)


def _iter_leaves(tree: Any) -> Iterator[Any]:
    """Array-ish leaves of a tree: the fields of a dataclass (the port's
    batch classes), and the items of dicts, lists and tuples."""
    if dataclasses.is_dataclass(tree) and not isinstance(tree, type):
        for f in dataclasses.fields(tree):
            yield from _iter_leaves(getattr(tree, f.name))
    elif isinstance(tree, dict):
        for v in tree.values():
            yield from _iter_leaves(v)
    elif isinstance(tree, (list, tuple)):
        for v in tree:
            yield from _iter_leaves(v)
    elif tree is not None:
        yield tree


def tree_nbytes(tree: Any) -> int:
    """Total ``nbytes`` over a pytree's array leaves (non-arrays ignored)."""
    total = 0
    for leaf in _iter_leaves(tree):
        nbytes = getattr(leaf, 'nbytes', None)
        if nbytes is not None:
            try:
                total += int(nbytes)
            except (TypeError, ValueError):
                continue
    return total


class Claim:
    """One owner's registered byte claim (see :func:`claim_bytes`)."""

    __slots__ = ('owner', 'key', 'nbytes', '_ledger', '_finalizers', '_released')

    def __init__(
        self, owner: str, key: Any, nbytes: int, ledger: '_Ledger'
    ) -> None:
        self.owner = owner
        self.key = key
        self.nbytes = int(nbytes)
        self._ledger = ledger
        self._finalizers: List[Any] = []
        self._released = False

    @property
    def released(self) -> bool:
        """True once the claim no longer counts toward its owner."""
        return self._released

    def release(self) -> None:
        """Remove this claim from the ledger (idempotent)."""
        for f in self._finalizers:
            f.detach()
        self._finalizers = []
        self._ledger._drop(self)

    def __repr__(self) -> str:
        return (
            f'Claim(owner={self.owner!r}, key={self.key!r}, '
            f'nbytes={self.nbytes}, released={self._released})'
        )


class _Ledger:
    """The process-wide claim table behind the module-level functions."""

    def __init__(self, registry: Optional[MetricRegistry] = None) -> None:
        self._lock = threading.Lock()
        self._registry = registry
        #: owner -> key -> Claim
        self._claims: Dict[str, Dict[Any, Claim]] = {}
        #: (claim, leaf_bytes) shrinks queued by weak-mode finalizers.
        #: Finalizers run at GC time on WHATEVER thread triggered the
        #: collection — possibly one already holding ``_lock`` (an
        #: allocation inside claim()/owned() can start a cyclic GC
        #: pass), so a finalizer must never take the lock itself: it
        #: appends here (deque.append is atomic) and the next ledger
        #: operation applies the backlog under the lock.
        self._pending_shrinks: 'deque[tuple]' = deque()

    def _reg(self) -> MetricRegistry:
        return self._registry if self._registry is not None else REGISTRY

    def _record_owner_locked(self, owner: str) -> None:
        total = sum(c.nbytes for c in self._claims.get(owner, {}).values())
        self._reg().gauge('mem/owned_bytes', unit='bytes').set(
            total, owner=owner
        )

    def claim(
        self,
        owner: str,
        arrays: Any,
        *,
        key: Any = None,
        weak: bool = False,
    ) -> Claim:
        if not _OWNER_RE.match(owner) or owner == UNATTRIBUTED:
            raise ValueError(
                f'invalid residency owner {owner!r}: want a bounded '
                "label-safe subsystem name ([a-z][a-z0-9_]*, not "
                f"{UNATTRIBUTED!r} — that name is the reconciliation "
                'remainder)'
            )
        if key is None:
            key = f'claim-{next(_claim_seq)}'
        claim = Claim(owner, key, 0, self)
        finalizers: List[Any] = []
        total = 0
        for leaf in _iter_leaves(arrays):
            nbytes = getattr(leaf, 'nbytes', None)
            if nbytes is None:
                continue
            try:
                leaf_bytes = int(nbytes)
            except (TypeError, ValueError):
                continue
            total += leaf_bytes
            if weak:
                try:
                    finalizers.append(
                        weakref.finalize(
                            leaf, self._shrink, claim, leaf_bytes
                        )
                    )
                except TypeError:
                    # a non-weakref-able leaf stays counted until an
                    # explicit release — better over-attributed than
                    # silently dropped
                    pass
        claim.nbytes = total
        claim._finalizers = finalizers
        with self._lock:
            self._drain_shrinks_locked()
            by_key = self._claims.setdefault(owner, {})
            previous = by_key.get(key)
            by_key[key] = claim
            self._record_owner_locked(owner)
        if previous is not None:
            # detach outside the lock: the previous claim's finalizers
            # must not fire _shrink against an already-replaced entry
            for f in previous._finalizers:
                f.detach()
            previous._finalizers = []
            previous._released = True
        self._reg().counter('mem/claims', unit='count').inc(1, owner=owner)
        return claim

    def _shrink(self, claim: Claim, leaf_bytes: int) -> None:
        """Weak-mode leaf finalizer: one collected array leaves the claim.

        Lock-free on purpose (see ``_pending_shrinks``): taking
        ``_lock`` here would self-deadlock when GC fires on a thread
        already inside the ledger. The gauge lags until the next ledger
        operation drains the queue — ``owned_bytes()`` always drains
        first, so reads are exact.
        """
        self._pending_shrinks.append((claim, leaf_bytes))

    def _drain_shrinks_locked(self) -> None:
        """Apply queued weak-claim shrinks (caller holds ``_lock``)."""
        while True:
            try:
                claim, leaf_bytes = self._pending_shrinks.popleft()
            except IndexError:
                return
            if claim._released:
                continue
            claim.nbytes = max(claim.nbytes - leaf_bytes, 0)
            if claim.nbytes == 0:
                by_key = self._claims.get(claim.owner, {})
                if by_key.get(claim.key) is claim:
                    del by_key[claim.key]
                claim._released = True
            self._record_owner_locked(claim.owner)

    def _drop(self, claim: Claim) -> None:
        with self._lock:
            self._drain_shrinks_locked()
            if claim._released:
                return
            claim._released = True
            by_key = self._claims.get(claim.owner, {})
            if by_key.get(claim.key) is claim:
                del by_key[claim.key]
            self._record_owner_locked(claim.owner)

    def owned(self) -> Dict[str, int]:
        with self._lock:
            self._drain_shrinks_locked()
            return {
                owner: sum(c.nbytes for c in by_key.values())
                for owner, by_key in sorted(self._claims.items())
                if by_key
            }

    def reset(self) -> None:
        with self._lock:
            self._pending_shrinks.clear()
            claims = [
                c for by_key in self._claims.values() for c in by_key.values()
            ]
            self._claims.clear()
        for c in claims:
            for f in c._finalizers:
                f.detach()
            c._finalizers = []
            c._released = True


_LEDGER = _Ledger()


def claim_bytes(
    owner: str, arrays: Any, *, key: Any = None, weak: bool = False
) -> Claim:
    """Register ``arrays``' bytes under ``owner``; returns the :class:`Claim`.

    ``arrays`` is any pytree of array-ish leaves (``nbytes`` summed over
    leaves; non-array leaves ignored). ``key``, when given, makes the
    claim *keyed*: a later claim under the same ``(owner, key)``
    replaces this one (the hot-swap idiom — the registry claims per
    model version). ``weak=True`` attaches per-leaf finalizers so the
    claim shrinks (and finally releases) as the arrays are collected —
    for buffers whose lifetime the claimer does not control (the feed's
    in-flight batches). Updates ``mem/owned_bytes{owner}`` and counts
    ``mem/claims{owner}``.
    """
    return _LEDGER.claim(owner, arrays, key=key, weak=weak)


def owned_bytes() -> Dict[str, int]:
    """Current claimed bytes per owner (live claims only) — one dict read."""
    return _LEDGER.owned()


def residency_report(
    *, top: int = 5, census: Optional[Dict[str, Any]] = None
) -> Dict[str, Any]:
    """Reconcile the ledger against the live-tensor census.

    Returns ``{'owners', 'owned_total_bytes', 'census_supported', ...}``;
    where the census reports (a card), adds ``census_total_bytes``,
    ``census_n_arrays``, the ``top`` largest census groups,
    ``unattributed_bytes`` (census minus claims, floored at 0 — recorded
    as ``mem/owned_bytes{owner="unattributed"}``),
    ``over_attributed_bytes`` (claims past the census: freed but still
    claimed tensors, or claimed host tensors) and the allocator's
    ``allocated_bytes``, ``reserved_bytes`` and ``cached_free_bytes``
    (reserved minus allocated: the caching allocator's free blocks, not
    a leak). Running the census walks every live object — a report-time
    cost, never part of a hot path.
    """
    from .memory import device_memory_stats, live_array_census

    owners = owned_bytes()
    owned_total = sum(owners.values())
    out: Dict[str, Any] = {
        'owners': owners,
        'owned_total_bytes': owned_total,
    }
    if census is None:
        census = live_array_census(top=top)
    supported = bool(census.get('supported'))
    out['census_supported'] = supported
    if supported:
        census_total = int(census.get('total_bytes', 0))
        remainder = census_total - owned_total
        unattributed = max(remainder, 0)
        out['census_total_bytes'] = census_total
        out['census_n_arrays'] = int(census.get('n_arrays', 0))
        out['census_top'] = list(census.get('top', ()))
        if census.get('other') is not None:
            out['census_other'] = dict(census['other'])
        out['unattributed_bytes'] = unattributed
        out['over_attributed_bytes'] = max(-remainder, 0)
        REGISTRY.gauge('mem/owned_bytes', unit='bytes').set(
            unattributed, owner=UNATTRIBUTED
        )
    stats = device_memory_stats()
    if stats is not None:
        out['allocated_bytes'] = int(stats['bytes_in_use'])
        out['reserved_bytes'] = int(stats['bytes_reserved'])
        out['cached_free_bytes'] = int(stats['bytes_reserved'] - stats['bytes_in_use'])
    return out


def reset_residency() -> None:
    """Release every claim (tests; the gauges reset separately)."""
    _LEDGER.reset()
