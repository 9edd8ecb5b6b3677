"""Nested, named spans: a timer scope that the device profile can see.

Port of ``span``, :class:`Span` and ``current_span`` from the JAX
package's ``socceraction_tpu/obs/trace.py``:

- :func:`span` times a named region (wall clock, plus a device-synced
  duration when the body registers outputs with :meth:`Span.sync`).
  Nesting is per thread (the feed's prefetch worker gets its own stack).
- In place of ``jax.named_scope`` the region runs under
  ``torch.profiler.record_function(name)``, so a ``torch.profiler`` trace
  shows the pipeline's spans by name.
- :meth:`Span.sync` records a CUDA event on the current stream and waits
  on that event at span exit, so the span is charged for its own stream's
  work and never for unrelated streams (``torch.cuda.synchronize()``
  would wait for every stream of the card).

The run log (``RunLog``), the flight recorder and ``Span.memory`` are not
ported yet: without a run log a span is a timer scope, as in the JAX
package.
"""

from __future__ import annotations

import contextlib
import itertools
import threading
from typing import Any, Dict, Iterator, List, Optional

from .metrics import NAME_RE

__all__ = ['Span', 'current_span', 'span']

_tls = threading.local()
_span_ids = itertools.count(1)


def current_span() -> Optional['Span']:
    """This thread's innermost open span, if any."""
    stack = getattr(_tls, 'stack', None)
    return stack[-1] if stack else None


def _span_stack() -> List['Span']:
    stack = getattr(_tls, 'stack', None)
    if stack is None:
        stack = _tls.stack = []
    return stack


class Span:
    """One open span: identity, attributes and registered sync events."""

    __slots__ = ('name', 'attrs', 'span_id', 'parent_id', '_events')

    def __init__(self, name: str, attrs: Dict[str, Any], parent_id: Optional[int]) -> None:
        self.name = name
        self.attrs = attrs
        self.span_id = next(_span_ids)
        self.parent_id = parent_id
        self._events: List[Any] = []

    def sync(self, value: Any) -> Any:
        """Have the span wait, at exit, for the device work queued so far.

        Records a CUDA event on the current stream of ``value``'s device
        (a tensor, or anything with a ``device``) and returns ``value``
        unchanged, so it can wrap an expression inline::

            with span('scenario/dispatch') as sp:
                values = sp.sync(model.rate_batch(batch))

        A CPU value needs no sync and records nothing.
        """
        import torch

        device = getattr(value, 'device', None)
        if isinstance(device, torch.device) and device.type == 'cuda':
            event = torch.cuda.Event()
            event.record(torch.cuda.current_stream(device))
            self._events.append(event)
        return value

    def annotate(self, **attrs: Any) -> None:
        """Attach additional attributes."""
        self.attrs.update(attrs)


def _record_function(name: str) -> Any:
    """``torch.profiler.record_function`` when torch is loaded, else a
    no-op: a data-prep process that never imported torch stays free of it."""
    import sys

    torch = sys.modules.get('torch')
    if torch is None:
        return contextlib.nullcontext()
    return torch.profiler.record_function(name)


@contextlib.contextmanager
def span(name: str, **attrs: Any) -> Iterator[Span]:
    """Open a named, nestable span around a code region.

    Waits at exit for the CUDA events the body registered with
    :meth:`Span.sync`, so the span's wall time covers its own stream's
    work. The region runs under ``torch.profiler.record_function(name)``.
    """
    if not NAME_RE.match(name):
        raise ValueError(
            f'span name {name!r} violates the area/stage convention '
            "(lowercase segments joined by '/', e.g. 'xt/fit')"
        )
    stack = _span_stack()
    parent = stack[-1] if stack else None
    s = Span(name, dict(attrs), parent.span_id if parent else None)
    stack.append(s)
    try:
        with _record_function(name):
            yield s
    finally:
        # never raise from span exit: a sync failure must not shadow the
        # body's own exception
        try:
            for event in s._events:
                event.synchronize()
        except RuntimeError:
            pass
        stack.pop()
