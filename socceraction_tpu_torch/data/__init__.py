"""Provider data access: loaders for event-stream data sources.

Layer L1 of the framework (SURVEY §1): everything here is host-side,
dict-shaped and ragged — the columnar device runtime starts at the SPADL
boundary (:mod:`socceraction_tpu_torch.spadl`, :mod:`socceraction_tpu_torch.core`).

Port of ``socceraction_tpu/data/__init__.py``.
"""

from .base import EventDataLoader, MissingDataError, ParseError

__all__ = ['EventDataLoader', 'MissingDataError', 'ParseError']
