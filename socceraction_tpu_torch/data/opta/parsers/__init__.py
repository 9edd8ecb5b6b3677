"""Feed parsers for Opta(-derived) data streams.

Parity: reference ``socceraction/data/opta/parsers/__init__.py``.

Port of ``socceraction_tpu/data/opta/parsers/__init__.py``.
"""

from .base import OptaParser
from .f1_json import F1JSONParser
from .f7_xml import F7XMLParser
from .f9_json import F9JSONParser
from .f24_json import F24JSONParser
from .f24_xml import F24XMLParser
from .ma1_json import MA1JSONParser
from .ma3_json import MA3JSONParser
from .whoscored import WhoScoredParser

__all__ = [
    'OptaParser',
    'F1JSONParser',
    'F7XMLParser',
    'F9JSONParser',
    'F24JSONParser',
    'F24XMLParser',
    'MA1JSONParser',
    'MA3JSONParser',
    'WhoScoredParser',
]
