"""Wyscout API-v3 raw event flattening.

The v3 converter (:mod:`socceraction_tpu_torch.spadl.wyscout_v3`) consumes a
flat-column frame; the v3 API delivers nested camelCase JSON
(``type.primary``, ``pass.endLocation.x``, ``groundDuel.duelType``, ...).
This module bridges them:

- nested objects flatten with ``_``-joined snake_case paths
  (``pass.endLocation.x`` → ``pass_end_location_x``,
  ``shot.isGoal`` → ``shot_is_goal``),
- the ``type.secondary`` label list becomes one flag column per label
  (``type_cross``, ``type_save``, ``type_head_pass``, ...), matching the
  column names the converter reads,
- ``matchPeriod`` strings stay for the converter's period mapping.

The reference fork has no v3 *loader* at all (its ``wyscout_v3.py``
converter sketch assumes the flat frame already exists); this completes
the ingest path.

Port of ``socceraction_tpu/data/wyscout/v3.py``: the same code, with pandas imported inside the
functions that take or build frames, so the module imports where pandas is absent.
"""

from __future__ import annotations

from typing import TYPE_CHECKING, Any, Dict, List

from ..base import _localloadjson, _snake

if TYPE_CHECKING:  # pandas is imported inside the functions that take or build frames
    import pandas as pd

__all__ = ['flatten_v3_events', 'load_v3_events']


def _flatten(obj: Dict[str, Any], prefix: str, out: Dict[str, Any]) -> None:
    for key, value in obj.items():
        col = prefix + _snake(key)
        if isinstance(value, dict):
            _flatten(value, col + '_', out)
        elif col == 'type_secondary' and isinstance(value, list):
            for label in value:
                out[f'type_{label}'] = 1
        else:
            out[col] = value


def flatten_v3_events(events: List[Dict[str, Any]]) -> pd.DataFrame:
    """Flatten raw v3 event dicts into the converter's column layout.

    Parameters
    ----------
    events : list of dict
        Raw Wyscout v3 event objects (the ``events`` array of a match
        feed).

    Returns
    -------
    pd.DataFrame
        One row per event, flat snake_case columns, secondary-type flag
        columns filled with 0 where absent.
    """
    import pandas as pd

    rows: List[Dict[str, Any]] = []
    for event in events:
        row: Dict[str, Any] = {}
        _flatten(event, '', row)
        rows.append(row)
    df = pd.DataFrame(rows)
    # secondary-type flags are sparse per event: absent means 0
    for col in df.columns:
        if col.startswith('type_') and col != 'type_primary':
            df[col] = df[col].fillna(0)
    return df


def load_v3_events(path: str) -> pd.DataFrame:
    """Load one v3 match feed (JSON with an ``events`` array) and flatten it."""
    obj = _localloadjson(path)
    events = obj['events'] if isinstance(obj, dict) and 'events' in obj else obj
    return flatten_v3_events(events)
