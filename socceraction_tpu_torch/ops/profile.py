"""Measured per-platform choice of the VAEP rating path.

Port of ``socceraction_tpu/ops/profile.py``. ``VAEP.rate_batch`` with MLP
heads can rate two ways, equal within the f32 parity band:

- ``'fused'``: the combined-table fold (:mod:`.fused`): one launch of the
  fused gather + matmul first layer, no feature tensor;
- ``'materialized'``: the full ``(G, A, F)`` feature tensor
  (:mod:`.features`) through each head's plain forward.

Which is faster is a question for the hardware, so the choice is read
from a measurement: ``platform_profiles.json`` beside this module holds
the measured winner per device type, written only by
:func:`record_measurement` from a synced reading of both paths (the
``cuda`` entry from ``chip_smoke.py`` phase 12). The opt-in
``'fused_bf16'`` (the fused fold with a bf16 hidden chain) is never
chosen by the profile; ``SOCCERACTION_TPU_RATING_PATH`` forces any path.

The platform is the model's device type (``'cuda'``, ``'cpu'``), passed
in by the caller: a model on the CPU in a process that also holds a card
rates by the CPU's entry. A platform without an entry rates ``'fused'``.

The JAX module's ``pallas`` section (``pallas_profile``,
``PALLAS_PROFILE_DEFAULTS``) chooses by size between its Pallas kernels
and XLA on the TPU. It has no counterpart here: the port launches its
kernels on every card tensor at every size, and its plain versions run
only on CPU tensors.
"""

from __future__ import annotations

import json
import os
from typing import Any, Dict, Optional

import torch

__all__ = [
    'FUSED_PATH_HIDDEN_DTYPES',
    'OPT_IN_PATHS',
    'hidden_dtype_for',
    'RATING_PATHS',
    'load_profiles',
    'preferred_rating_path',
    'record_measurement',
]

#: Paths the profile may choose (both in the f32 parity band).
RATING_PATHS = ('fused', 'materialized')

#: Paths served by the fused fold, mapped to the dtype of their hidden
#: chain (``None``: f32). ``VAEP.rate_batch`` dispatches on membership, so
#: a new narrowed variant cannot fall through to the materialized path.
FUSED_PATH_HIDDEN_DTYPES: Dict[str, Optional[torch.dtype]] = {
    'fused': None,
    'fused_bf16': torch.bfloat16,
}

#: Paths only the env override selects: every narrowed fused variant, whose
#: values lie outside the f32 parity band.
OPT_IN_PATHS = tuple(path for path, dt in FUSED_PATH_HIDDEN_DTYPES.items() if dt is not None)

_ENV_OVERRIDE = 'SOCCERACTION_TPU_RATING_PATH'
_PROFILE_FILE = os.path.join(os.path.dirname(__file__), 'platform_profiles.json')
_DEFAULT_PATH = 'fused'

# parsed profiles by file: rate_batch asks for its path on every call, so
# the file is read once per process; record_measurement refreshes it
_cache: Dict[str, Dict[str, Any]] = {}


def load_profiles(path: Optional[str] = None) -> Dict[str, Any]:
    """The parsed profile file (``{'platforms': {name: entry}}``), cached."""
    path = path or _PROFILE_FILE
    cached = _cache.get(path)
    if cached is None:
        with open(path) as f:
            cached = _cache[path] = json.load(f)
    return cached


def hidden_dtype_for(path: str) -> Optional[torch.dtype]:
    """The hidden chain's dtype on ``path`` (``None``: f32). Raises
    ``KeyError`` for a path outside :data:`FUSED_PATH_HIDDEN_DTYPES`."""
    return FUSED_PATH_HIDDEN_DTYPES[path]


def preferred_rating_path(platform: str, *, respect_env: bool = True) -> str:
    """The rating path for a model on ``platform``.

    Resolution order:

    1. ``SOCCERACTION_TPU_RATING_PATH``: ``'fused'``, ``'materialized'``
       or the opt-in ``'fused_bf16'`` forces that path; ``'auto'`` or
       unset defers to the profile; anything else raises ``ValueError``.
       Skipped with ``respect_env=False``.
    2. The profile's entry for ``platform``; an entry naming a path
       outside :data:`RATING_PATHS` raises ``ValueError``.
    3. ``'fused'`` for a platform without an entry, or when the profile
       file is missing or unreadable.
    """
    if respect_env:
        override = os.environ.get(_ENV_OVERRIDE, 'auto').strip().lower() or 'auto'
        if override != 'auto':
            if override not in RATING_PATHS + OPT_IN_PATHS:
                raise ValueError(
                    f'{_ENV_OVERRIDE}={override!r}: expected one of '
                    f"{RATING_PATHS + OPT_IN_PATHS + ('auto',)}"
                )
            return override
    try:
        entry = load_profiles().get('platforms', {}).get(platform)
    except (OSError, ValueError):
        _cache[_PROFILE_FILE] = {}  # a missing file is not opened again per call
        return _DEFAULT_PATH
    if entry is None:
        return _DEFAULT_PATH
    path = entry['rating_path']
    if path not in RATING_PATHS:
        raise ValueError(
            f'platform_profiles.json: invalid rating_path {path!r} for platform {platform!r}'
        )
    return path


def record_measurement(
    platform: str,
    fused_actions_per_sec: float,
    materialized_actions_per_sec: float,
    source: str,
    device_kind: Optional[str] = None,
    path: Optional[str] = None,
) -> Dict[str, Any]:
    """Write ``platform``'s entry from a reading of both paths.

    The winner is derived from the two rates, so an entry always traces
    back to a measurement; ``source`` names the run it came from and
    ``device_kind`` the card (name and power limit). Returns the entry.
    """
    profile_path = path or _PROFILE_FILE
    try:
        with open(profile_path) as f:  # bypass and refresh the parse cache
            profiles = json.load(f)
    except FileNotFoundError:
        profiles = {'platforms': {}}
    entry: Dict[str, Any] = {
        'rating_path': (
            'fused' if fused_actions_per_sec >= materialized_actions_per_sec else 'materialized'
        ),
        'fused_actions_per_sec': float(fused_actions_per_sec),
        'materialized_actions_per_sec': float(materialized_actions_per_sec),
        'source': source,
    }
    if device_kind is not None:
        entry['device_kind'] = device_kind
    profiles.setdefault('platforms', {})[platform] = entry
    with open(profile_path, 'w') as f:
        json.dump(profiles, f, indent=1, sort_keys=True)
        f.write('\n')
    _cache[profile_path] = profiles
    return entry
