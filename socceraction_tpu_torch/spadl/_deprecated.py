"""Deprecated re-export shims for the ``spadl`` provider modules.

The reference re-exports each provider's loader and schemas from its SPADL
converter module with a :class:`DeprecationWarning` (e.g.
``socceraction/spadl/statsbomb.py:325-413``) so pre-1.2 imports like
``from socceraction.spadl.statsbomb import StatsBombLoader`` keep working.
This module provides one factory that gives a converter module a PEP 562
``__getattr__`` doing the same: the named symbols resolve lazily from the
corresponding ``socceraction_tpu_torch.data`` subpackage, with the same warning.

Port of ``socceraction_tpu/spadl/_deprecated.py``.
"""

from __future__ import annotations

import importlib
import warnings
from typing import Any, Callable, Tuple


def deprecated_reexports(
    spadl_module: str, data_module: str, names: Tuple[str, ...]
) -> Callable[[str], Any]:
    """Build a module ``__getattr__`` forwarding ``names`` to ``data_module``.

    Parameters
    ----------
    spadl_module : str
        Fully qualified name of the converter module (for the warning text).
    data_module : str
        Fully qualified name of the data subpackage the names live in now.
    names : tuple of str
        The deprecated public names to forward.

    Returns
    -------
    callable
        A ``__getattr__(name)`` implementation for the converter module.
    """

    def __getattr__(name: str) -> Any:
        if name in names:
            warnings.warn(
                f'{spadl_module}.{name} is deprecated, '
                f'use {data_module}.{name} instead',
                DeprecationWarning,
                stacklevel=2,
            )
            return getattr(importlib.import_module(data_module), name)
        raise AttributeError(
            f'module {spadl_module!r} has no attribute {name!r}'
        )

    return __getattr__
