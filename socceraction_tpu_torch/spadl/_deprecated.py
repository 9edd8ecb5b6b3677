"""Deprecated re-export shims for the ``spadl`` provider modules.

The reference re-exports each provider's loader and schemas from its SPADL
converter module with a :class:`DeprecationWarning` (e.g.
``socceraction/spadl/statsbomb.py:325-413``) so pre-1.2 imports like
``from socceraction.spadl.statsbomb import StatsBombLoader`` keep working.
This module provides one factory that gives a converter module a PEP 562
``__getattr__`` doing the same: the named symbols resolve lazily from the
corresponding ``socceraction_tpu_torch.data`` subpackage, with the same warning.
A name whose subpackage is not ported yet raises :class:`ImportError`
naming the missing module.

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
            try:
                module = importlib.import_module(data_module)
            except ModuleNotFoundError as err:
                if err.name != data_module:
                    raise
                raise ImportError(
                    f'{spadl_module}.{name} forwards to {data_module}, which '
                    'socceraction_tpu_torch does not have yet (ROADMAP.md, A8 item 4: '
                    'the data/ loaders)',
                    name=data_module,
                ) from None
            return getattr(module, name)
        raise AttributeError(
            f'module {spadl_module!r} has no attribute {name!r}'
        )

    return __getattr__
