"""Framework constants, copied from ``socceraction_tpu/config.py``.

The values are the reference's (``socceraction/vaep/*.py``,
``socceraction/xthreat.py``, ``socceraction/spadl/base.py``); the port
keeps its own copy so it never imports the JAX package. The compile-cache
setting is the port's counterpart of the JAX package's: there it names
jax's persistent compilation cache, here the directory of the kernels'
shared libraries.
"""

from __future__ import annotations

import os
from typing import Optional

# xT grid
XT_GRID_LENGTH: int = 16  # N: cells along pitch length (x)
XT_GRID_WIDTH: int = 12  # M: cells along pitch width (y)
XT_EPS: float = 1e-5

# VAEP
LABEL_LOOKAHEAD: int = 10
SAMEPHASE_SECONDS: float = 10
PENALTY_PRIOR: float = 0.792453
CORNER_PRIOR: float = 0.046500
NB_PREV_ACTIONS: int = 3

# dribble synthesis (SPADL converters)
MIN_DRIBBLE_LENGTH: float = 3.0
MAX_DRIBBLE_LENGTH: float = 60.0
MAX_DRIBBLE_DURATION: float = 10.0

#: Games are padded along the action axis to a multiple of this. Kept at
#: the JAX package's value so both packages pack a frame to the same
#: ``(G, A)`` shape.
ACTION_AXIS_ALIGNMENT: int = 128

#: Environment variable naming the directory the hand-written kernels'
#: shared libraries are built into and loaded from (the port's compile
#: cache: a warm directory turns ``nvcc`` builds into loads). Unset (the
#: default) keeps the checkout's git-ignored ``build/kernels/``. Read by
#: :func:`compile_cache_dir` at call time, so a child process can start
#: from an empty cache.
COMPILE_CACHE_ENV: str = 'SOCCERACTION_TPU_COMPILE_CACHE'


def compile_cache_dir() -> Optional[str]:
    """The configured kernel build directory, or ``None`` (the default).

    Reads ``SOCCERACTION_TPU_COMPILE_CACHE`` at call time, not at import
    time; an empty value means unset.
    """
    path = os.environ.get(COMPILE_CACHE_ENV, '').strip()
    return path or None
