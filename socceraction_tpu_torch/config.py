"""Framework constants, copied from ``socceraction_tpu/config.py``.

The values are the reference's (``socceraction/vaep/*.py``); the port
keeps its own copy so it never imports the JAX package.
"""

from __future__ import annotations

# VAEP
LABEL_LOOKAHEAD: int = 10
SAMEPHASE_SECONDS: float = 10
PENALTY_PRIOR: float = 0.792453
CORNER_PRIOR: float = 0.046500
NB_PREV_ACTIONS: int = 3

#: Games are padded along the action axis to a multiple of this. Kept at
#: the JAX package's value so both packages pack a frame to the same
#: ``(G, A)`` shape.
ACTION_AXIS_ALIGNMENT: int = 128
