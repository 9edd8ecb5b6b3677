"""mfu (%, host clock): the model's FLOPs of the calls after the profiler stopped
over their wall time, against the card's dense TF32 peak (cardbench.yardstick)."""

from cardbench.readers import mfu as read  # noqa: F401
