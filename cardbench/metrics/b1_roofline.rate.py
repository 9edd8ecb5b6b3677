"""b1_roofline (%, device trace): B1's least time on the traced calls' valid
actions (cardbench.yardstick) over its device time in the trace."""

from cardbench.readers import b1_roofline as read  # noqa: F401
