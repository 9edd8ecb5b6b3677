"""idle_share (%, device trace): share of the traced window with no kernel,
copy or memset on the card."""

from cardbench.readers import idle_share as read  # noqa: F401
