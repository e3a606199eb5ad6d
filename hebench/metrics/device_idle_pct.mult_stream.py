"""device_idle_pct.mult_stream: share of the untraced window with no device
operation running: the traced busy time a call over the untraced window's
time a call."""

from hebench.readers import device_idle_pct as read  # noqa: F401
