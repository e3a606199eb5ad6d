"""ntt_pair_roofline: a forward-and-inverse call pair's least time
(`roofline/ntt_pair.py`) over its device kernel time in the traced
window, in %."""

from hebench.readers import roofline_pct as read  # noqa: F401
