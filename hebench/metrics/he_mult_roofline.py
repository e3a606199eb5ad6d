"""he_mult_roofline: a multiply's least time (`roofline/he_mult.py`) over
its device kernel time in the traced window, in %."""

from hebench.readers import roofline_pct as read  # noqa: F401
