"""he_mult_p95_ms: the 95th percentile of the multiplies of the window,
each timed from its issue to its result being ready."""

from hebench.readers import p95_ms


def read(run):
    return p95_ms(run, "mult")
