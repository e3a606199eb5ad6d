"""he_mult_per_s: homomorphic multiplies completed per second of the
window, which ends on a synchronise."""

from hebench.readers import rate


def read(run):
    return rate(run, "mult")
