"""Counts of one homomorphic multiply of a CKKS chain's cycle of levels:
the mean over the cycle of `roofline/he_mult.py::counts` at each level ds,
with kms = ds + 1, since a switch at level ds reads ds + 1 of each key
component's rows (the first ds and the key prime's)."""

from hebench.roofline import he_mult


def counts(n: int, levels, kc: int) -> dict:
    each = [he_mult.counts(n, d, d + 1, kc) for d in levels]
    return {name: sum(c[name] for c in each) / len(each) for name in each[0]}
