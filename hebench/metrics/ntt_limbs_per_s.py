"""ntt_limbs_per_s: limb pairs (one N-coefficient residue polynomial
transformed forward and back) completed per second of the window."""

from hebench.readers import rate


def read(run):
    return rate(run, "limb pair")
