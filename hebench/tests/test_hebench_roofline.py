"""The roofline counts, pinned at small shapes, and the least time."""

from __future__ import annotations

import pytest

from hebench import roofline
from hebench.roofline import he_mult, ntt_pair

H100 = "NVIDIA H100 80GB HBM3"


def test_he_mult_counts():
    # N = 8, ds = 2, kms = 3, kc = 2: dyadic 4 + 3 words a prime (x ds),
    # key switch 3 ds in, ds kc kms keys, kc ds out; transforms ds + ds^2
    # + kc + ds kc = 12 of (8/2) * 3 = 12 products; products 4 ds +
    # (ds + 1) ds kc + ds kc = 24 a coefficient.
    c = he_mult.counts(n=8, ds=2, kms=3, kc=2)
    assert c["limb_transforms"] == 12
    assert c["bytes"] == 8 * 8 * (7 * 2 + 3 * 2 + 2 * 2 * 3 + 2 * 2)
    assert c["products"] == 24 * 8 + 12 * 12


def test_he_mult_counts_at_the_top_level_of_n32768():
    c = he_mult.counts(n=32768, ds=15, kms=16, kc=2)
    assert c["limb_transforms"] == 272
    assert c["bytes"] == 173015040


def test_ntt_pair_counts():
    c = ntt_pair.counts(n=16, rows=3, polys=2)
    assert c == {"bytes": 4 * 8 * 6 * 16, "products": 2 * 6 * 8 * 4,
                 "limb_transforms": 12}


def test_least_time_takes_the_larger_bound():
    peaks = roofline.PEAKS["devices"][H100]
    rate = peaks["sms"] * peaks["imads_per_sm_per_clock"] \
        * peaks["sm_clock_hz"]
    t, by = roofline.least_time({"bytes": 3.35e12, "products": 0}, H100)
    assert (t, by) == (pytest.approx(1.0), "bytes")
    products = 2 * rate / roofline.PEAKS["imads_per_product"]
    t, by = roofline.least_time({"bytes": 3.35e12, "products": products},
                                H100)
    assert (t, by) == (pytest.approx(2.0), "operations")
    assert roofline.least_time({"bytes": 1, "products": 1}, "cpu") is None
