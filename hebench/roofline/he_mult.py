"""Counts of one homomorphic multiply: `dyadic_multiply` of two (2, ds, N)
ciphertexts, then `key_switch` of the (3, ds, N) product at ds
decomposition primes, kms key moduli and kc key components.

Bytes: each public call's inputs read once and outputs written once: the
two ciphertexts and the product (dyadic), the product, the keys (once a
call) and the (kc, ds, N) result (key switch); 8 bytes a residue.
Products: 4 a coefficient of each prime in the dyadic product; (N/2)
log2 N in each limb transform, of which the key switch runs ds (the
target's inverses) + ds * ds (the decomposed target in each of the ds + 1
primes but its own) + kc (the key prime's inverse) + ds * kc (the
mod-down's forwards); (ds + 1) * ds * kc in the products with the keys and
ds * kc in the mod-down's products with qk^-1, each per coefficient."""


def counts(n: int, ds: int, kms: int, kc: int) -> dict:
    log_n = n.bit_length() - 1
    words = (2 * 2 * ds + 3 * ds          # dyadic: two ciphertexts, product
             + 3 * ds + ds * kc * kms + kc * ds) * n   # key switch
    transforms = ds + ds * ds + kc + ds * kc
    products = (4 * ds + (ds + 1) * ds * kc + ds * kc) * n \
        + transforms * (n // 2) * log_n
    return {"bytes": 8 * words, "products": products,
            "limb_transforms": transforms}
