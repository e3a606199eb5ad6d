"""Example app of the PyTorch/CUDA port: the mini-programs of
`examples/example.py` (one per public op, parity with the reference's
example/example.cpp:146-157, and the end-to-end RNS poly-mult pipeline) on
`hexl_tpu_torch`, each checked against the port's NumPy oracle
`hexl_tpu_torch.ref`. Four more programs reach the routes the JAX
example's shapes do not (a batch of small transforms, the single-word
transform of q < 2^30, the fused polynomial product and the FFT-like above
2^13), and the last runs the RNS product sharded over a mesh of two
positions of one device, against the single-device product.

Run:  python examples/example_torch.py                 (on the GPU)
      python examples/example_torch.py --device cpu    (the plain versions)
"""

import argparse
import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))

import numpy as np

from hexl_tpu_torch import (NTT, FFTLike, RnsNTT, dyadic_multiply,
                            eltwise_add_mod, eltwise_cmp_add,
                            eltwise_cmp_sub_mod, eltwise_fma_mod,
                            eltwise_mult_mod, eltwise_reduce_mod,
                            eltwise_sub_mod, key_switch, nt, poly_mult_mod,
                            ref, rns_poly_mult_mod)


def check_equal(got, expected, what):
    np.testing.assert_array_equal(np.asarray(got),
                                  np.asarray(expected, dtype=np.uint64))
    print(f"Done running {what}")


def ref_tables(n, q):
    """(rop, prop, irop, pirop) of the minimal root, from the oracle."""
    rop, irop, _ = ref.root_of_unity_powers(n, q)
    return rop, ref.precon64(rop, q), irop, ref.precon64(irop, q)


def ref_fwd(x, q):
    rop, prop, _, _ = ref_tables(x.shape[-1], q)
    return ref.fwd_ntt_radix2(x, q, rop, prop)


def ref_inv(y, q):
    _, _, irop, pirop = ref_tables(y.shape[-1], q)
    return ref.inv_ntt_radix2(y, q, irop, pirop)


def ref_poly_mult(a, b, q):
    """The negacyclic product through the oracle's transforms."""
    return ref_inv(ref.eltwise_mult_mod(ref_fwd(a, q), ref_fwd(b, q), q), q)


def example_add_mod(device):
    q = 10
    # q=10 isn't prime: eltwise ops only need q > 1, like the reference.
    a = np.array([1, 2, 3, 4, 5, 6, 7, 8], dtype=np.uint64)
    b = np.array([1, 3, 5, 7, 9, 2, 4, 6], dtype=np.uint64)
    check_equal(eltwise_add_mod(a, b, q, device=device),
                ref.eltwise_add_mod(a, b, q), "ExampleAddMod")


def example_add_mod_scalar(device):
    q = 10
    a = np.array([1, 2, 3, 4, 5, 6, 7, 8], dtype=np.uint64)
    check_equal(eltwise_add_mod(a, 3, q, device=device),
                ref.eltwise_add_mod(a, 3, q), "ExampleAddModScalar")


def example_sub_mod(device):
    q = 10
    a = np.array([1, 2, 3, 4, 5, 6, 7, 8], dtype=np.uint64)
    b = np.array([1, 3, 5, 7, 2, 2, 2, 2], dtype=np.uint64)
    check_equal(eltwise_sub_mod(a, b, q, device=device),
                ref.eltwise_sub_mod(a, b, q), "ExampleSubMod")


def example_cmp_add(device):
    a = np.arange(1, 9, dtype=np.uint64)
    check_equal(eltwise_cmp_add(a, "true", 0, 10, device=device),
                ref.eltwise_cmp_add(a, "true", 0, 10), "ExampleCmpAdd")


def example_cmp_sub_mod(device):
    q = 10
    a = np.arange(1, 9, dtype=np.uint64)
    check_equal(eltwise_cmp_sub_mod(a, q, "nle", 4, 5, device=device),
                ref.eltwise_cmp_sub_mod(a, q, "nle", 4, 5),
                "ExampleCmpSubMod")


def example_fma_mod(device):
    q = 101
    a = np.arange(1, 9, dtype=np.uint64)
    c = np.arange(9, 17, dtype=np.uint64)
    check_equal(eltwise_fma_mod(a, 3, c, q, 1, device=device),
                ref.eltwise_fma_mod(a, 3, c, q, 1), "ExampleFMAMod")


def example_mult_mod(device):
    q = 769
    a = np.arange(1, 9, dtype=np.uint64)
    b = np.arange(11, 19, dtype=np.uint64)
    check_equal(eltwise_mult_mod(a, b, q, 1, device=device),
                ref.eltwise_mult_mod(a, b, q, 1), "ExampleMultMod")


def example_reduce_mod(device):
    q = 0xFFFFFFFFFFC0001
    a = np.array([q + 1, 2 * q + 2, 3 * q + 3, 0, 5, q - 1], dtype=np.uint64)
    check_equal(eltwise_reduce_mod(a, q, q, 1, device=device),
                ref.eltwise_reduce_mod(a, q, q, 1), "ExampleReduceMod")


def example_ntt(device):
    n = 4096
    q = nt.generate_primes(1, 50, True, ntt_size=n)[0]
    ntt = NTT(n, q, device=device)
    rng = np.random.default_rng(0)
    x = rng.integers(0, q, size=n, dtype=np.uint64)
    y = ntt.forward(x, 1, 1)
    np.testing.assert_array_equal(y, ref_fwd(x, q))
    back = ntt.inverse(y, 1, 1)
    check_equal(back, x, "ExampleNTT (roundtrip)")


def example_poly_mult_pipeline(device):
    """RNS polynomial multiply: per-prime FwdNTT -> mult-mod -> InvNTT."""
    n = 4096
    num_primes = 4
    primes = nt.generate_primes(num_primes, 45, True, ntt_size=n)
    rng = np.random.default_rng(1)
    a = rng.integers(0, min(primes), size=n, dtype=np.uint64)
    b = rng.integers(0, min(primes), size=n, dtype=np.uint64)
    for q in primes:
        ntt = NTT(n, q, device=device)
        fa = ntt.forward(a % np.uint64(q), 1, 1)
        fb = ntt.forward(b % np.uint64(q), 1, 1)
        c = ntt.inverse(eltwise_mult_mod(fa, fb, q, device=device), 1, 1)
        np.testing.assert_array_equal(c, ref_poly_mult(a, b, q))
    print("Done running ExamplePolyMultPipeline "
          f"({num_primes} primes x N={n})")


def example_rns_ntt(device):
    """Stacked multi-modulus NTT: one transform over an RNS basis."""
    n, k = 4096, 3
    moduli = nt.generate_primes(k, 45, True, ntt_size=n)
    rns = RnsNTT(n, moduli, device=device)
    rng = np.random.default_rng(5)
    x = np.stack([rng.integers(0, q, n, np.uint64) for q in moduli])
    y = rns.forward(x)
    for i, q in enumerate(moduli):
        np.testing.assert_array_equal(y[i], ref_fwd(x[i], q))
    np.testing.assert_array_equal(rns.inverse(y), x)
    print(f"Done running ExampleRnsNTT ({k} primes stacked, N={n})")


def example_fft_like(device, n=1024):
    """CKKS-style encode/decode with the FFT-like transform."""
    scale = 2.0 ** 40
    fft = FFTLike(n, scale, device=device)
    rng = np.random.default_rng(2)
    x = rng.normal(size=n) + 1j * rng.normal(size=n)
    dec = np.asarray(fft.forward(np.asarray(fft.inverse(x))))
    rel = np.max(np.abs(dec - x)) / np.max(np.abs(x))
    assert rel < 1e-5, rel  # ~1e-15 on f64/double-float paths
    print(f"Done running ExampleFFTLike (n={n}, precision={fft.precision}, "
          f"roundtrip rel err {rel:.1e})")


def example_dyadic_multiply(device):
    """BFV/CKKS ciphertext x ciphertext in NTT form over an RNS basis."""
    n, M = 1024, 2
    moduli = nt.generate_primes(M, 40, True, ntt_size=n)
    rng = np.random.default_rng(3)
    x = np.stack([np.stack([rng.integers(0, q, n, np.uint64)
                            for q in moduli]) for _ in range(2)])
    y = np.stack([np.stack([rng.integers(0, q, n, np.uint64)
                            for q in moduli]) for _ in range(2)])
    out = dyadic_multiply(x, y, moduli, device=device)
    assert out.shape == (3, M, n)
    for m, q in enumerate(moduli):
        mul = lambda u, v: ref.eltwise_mult_mod(u[m], v[m], q)
        np.testing.assert_array_equal(out[0, m], mul(x[0], y[0]))
        np.testing.assert_array_equal(
            out[1, m], ref.eltwise_add_mod(mul(x[0], y[1]), mul(x[1], y[0]),
                                           q))
        np.testing.assert_array_equal(out[2, m], mul(x[1], y[1]))
    print("Done running ExampleDyadicMultiply")


def ref_key_switch(result, t_target, keys, moduli, msf):
    """The CKKS key switch through the oracle's fully reduced transforms
    and eltwise ops: every step is a function of residues, so this is the
    lazy pipeline's result."""
    kc, ds = result.shape[:2]
    qk = moduli[-1]
    t_intt = [ref_inv(t_target[j], moduli[j]) for j in range(ds)]
    tpp = np.zeros((kc, ds + 1, result.shape[-1]), dtype=np.uint64)
    for i, q in enumerate(moduli):
        for j in range(ds):
            t_op = t_target[j] if i == j else ref_fwd(t_intt[j] % np.uint64(q),
                                                      q)
            for k in range(kc):
                tpp[k, i] = ref.eltwise_add_mod(
                    tpp[k, i], ref.eltwise_mult_mod(t_op, keys[j, k, i], q),
                    q)
    half = qk >> 1
    out = result.copy()
    for k in range(kc):
        t_last = ref.eltwise_add_mod(ref_inv(tpp[k, ds], qk), half, qk)
        for i in range(ds):
            qi = moduli[i]
            t_ntt = ref_fwd(ref.eltwise_sub_mod(t_last % np.uint64(qi),
                                                half % qi, qi), qi)
            diff = ref.eltwise_sub_mod(tpp[k, i], t_ntt, qi)
            out[k, i] = ref.eltwise_add_mod(
                out[k, i], ref.eltwise_mult_mod(diff, msf[i], qi), qi)
    return out


def example_key_switch(device):
    """CKKS key switch at a small config (the reference's example has no
    key-switch program; this runs the deepest composite pipeline: stacked
    inverse/forward NTT groups, 128-bit lazy accumulation, mod-down with
    the +qk/2 trick)."""
    n, ds, kc = 1 << 10, 2, 2
    kms = rns = ds + 1
    moduli = nt.generate_primes(kms, 40, True, ntt_size=n)
    qk = moduli[-1]
    rng = np.random.default_rng(5)
    t_target = np.stack([rng.integers(0, q, n, np.uint64)
                         for q in moduli[:ds]])
    keys = rng.integers(0, min(moduli), size=(ds, kc, kms, n),
                        dtype=np.uint64)
    for j in range(ds):
        for k in range(kc):
            for m_i, q in enumerate(moduli):
                keys[j, k, m_i] %= np.uint64(q)
    msf = [nt.inverse_mod(qk % q, q) for q in moduli[:ds]]
    result = np.stack([np.stack([rng.integers(0, q, n, np.uint64)
                                 for q in moduli[:ds]])
                       for _ in range(kc)])
    out = np.asarray(key_switch(result, t_target, n, ds, kms, rns, kc,
                                moduli, keys, msf, device=device))
    for k in range(kc):
        for j in range(ds):
            assert out[k, j].max() < moduli[j], "output not reduced"
    np.testing.assert_array_equal(
        out, ref_key_switch(result, t_target, keys, moduli, msf))
    print(f"Done running ExampleKeySwitch (n={n}, ds={ds}, kc={kc})")


def example_large_degree(device):
    """The two-pass split of degrees above 2^14."""
    n = 1 << 15
    q = nt.generate_primes(1, 60, True, ntt_size=n)[0]
    ntt = NTT(n, q, device=device)
    rng = np.random.default_rng(4)
    x = rng.integers(0, q, size=n, dtype=np.uint64)
    y = ntt.forward(x)
    np.testing.assert_array_equal(y, ref_fwd(x, q))
    np.testing.assert_array_equal(ntt.inverse(y), x)
    print("Done running ExampleLargeDegree (N=2^15)")


def example_small_batch(device):
    """A batch of small transforms, several in one thread block."""
    n, batch = 64, 8
    q = nt.generate_primes(1, 50, True, ntt_size=n)[0]
    ntt = NTT(n, q, device=device)
    rng = np.random.default_rng(6)
    x = rng.integers(0, q, size=(batch, n), dtype=np.uint64)
    y = ntt.forward(x)
    np.testing.assert_array_equal(y, ref_fwd(x, q))
    np.testing.assert_array_equal(ntt.inverse(y), x)
    print(f"Done running ExampleSmallBatch ({batch} x N={n})")


def example_single_word(device):
    """q < 2^30 from N = 1024 on: the single-word transform, whose lazy
    outputs differ from the 64-bit walk's; fully reduced they agree."""
    n = 4096
    q = nt.generate_primes(1, 29, True, ntt_size=n)[0]
    ntt = NTT(n, q, device=device)
    rng = np.random.default_rng(7)
    x = rng.integers(0, q, size=(2, n), dtype=np.uint64)
    y = ntt.forward(x)
    np.testing.assert_array_equal(y, ref_fwd(x, q))
    np.testing.assert_array_equal(ntt.inverse(y), x)
    print("Done running ExampleSingleWord (N=4096, 29-bit q)")


def example_poly_mult_mod(device):
    """The fused negacyclic product (forward, multiply, inverse)."""
    n = 4096
    q = nt.generate_primes(1, 50, True, ntt_size=n)[0]
    rng = np.random.default_rng(8)
    a, b = (rng.integers(0, q, size=(2, n), dtype=np.uint64)
            for _ in range(2))
    check_equal(poly_mult_mod(a, b, n, q, device=device),
                ref_poly_mult(a, b, q), "ExamplePolyMultMod")


def example_dist_rns_poly_mult(device):
    """The RNS product with the coefficients sharded over a mesh of two
    positions of one device, against the single-device product."""
    from hexl_tpu_torch.parallel import dist_rns_poly_mult, make_mesh
    n, k = 4096, 3
    moduli = nt.generate_primes(k, 50, True, ntt_size=n)
    rng = np.random.default_rng(9)
    a, b = (np.stack([rng.integers(0, q, size=(2, n), dtype=np.uint64)
                      for q in moduli]) for _ in range(2))
    mesh = make_mesh(2, 1, [device] * 2)
    got = dist_rns_poly_mult(a, b, n, moduli, mesh)
    np.testing.assert_array_equal(got[0],
                                  ref_poly_mult(a[0], b[0], moduli[0]))
    check_equal(got, rns_poly_mult_mod(a, b, n, moduli, device=device),
                "ExampleDistRnsPolyMult (mesh of 2 positions)")


def main(device):
    example_add_mod(device)
    example_add_mod_scalar(device)
    example_sub_mod(device)
    example_cmp_add(device)
    example_cmp_sub_mod(device)
    example_fma_mod(device)
    example_mult_mod(device)
    example_reduce_mod(device)
    example_ntt(device)
    example_poly_mult_pipeline(device)
    example_rns_ntt(device)
    example_fft_like(device)
    example_dyadic_multiply(device)
    example_key_switch(device)
    example_large_degree(device)
    example_small_batch(device)
    example_single_word(device)
    example_poly_mult_mod(device)
    example_fft_like(device, n=1 << 14)
    example_dist_rns_poly_mult(device)
    print("All examples passed.")


if __name__ == "__main__":
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--device", default="cuda",
                        help="cuda (default) or cpu")
    main(parser.parse_args().device)
