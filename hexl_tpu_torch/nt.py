"""Host-side number theory for hexl_tpu_torch.

The port's own copy of `hexl_tpu/nt.py`: primes, primitive roots, inverses
and Barrett/Shoup factors in exact Python integers. Everything here runs
on the host, once per (N, q) plan. As in the JAX package, `is_prime`,
`generate_primes` and `minimal_primitive_root` ask the host library
(`native.py`, built with g++) first; their Python bodies are the plain
versions, taken with HEXL_TPU_DISABLE_NATIVE set, and give the same
answers.
"""

from __future__ import annotations

import random
from typing import List

from . import native

U64_MAX = (1 << 64) - 1

# Deterministic Miller-Rabin witnesses: sufficient for all n < 2^64.
_MR_WITNESSES = (2, 3, 5, 7, 11, 13, 17, 19, 23, 29, 31, 37)


def is_power_of_two(n: int) -> bool:
    return n > 0 and (n & (n - 1)) == 0


def log2_exact(n: int) -> int:
    if not is_power_of_two(n):
        raise ValueError(f"{n} is not a power of two")
    return n.bit_length() - 1


def maximum_value(bits: int) -> int:
    """Largest value representable in `bits` bits."""
    if bits > 64:
        raise ValueError("bits must be <= 64")
    return (1 << bits) - 1


def reverse_bits(x: int, bit_width: int) -> int:
    """Bit-reverse x within bit_width bits."""
    out = 0
    for _ in range(bit_width):
        out = (out << 1) | (x & 1)
        x >>= 1
    return out


def pow_mod(base: int, exp: int, modulus: int) -> int:
    return pow(base, exp, modulus)


def inverse_mod(x: int, modulus: int) -> int:
    """x^-1 mod modulus; requires gcd(x, modulus) == 1."""
    if x % modulus == 0:
        raise ValueError(f"{x} has no inverse mod {modulus}")
    return pow(x, -1, modulus)


def multiply_mod(x: int, y: int, modulus: int) -> int:
    return (x * y) % modulus


def add_uint_mod(x: int, y: int, modulus: int) -> int:
    return (x + y) % modulus


def sub_uint_mod(x: int, y: int, modulus: int) -> int:
    return (x - y) % modulus


def is_prime(n: int) -> bool:
    """Deterministic Miller-Rabin for n < 2^64."""
    if 2 <= n < (1 << 64):
        got = native.is_prime(n)
        if got is not None:
            return got
    if n < 2:
        return False
    for a in _MR_WITNESSES:
        if n == a:
            return True
        if n % a == 0:
            return False
    d = n - 1
    r = 0
    while d % 2 == 0:
        d //= 2
        r += 1
    for a in _MR_WITNESSES:
        x = pow(a, d, n)
        if x == 1 or x == n - 1:
            continue
        for _ in range(r - 1):
            x = pow(x, 2, n)
            if x == n - 1:
                break
        else:
            return False
    return True


def generate_primes(num_primes: int, bit_size: int,
                    prefer_small_primes: bool = True,
                    ntt_size: int = 1) -> List[int]:
    """Primes q in (2^bit_size, 2^(bit_size+1)) with q = 1 mod 2*ntt_size.

    prefer_small scans upward from 2^bit_size + 1; otherwise downward from
    the largest candidate = 1 mod 2*ntt_size below 2^(bit_size+1).
    """
    if num_primes <= 0:
        raise ValueError("num_primes must be positive")
    if not is_power_of_two(ntt_size):
        raise ValueError("ntt_size must be a power of two")
    if log2_exact(ntt_size) >= bit_size:
        raise ValueError("log2(ntt_size) must be < bit_size")
    fast = native.generate_primes(num_primes, bit_size, prefer_small_primes,
                                  ntt_size)
    if fast is not None:
        return fast
    lower = (1 << bit_size) + 1
    upper = (1 << (bit_size + 1)) - 1
    step = 2 * ntt_size
    if prefer_small_primes:
        candidate, step_signed = lower, step
    else:
        candidate, step_signed = upper - (upper % step) + 1, -step
    out: List[int] = []
    while lower <= candidate <= upper:
        if is_prime(candidate):
            out.append(candidate)
            if len(out) == num_primes:
                return out
        candidate += step_signed
    raise RuntimeError(
        f"failed to find {num_primes} primes of {bit_size} bits "
        f"with q % {2 * ntt_size} == 1")


def is_primitive_root(root: int, degree: int, modulus: int) -> bool:
    """True iff root is a primitive degree-th root of unity mod modulus
    (degree a power of two, so root^(degree/2) == -1 suffices)."""
    if root == 0:
        return False
    if not is_power_of_two(degree):
        raise ValueError("degree must be a power of two")
    return pow(root, degree // 2, modulus) == modulus - 1


def generate_primitive_root(degree: int, modulus: int, seed: int = 0) -> int:
    """Find some primitive degree-th root of unity mod modulus."""
    quotient = (modulus - 1) // degree
    rng = random.Random(seed ^ modulus ^ degree)
    for _ in range(200):
        root = pow(rng.randrange(1, modulus), quotient, modulus)
        if is_primitive_root(root, degree, modulus):
            return root
    raise RuntimeError(f"no primitive root for degree {degree} mod {modulus}")


def minimal_primitive_root(degree: int, modulus: int) -> int:
    """The smallest primitive degree-th root of unity mod modulus.

    All primitive roots are odd powers of any one of them; scanning them
    and taking the minimum makes the choice deterministic.
    """
    fast = native.minimal_primitive_root(degree, modulus)
    if fast is not None:
        return fast
    root = generate_primitive_root(degree, modulus)
    root_sq = (root * root) % modulus
    current = best = root
    for _ in range(degree):
        best = min(best, current)
        current = (current * root_sq) % modulus
    return best


def barrett_factor(operand: int, bit_shift: int, modulus: int) -> int:
    """floor((operand << bit_shift) / modulus), the Shoup/Barrett precompute.

    bit_shift is 32, 52 or 64; operand=1 gives the plain Barrett constant.
    """
    if operand > modulus:
        raise ValueError("operand must be <= modulus")
    if bit_shift not in (32, 52, 64):
        raise ValueError("bit_shift must be 32, 52 or 64")
    return ((operand << bit_shift) // modulus) & U64_MAX


def multiply_mod_lazy(x: int, y: int, y_barrett: int, modulus: int,
                      bit_shift: int = 64) -> int:
    """Shoup multiplication: (x*y) mod q with output in [0, 2q).

    q_hat = floor(x * y_barrett / 2^bit_shift); result = x*y - q_hat*q in
    64-bit wraparound arithmetic."""
    q_hat = (x * y_barrett) >> bit_shift
    return (x * y - q_hat * modulus) & U64_MAX


def barrett_reduce_64(x: int, modulus: int, q_barr: int,
                      output_mod_factor: int = 1) -> int:
    """x mod q via the 64-bit Barrett constant q_barr = floor(2^64/q);
    output_mod_factor=2 leaves the result in [0, 2q)."""
    q_hat = (x * q_barr) >> 64
    r = (x - q_hat * modulus) & U64_MAX
    if output_mod_factor == 2:
        return r
    return r - modulus if r >= modulus else r


def reduce_mod(x: int, modulus: int, input_mod_factor: int) -> int:
    """x mod q given x < input_mod_factor * q, by conditional subtraction."""
    if input_mod_factor not in (1, 2, 4, 8):
        raise ValueError("input_mod_factor must be 1, 2, 4 or 8")
    if input_mod_factor >= 8 and x >= 4 * modulus:
        x -= 4 * modulus
    if input_mod_factor >= 4 and x >= 2 * modulus:
        x -= 2 * modulus
    if input_mod_factor >= 2 and x >= modulus:
        x -= modulus
    return x


def hensel_lemma_2adic_root(r: int, q: int) -> int:
    """x in [0, 2^r) with q*x = -1 mod 2^r (the Montgomery constant)."""
    if q % 2 == 0:
        raise ValueError("q must be odd")
    return (-pow(q, -1, 1 << r)) % (1 << r)


def montgomery_reduce(t: int, q: int, r: int, inv_mod: int) -> int:
    """REDC: t * R^-1 mod q for R = 2^r, given t in [0, R*q) and
    q*inv_mod = -1 mod R."""
    mask = (1 << r) - 1
    m = ((t & mask) * inv_mod) & mask
    s = (t + m * q) >> r
    return s - q if s >= q else s


def barrett_mult_constants(modulus: int) -> tuple:
    """(mu, shift) of the single-mulhi Barrett multiply for q < 2^62:
    mu = floor(2^(bits(q)+62) / q), shift = bits(q) - 2."""
    if not 2 <= modulus < (1 << 62):
        raise ValueError("modulus must be in [2, 2^62)")
    n_bits = modulus.bit_length()
    return (1 << (n_bits + 62)) // modulus, n_bits - 2
