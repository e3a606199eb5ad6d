"""NumPy uint64 reference kernels: the port's bit-exactness oracle.

The port's own copy of `hexl_tpu/ref.py`, on the port's `nt`: the same 23
functions, signatures and semantics. They mirror the behaviour of the
reference library's native C++ paths (reference: hexl/eltwise/*.cpp,
hexl/ntt/ntt-radix-2.cpp) on the host, in vectorized NumPy uint64
arithmetic with explicit wraparound, including the lazy [0, 2q)/[0, 4q)
output ranges, and define the canonical lazy-reduction algorithm in one
readable place. The port's tests and `examples/example_torch.py` check its
kernels against them.

Everything here is host-side NumPy; nothing runs on a device.
"""

from __future__ import annotations

import numpy as np

from . import nt

_U64 = np.uint64
def _errstate():
    return np.errstate(over="ignore")

# CMPINT predicates (reference: hexl/include/hexl/util/util.hpp:16-25)
CMP_EQ = "eq"
CMP_LT = "lt"
CMP_LE = "le"
CMP_FALSE = "false"
CMP_NE = "ne"
CMP_NLT = "nlt"  # >=
CMP_NLE = "nle"  # >
CMP_TRUE = "true"

ALL_CMPS = (CMP_EQ, CMP_LT, CMP_LE, CMP_FALSE, CMP_NE, CMP_NLT, CMP_NLE,
            CMP_TRUE)


def _as_u64(x) -> np.ndarray:
    a = np.asarray(x)
    if a.dtype != np.uint64:
        a = a.astype(np.uint64)
    return a


def compare(cmp: str, a: np.ndarray, bound: int) -> np.ndarray:
    b = _U64(bound)
    if cmp == CMP_EQ:
        return a == b
    if cmp == CMP_LT:
        return a < b
    if cmp == CMP_LE:
        return a <= b
    if cmp == CMP_FALSE:
        return np.zeros(a.shape, dtype=bool)
    if cmp == CMP_NE:
        return a != b
    if cmp == CMP_NLT:
        return a >= b
    if cmp == CMP_NLE:
        return a > b
    if cmp == CMP_TRUE:
        return np.ones(a.shape, dtype=bool)
    raise ValueError(f"unknown cmp {cmp!r}")


# ---------------------------------------------------------------------------
# 64-bit wide arithmetic helpers (exact, vectorized)
# ---------------------------------------------------------------------------

_MASK32 = _U64(0xFFFFFFFF)
_SH32 = _U64(32)


def mulhi64(a: np.ndarray, b: np.ndarray) -> np.ndarray:
    """High 64 bits of the 128-bit product, via 32-bit partial products."""
    with _errstate():
        a0 = a & _MASK32
        a1 = a >> _SH32
        b0 = b & _MASK32
        b1 = b >> _SH32
        lo_lo = a0 * b0
        hi_lo = a1 * b0
        lo_hi = a0 * b1
        hi_hi = a1 * b1
        cross = (lo_lo >> _SH32) + (hi_lo & _MASK32) + (lo_hi & _MASK32)
        return hi_hi + (hi_lo >> _SH32) + (lo_hi >> _SH32) + (cross >> _SH32)


def mullo64(a: np.ndarray, b: np.ndarray) -> np.ndarray:
    with _errstate():
        return a * b


def reduce_mod_lazy(x: np.ndarray, modulus: int, input_mod_factor: int
                    ) -> np.ndarray:
    """x mod q for x < input_mod_factor*q via conditional subtraction."""
    q = _U64(modulus)
    with _errstate():
        if input_mod_factor >= 8:
            x = np.where(x >= _U64(4 * modulus), x - _U64(4 * modulus), x)
        if input_mod_factor >= 4:
            x = np.where(x >= _U64(2 * modulus), x - _U64(2 * modulus), x)
        if input_mod_factor >= 2:
            x = np.where(x >= q, x - q, x)
    return x


def multiply_mod_lazy(x: np.ndarray, w: int, w_precon: int, modulus: int
                      ) -> np.ndarray:
    """Shoup multiply: (x * w) mod q with output in [0, 2q).

    w_precon = floor(w << 64 / q). Matches MultiplyModLazy<64>
    (reference: hexl/include/hexl/number-theory/number-theory.hpp:127-146).
    """
    with _errstate():
        q_hat = mulhi64(x, np.broadcast_to(_U64(w_precon), x.shape))
        return x * _U64(w) - q_hat * _U64(modulus)


def barrett_reduce_64(x: np.ndarray, modulus: int, q_barr: int,
                      output_mod_factor: int = 1) -> np.ndarray:
    """x mod q via q_barr = floor(2^64/q); OMF=2 leaves result in [0,2q)."""
    with _errstate():
        q_hat = mulhi64(x, np.broadcast_to(_U64(q_barr), x.shape))
        r = x - q_hat * _U64(modulus)
    if output_mod_factor == 1:
        r = np.where(r >= _U64(modulus), r - _U64(modulus), r)
    return r


# ---------------------------------------------------------------------------
# Element-wise ops (reference: hexl/eltwise/)
# ---------------------------------------------------------------------------

def eltwise_add_mod(a, b, modulus: int) -> np.ndarray:
    """(a + b) mod q elementwise; b is an array or scalar; inputs < q."""
    a = _as_u64(a)
    q = _U64(modulus)
    with _errstate():
        if np.isscalar(b) or getattr(b, "ndim", 1) == 0:
            s = a + _U64(int(b))
        else:
            s = a + _as_u64(b)
        return np.where(s >= q, s - q, s)


def eltwise_sub_mod(a, b, modulus: int) -> np.ndarray:
    """(a - b) mod q elementwise; b is an array or scalar; inputs < q."""
    a = _as_u64(a)
    q = _U64(modulus)
    with _errstate():
        if np.isscalar(b) or getattr(b, "ndim", 1) == 0:
            d = a + q - _U64(int(b))
        else:
            d = a + q - _as_u64(b)
        return np.where(d >= q, d - q, d)


def eltwise_mult_mod(a, b, modulus: int, input_mod_factor: int = 1
                     ) -> np.ndarray:
    """(a * b) mod q; inputs < input_mod_factor*q, IMF in {1,2,4}.

    Exact via Python big-int (object) math — this is the oracle.
    """
    if input_mod_factor not in (1, 2, 4):
        raise ValueError("input_mod_factor must be 1, 2 or 4")
    ao = _as_u64(a).astype(object)
    bo = _as_u64(b).astype(object)
    return ((ao * bo) % modulus).astype(np.uint64)


def eltwise_fma_mod(arg1, arg2: int, arg3, modulus: int,
                    input_mod_factor: int = 1) -> np.ndarray:
    """(arg1 * arg2 + arg3) mod q; arg3 may be None.

    All of arg1, arg2, arg3 < input_mod_factor*q, IMF in {1,2,4,8};
    q < 2^61 (reference: hexl/eltwise/eltwise-fma-mod.cpp:17-101).
    """
    if input_mod_factor not in (1, 2, 4, 8):
        raise ValueError("input_mod_factor must be 1, 2, 4 or 8")
    a1 = reduce_mod_lazy(_as_u64(arg1), modulus, input_mod_factor)
    a2 = nt.reduce_mod(int(arg2), modulus, input_mod_factor)
    prod = (a1.astype(object) * a2) % modulus
    if arg3 is not None:
        a3 = reduce_mod_lazy(_as_u64(arg3), modulus, input_mod_factor)
        prod = (prod + a3.astype(object)) % modulus
    return prod.astype(np.uint64)


def eltwise_reduce_mod(a, modulus: int, input_mod_factor: int,
                       output_mod_factor: int) -> np.ndarray:
    """Range-change op (reference: hexl/eltwise/eltwise-reduce-mod.cpp).

    input_mod_factor is 2, 4, or the modulus itself (meaning: arbitrary
    uint64 input, full Barrett); output_mod_factor is 1 or 2. The
    (IMF=4, OMF=2) case reduces [0,4q) -> [0,2q).
    """
    a = _as_u64(a)
    q = _U64(modulus)
    if output_mod_factor not in (1, 2):
        raise ValueError("output_mod_factor must be 1 or 2")
    if input_mod_factor == output_mod_factor:
        return a.copy()
    if input_mod_factor == modulus:
        q_barr = nt.barrett_factor(1, 64, modulus)
        red = barrett_reduce_64(a, modulus, q_barr, output_mod_factor)
        return np.where(a >= q, red, a)
    if input_mod_factor == 2:
        return reduce_mod_lazy(a, modulus, 2)
    if input_mod_factor == 4:
        if output_mod_factor == 1:
            return reduce_mod_lazy(a, modulus, 4)
        return reduce_mod_lazy(a, 2 * modulus, 2)
    raise ValueError("input_mod_factor must be 2, 4, or == modulus")


def eltwise_cmp_add(a, cmp: str, bound: int, diff: int) -> np.ndarray:
    """result = cmp(a, bound) ? a + diff : a (no modular reduction)."""
    a = _as_u64(a)
    with _errstate():
        return np.where(compare(cmp, a, bound), a + _U64(diff), a)


def eltwise_cmp_sub_mod(a, modulus: int, cmp: str, bound: int, diff: int
                        ) -> np.ndarray:
    """result = cmp(a, bound) ? (a mod q - diff) mod q : a mod q.

    The predicate is evaluated on the *unreduced* input; diff < q
    (reference: hexl/eltwise/eltwise-cmp-sub-mod.cpp native loop).
    """
    a = _as_u64(a)
    q = _U64(modulus)
    mask = compare(cmp, a, bound)
    op = a % q
    with _errstate():
        sub = op + q - _U64(diff)
        sub = np.where(sub >= q, sub - q, sub)
    return np.where(mask, sub, op)


# ---------------------------------------------------------------------------
# Negacyclic NTT over Z_q[X]/(X^N + 1) — radix-2 Harvey lazy form
# (reference: hexl/ntt/ntt-radix-2.cpp, hexl/ntt/ntt-default.hpp)
# ---------------------------------------------------------------------------

def root_of_unity_powers(n: int, modulus: int, root: int | None = None):
    """Twiddle tables exactly as the reference NTT engine lays them out.

    Returns (rop, irop, root) where
      rop[bit_reverse(i, log2 n)] = w^i             (forward table)
      irop = stage-major reordering of w^{-i} at bit-reversed index
             (inverse table; walked sequentially by the inverse transform)
    (reference: hexl/ntt/ntt-internal.cpp:54-169)
    """
    if root is None:
        root = nt.minimal_primitive_root(2 * n, modulus)
    bits = nt.log2_exact(n)
    rop = np.zeros(n, dtype=np.uint64)
    irop_raw = np.zeros(n, dtype=np.uint64)
    root_inv = nt.inverse_mod(root, modulus)
    power = 1
    inv_power = 1  # (w^i)^{-1} == (w^{-1})^i — one inversion total
    for i in range(n):
        idx = nt.reverse_bits(i, bits)
        rop[idx] = power
        irop_raw[idx] = inv_power
        power = (power * root) % modulus
        inv_power = (inv_power * root_inv) % modulus
    # Stage-major reorder of the inverse table.
    irop = np.zeros(n, dtype=np.uint64)
    irop[0] = irop_raw[0]
    idx = 1
    m = n >> 1
    while m > 0:
        irop[idx:idx + m] = irop_raw[m:2 * m]
        idx += m
        m >>= 1
    return rop, irop, root


def precon64(values: np.ndarray, modulus: int) -> np.ndarray:
    """floor(v << 64 / q) for each table entry (Shoup preconditioning)."""
    return np.array(
        [nt.barrett_factor(int(v), 64, modulus) for v in values],
        dtype=np.uint64)


def fwd_ntt_radix2(operand, modulus: int, rop: np.ndarray,
                   precon_rop: np.ndarray, input_mod_factor: int = 1,
                   output_mod_factor: int = 1) -> np.ndarray:
    """Forward negacyclic NTT to bit-reversed order, Harvey lazy butterflies.

    Input in [0, IMF*q) with IMF in {1,2,4}; output bit-reversed, in [0,q)
    if output_mod_factor == 1 or [0,4q) if 4.
    Butterfly: X' = red2q(X) + T, Y' = red2q(X) + 2q - T with
    T = shoup(Y, W) in [0,2q) (reference: hexl/ntt/ntt-default.hpp:28-42).
    """
    x = _as_u64(operand).copy()
    n = x.shape[-1]
    if input_mod_factor not in (1, 2, 4):
        raise ValueError("input_mod_factor must be 1, 2, or 4")
    if output_mod_factor not in (1, 4):
        raise ValueError("output_mod_factor must be 1 or 4")
    two_q = _U64(2 * modulus)
    m = 1
    t = n >> 1
    with _errstate():
        while m < n:
            # View as (m blocks) x (2, t): X half and Y half of each block.
            v = x.reshape(*x.shape[:-1], m, 2, t)
            xs = v[..., 0, :]
            ys = v[..., 1, :]
            w = rop[m:2 * m]           # (m,) twiddle per block
            wp = precon_rop[m:2 * m]
            tx = np.where(xs >= two_q, xs - two_q, xs)
            q_hat = mulhi64(ys, wp[:, None])
            tt = ys * w[:, None] - q_hat * _U64(modulus)
            v[..., 0, :] = tx + tt
            v[..., 1, :] = tx + two_q - tt
            m <<= 1
            t >>= 1
    if output_mod_factor == 1:
        x = reduce_mod_lazy(x, modulus, 4)
    return x


def inv_ntt_radix2(operand, modulus: int, irop: np.ndarray,
                   precon_irop: np.ndarray, input_mod_factor: int = 1,
                   output_mod_factor: int = 1) -> np.ndarray:
    """Inverse negacyclic NTT from bit-reversed order, Harvey lazy form.

    Input in [0, IMF*q) with IMF in {1,2}; output in [0,q) (OMF=1) or
    [0,2q) (OMF=2). N^{-1} is folded into the final butterfly stage
    (reference: hexl/ntt/ntt-radix-2.cpp:330-519).
    """
    x = _as_u64(operand).copy()
    n = x.shape[-1]
    if input_mod_factor not in (1, 2):
        raise ValueError("input_mod_factor must be 1 or 2")
    if output_mod_factor not in (1, 2):
        raise ValueError("output_mod_factor must be 1 or 2")
    q = _U64(modulus)
    two_q = _U64(2 * modulus)
    root_index = 1
    t = 1
    m = n >> 1
    with _errstate():
        while m > 1:
            v = x.reshape(*x.shape[:-1], m, 2, t)
            xs = v[..., 0, :]
            ys = v[..., 1, :]
            w = irop[root_index:root_index + m]
            wp = precon_irop[root_index:root_index + m]
            root_index += m
            tx = xs + ys
            tx = np.where(tx >= two_q, tx - two_q, tx)
            ty = xs + two_q - ys
            q_hat = mulhi64(ty, wp[:, None])
            v[..., 0, :] = tx
            v[..., 1, :] = ty * w[:, None] - q_hat * q
            m >>= 1
            t <<= 1
        # Final stage fused with multiplication by N^{-1}.
        w = int(irop[n - 1])
        inv_n = nt.inverse_mod(n, modulus)
        inv_n_precon = nt.barrett_factor(inv_n, 64, modulus)
        inv_n_w = (inv_n * w) % modulus
        inv_n_w_precon = nt.barrett_factor(inv_n_w, 64, modulus)
        half = n >> 1
        xs = x[..., :half]
        ys = x[..., half:]
        tx = xs + ys
        tx = np.where(tx >= two_q, tx - two_q, tx)
        ty = xs + two_q - ys
        out = np.empty_like(x)
        out[..., :half] = multiply_mod_lazy(tx, inv_n, inv_n_precon, modulus)
        out[..., half:] = multiply_mod_lazy(ty, inv_n_w, inv_n_w_precon,
                                            modulus)
    if output_mod_factor == 1:
        out = reduce_mod_lazy(out, modulus, 2)
    return out


def fwd_ntt_radix4(operand, modulus: int, rop: np.ndarray,
                   precon_rop: np.ndarray, input_mod_factor: int = 1,
                   output_mod_factor: int = 1) -> np.ndarray:
    """Forward NTT via radix-4 decomposition (two fused radix-2 levels).

    Mirrors ForwardTransformToBitReverseRadix4 (reference:
    hexl/ntt/ntt-radix-4.cpp:17-..., butterfly ntt-default.hpp:63-95): a
    radix-2 pre-step when log2(N) is odd, then radix-4 passes whose 4-point
    butterfly applies level-1 twiddle W1 to the (X0,X2)/(X1,X3) pairs and
    level-2 twiddles W2, W3 to (X0,X1)/(X2,X3). The butterfly math is the
    same Harvey lazy form as radix-2, so outputs are bit-identical to
    fwd_ntt_radix2 including lazy [0,4q) ranges.
    """
    x = _as_u64(operand).copy()
    n = x.shape[-1]
    if input_mod_factor not in (1, 2, 4):
        raise ValueError("input_mod_factor must be 1, 2, or 4")
    if output_mod_factor not in (1, 4):
        raise ValueError("output_mod_factor must be 1 or 4")
    q = _U64(modulus)
    two_q = _U64(2 * modulus)

    def bfly(xs, ys, w, wp):
        tx = np.where(xs >= two_q, xs - two_q, xs)
        q_hat = mulhi64(ys, wp)
        tt = ys * w - q_hat * q
        return tx + tt, tx + two_q - tt

    m = 1
    with _errstate():
        if nt.log2_exact(n) % 2 == 1:
            # Radix-2 pre-step (ntt-radix-4.cpp:50-72).
            t = n >> 1
            v = x.reshape(*x.shape[:-1], 1, 2, t)
            nx, ny = bfly(v[..., 0, :], v[..., 1, :],
                          rop[1:2, None], precon_rop[1:2, None])
            v[..., 0, :] = nx
            v[..., 1, :] = ny
            m = 2
        while m < n:
            t = n // (4 * m)
            # View as (m blocks) x (4, t): quarters X0..X3 of each block.
            v = x.reshape(*x.shape[:-1], m, 4, t)
            w1 = rop[m:2 * m, None]
            wp1 = precon_rop[m:2 * m, None]
            # Level 1 (stride 2t): (X0, X2) and (X1, X3) with W1.
            a0, a2 = bfly(v[..., 0, :], v[..., 2, :], w1, wp1)
            a1, a3 = bfly(v[..., 1, :], v[..., 3, :], w1, wp1)
            # Level 2 (stride t): (X0, X1) with W2, (X2, X3) with W3.
            lvl2 = rop[2 * m:4 * m].reshape(m, 2)
            plvl2 = precon_rop[2 * m:4 * m].reshape(m, 2)
            b0, b1 = bfly(a0, a1, lvl2[:, 0:1], plvl2[:, 0:1])
            b2, b3 = bfly(a2, a3, lvl2[:, 1:2], plvl2[:, 1:2])
            v[..., 0, :] = b0
            v[..., 1, :] = b1
            v[..., 2, :] = b2
            v[..., 3, :] = b3
            m <<= 2
    if output_mod_factor == 1:
        x = reduce_mod_lazy(x, modulus, 4)
    return x


def inv_ntt_radix4(operand, modulus: int, irop: np.ndarray,
                   precon_irop: np.ndarray, input_mod_factor: int = 1,
                   output_mod_factor: int = 1) -> np.ndarray:
    """Inverse NTT via radix-4 decomposition (two fused radix-2 levels).

    Mirrors InverseTransformFromBitReverseRadix4 (reference:
    hexl/ntt/ntt-radix-4.cpp, butterfly ntt-default.hpp:128-156): radix-4
    passes ascending from stride 1, a radix-2 post-step when the remaining
    stage count is odd, and the final stage fused with N^{-1} exactly as
    radix-2. Bit-identical to inv_ntt_radix2 including lazy [0,2q) ranges.
    """
    x = _as_u64(operand).copy()
    n = x.shape[-1]
    if input_mod_factor not in (1, 2):
        raise ValueError("input_mod_factor must be 1 or 2")
    if output_mod_factor not in (1, 2):
        raise ValueError("output_mod_factor must be 1 or 2")
    q = _U64(modulus)
    two_q = _U64(2 * modulus)

    def bfly(xs, ys, w, wp):
        tx = xs + ys
        tx = np.where(tx >= two_q, tx - two_q, tx)
        ty = xs + two_q - ys
        q_hat = mulhi64(ty, wp)
        return tx, ty * w - q_hat * q

    # log2(n) - 1 stages before the final fused one; pair them into
    # radix-4 passes, with a radix-2 leftover pass when the count is odd.
    stages_before_final = nt.log2_exact(n) - 1
    root_index = 1
    t = 1
    with _errstate():
        while stages_before_final >= 2:
            m = n // (4 * t)
            v = x.reshape(*x.shape[:-1], m, 4, t)
            # Level 1 (stride t): blocks (X0,X1) and (X2,X3); 2m twiddles.
            lvl1 = irop[root_index:root_index + 2 * m].reshape(m, 2)
            plvl1 = precon_irop[root_index:root_index + 2 * m].reshape(m, 2)
            root_index += 2 * m
            a0, a1 = bfly(v[..., 0, :], v[..., 1, :],
                          lvl1[:, 0:1], plvl1[:, 0:1])
            a2, a3 = bfly(v[..., 2, :], v[..., 3, :],
                          lvl1[:, 1:2], plvl1[:, 1:2])
            # Level 2 (stride 2t): (X0, X2) and (X1, X3); m twiddles.
            w2 = irop[root_index:root_index + m, None]
            wp2 = precon_irop[root_index:root_index + m, None]
            root_index += m
            b0, b2 = bfly(a0, a2, w2, wp2)
            b1, b3 = bfly(a1, a3, w2, wp2)
            v[..., 0, :] = b0
            v[..., 1, :] = b1
            v[..., 2, :] = b2
            v[..., 3, :] = b3
            t <<= 2
            stages_before_final -= 2
        if stages_before_final == 1:
            # Radix-2 leftover pass before the final fused stage.
            m = n // (2 * t)
            v = x.reshape(*x.shape[:-1], m, 2, t)
            w = irop[root_index:root_index + m, None]
            wp = precon_irop[root_index:root_index + m, None]
            root_index += m
            nx, ny = bfly(v[..., 0, :], v[..., 1, :], w, wp)
            v[..., 0, :] = nx
            v[..., 1, :] = ny
        # Final stage fused with multiplication by N^{-1} (as radix-2).
        w = int(irop[n - 1])
        inv_n = nt.inverse_mod(n, modulus)
        inv_n_precon = nt.barrett_factor(inv_n, 64, modulus)
        inv_n_w = (inv_n * w) % modulus
        inv_n_w_precon = nt.barrett_factor(inv_n_w, 64, modulus)
        half = n >> 1
        xs = x[..., :half]
        ys = x[..., half:]
        tx = xs + ys
        tx = np.where(tx >= two_q, tx - two_q, tx)
        ty = xs + two_q - ys
        out = np.empty_like(x)
        out[..., :half] = multiply_mod_lazy(tx, inv_n, inv_n_precon, modulus)
        out[..., half:] = multiply_mod_lazy(ty, inv_n_w, inv_n_w_precon,
                                            modulus)
    if output_mod_factor == 1:
        out = reduce_mod_lazy(out, modulus, 2)
    return out


def reference_fwd_ntt(operand, modulus: int, rop: np.ndarray) -> np.ndarray:
    """Textbook (non-lazy) forward NTT, outputs in [0,q) at every step.

    Mirrors ReferenceForwardTransformToBitReverse
    (reference: hexl/ntt/ntt-radix-2.cpp:263-291). Exact object math.
    """
    x = _as_u64(operand).astype(object)
    n = x.shape[-1]
    m = 1
    t = n >> 1
    while m < n:
        v = x.reshape(*x.shape[:-1], m, 2, t)
        xs = v[..., 0, :].copy()
        w = rop[m:2 * m].astype(object)
        wy = (v[..., 1, :] * w[:, None]) % modulus
        v[..., 0, :] = (xs + wy) % modulus
        v[..., 1, :] = (xs - wy) % modulus
        m <<= 1
        t >>= 1
    return x.astype(np.uint64)


def reference_inv_ntt(operand, modulus: int, irop: np.ndarray) -> np.ndarray:
    """Textbook inverse NTT (non-lazy), final scale by N^{-1}."""
    x = _as_u64(operand).astype(object)
    n = x.shape[-1]
    root_index = 1
    t = 1
    m = n >> 1
    while m >= 1:
        v = x.reshape(*x.shape[:-1], m, 2, t)
        xs = v[..., 0, :].copy()
        ys = v[..., 1, :].copy()
        w = irop[root_index:root_index + m].astype(object)
        root_index += m
        v[..., 0, :] = (xs + ys) % modulus
        v[..., 1, :] = ((xs - ys) * w[:, None]) % modulus
        m >>= 1
        t <<= 1
    inv_n = nt.inverse_mod(n, modulus)
    return ((x * inv_n) % modulus).astype(np.uint64)
