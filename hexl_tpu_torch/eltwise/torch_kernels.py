"""Plain PyTorch element-wise modular kernels on int64 tensors of u64 bits.

The counterpart of `hexl_tpu/eltwise/jnp_kernels.py`. The five bodies it
switches to approximate quotients (`_approx()`: mult_mod, fma_mod,
reduce_mod, cmp_sub_mod, montgomery_form_in, and the row forms of the
first and third) take `approx`: False is the exact-quotient form, True the
one with `limb.mulhi64_approx` (error at most 1). A scalar operand is a
u64 Python int. They run on any device; the CUDA kernels K4 and K8
(`csrc/eltwise.cu`) compute exactly these, lazy ranges included.
"""

from __future__ import annotations

import torch

from .. import nt
from ..limb import (barrett_reduce_u64, barrett_reduce_u64_approx,
                    cond_sub64_half, eq64, ge64, gt64, le64, lt64,
                    montgomery_reduce_u128, mul64_wide, mulhi64,
                    mulhi64_approx, mult_mod_barrett,
                    mult_mod_barrett_approx, mult_mod_barrett_rows,
                    reduce_mod_lazy64, s64, select64, shoup_mul_lazy,
                    shoup_mul_lazy_approx, u64_bits)

# The CMPINT predicates of the reference (hexl/util/util.hpp), in its order:
# the code of each is its index, as the kernel takes it.
CMP_NAMES = ("eq", "lt", "le", "false", "ne", "nlt", "nle", "true")


def cmp_code(cmp: str) -> int:
    try:
        return CMP_NAMES.index(cmp)
    except ValueError:
        raise ValueError(f"unknown cmp {cmp!r}") from None


def compare(cmp: str, a: torch.Tensor, bound) -> torch.Tensor:
    """cmp(a, bound) on u64 values, unsigned; bound a tensor or an int."""
    code = cmp_code(cmp)
    if code == 3:
        return torch.zeros(a.shape, dtype=torch.bool, device=a.device)
    if code == 7:
        return torch.ones(a.shape, dtype=torch.bool, device=a.device)
    fn = (eq64, lt64, le64, None, lambda x, y: ~eq64(x, y), ge64, gt64)[code]
    return fn(a, bound)


def add_mod(a: torch.Tensor, b, modulus: int) -> torch.Tensor:
    """(a + b) mod q; inputs in [0, q); b a tensor or a scalar."""
    return cond_sub64_half(a + u64_bits(b), s64(modulus))


def sub_mod(a: torch.Tensor, b, modulus: int) -> torch.Tensor:
    """(a - b) mod q; inputs in [0, q); b a tensor or a scalar."""
    return cond_sub64_half(a - u64_bits(b) + s64(modulus), s64(modulus))


def _mult_barrett(approx: bool):
    return mult_mod_barrett_approx if approx else mult_mod_barrett


def mult_mod(a: torch.Tensor, b: torch.Tensor, modulus: int,
             input_mod_factor: int = 1, approx: bool = False
             ) -> torch.Tensor:
    """(a * b) mod q; inputs < IMF*q, IMF in {1,2,4}; output in [0, q)."""
    if input_mod_factor not in (1, 2, 4):
        raise ValueError("input_mod_factor must be 1, 2 or 4")
    x = reduce_mod_lazy64(a, modulus, input_mod_factor)
    y = reduce_mod_lazy64(b, modulus, input_mod_factor)
    return _mult_barrett(approx)(x, y, modulus)


def fma_mod_preconned(a: torch.Tensor, w: int, wp: int, c, modulus: int,
                      input_mod_factor: int = 1, approx: bool = False
                      ) -> torch.Tensor:
    """(a * w + c) mod q by a Shoup product with the scalar w < q and its
    precondition wp = floor(w 2^64 / q); c may be None. a, c < IMF*q."""
    x = reduce_mod_lazy64(a, modulus, input_mod_factor)
    shoup = shoup_mul_lazy_approx if approx else shoup_mul_lazy
    prod = shoup(x, s64(w), s64(wp), modulus)
    prod = cond_sub64_half(prod, s64(modulus))
    if c is None:
        return prod
    return add_mod(prod, reduce_mod_lazy64(c, modulus, input_mod_factor),
                   modulus)


def barrett_reduce(a: torch.Tensor, modulus: int,
                   output_mod_factor: int = 1,
                   approx: bool = False) -> torch.Tensor:
    """Any u64 mod q with q_barr = floor(2^64/q); [0, 2q) for OMF 2."""
    q_barr = nt.barrett_factor(1, 64, modulus)
    fn = barrett_reduce_u64_approx if approx else barrett_reduce_u64
    return fn(a, modulus, q_barr, output_mod_factor)


def reduce_mod(a: torch.Tensor, modulus: int, input_mod_factor: int,
               output_mod_factor: int, approx: bool = False
               ) -> torch.Tensor:
    """Range change; IMF in {2, 4, modulus}, OMF in {1, 2}. At IMF =
    modulus any u64 is read, and only values >= q take the reduction."""
    if output_mod_factor not in (1, 2):
        raise ValueError("output_mod_factor must be 1 or 2")
    if input_mod_factor == output_mod_factor:
        return a
    if input_mod_factor == modulus:
        red = barrett_reduce(a, modulus, output_mod_factor, approx)
        return select64(ge64(a, modulus), red, a)
    if input_mod_factor == 2:
        return cond_sub64_half(a, s64(modulus))
    if input_mod_factor == 4:
        if output_mod_factor == 1:
            return reduce_mod_lazy64(a, modulus, 4)
        return cond_sub64_half(a, s64(2 * modulus))
    raise ValueError("input_mod_factor must be 2, 4, or == modulus")


def cmp_add(a: torch.Tensor, cmp: str, bound, diff) -> torch.Tensor:
    """cmp(a, bound) ? a + diff : a, wrapping mod 2^64."""
    return select64(compare(cmp, a, bound), a + u64_bits(diff), a)


def cmp_sub_mod(a: torch.Tensor, modulus: int, cmp: str, bound,
                diff, approx: bool = False) -> torch.Tensor:
    """cmp(a, bound) ? (a mod q - diff) mod q : a mod q; the predicate
    reads the unreduced input."""
    mask = compare(cmp, a, bound)
    red = barrett_reduce(a, modulus, 1, approx)
    sub = cond_sub64_half(red - u64_bits(diff) + s64(modulus), s64(modulus))
    return select64(mask, sub, red)


def montgomery_form_in(a: torch.Tensor, modulus: int,
                       approx: bool = False) -> torch.Tensor:
    """a * 2^64 mod q, a in [0, q)."""
    return _mult_barrett(approx)(a, s64((1 << 64) % modulus), modulus)


def montgomery_form_out(a: torch.Tensor, modulus: int) -> torch.Tensor:
    """a * 2^-64 mod q: REDC of the 128-bit value (0, a)."""
    inv = nt.hensel_lemma_2adic_root(64, modulus)
    return montgomery_reduce_u128(torch.zeros_like(a), a, modulus, inv)


def montgomery_mult_reduce(a: torch.Tensor, b: torch.Tensor,
                           modulus: int) -> torch.Tensor:
    """REDC(a*b) = a * b * 2^-64 mod q for a, b in [0, q)."""
    inv = nt.hensel_lemma_2adic_root(64, modulus)
    hi, lo = mul64_wide(a, b)
    return montgomery_reduce_u128(hi, lo, modulus, inv)


# -- one op over the rows of a (k, ...) block, row r under its own modulus --

def _row_columns(consts: torch.Tensor, x: torch.Tensor):
    """q, mu, shift and q_barr of each row (consts (k, 4), as
    `ops.row_constants` builds it), shaped to broadcast along x's rows."""
    shape = (-1,) + (1,) * (x.dim() - 1)
    return [consts[:, c].reshape(shape) for c in range(4)]


def mult_mod_rows(a: torch.Tensor, b: torch.Tensor, consts: torch.Tensor,
                  input_mod_factor: int = 1,
                  approx: bool = False) -> torch.Tensor:
    """`mult_mod` of row r under row r's modulus; inputs < IMF*q_r."""
    if input_mod_factor not in (1, 2, 4):
        raise ValueError("input_mod_factor must be 1, 2 or 4")
    q, mu, shift, _ = _row_columns(consts, a)

    def lazy(x):
        if input_mod_factor == 4:
            x = cond_sub64_half(x, 2 * q)
        return cond_sub64_half(x, q) if input_mod_factor >= 2 else x

    return mult_mod_barrett_rows(lazy(a), lazy(b), q, mu, shift, approx)


def reduce_mod_rows(a: torch.Tensor, consts: torch.Tensor,
                    output_mod_factor: int = 1,
                    approx: bool = False) -> torch.Tensor:
    """`reduce_mod` of row r from IMF = q_r (any u64) to the OMF: Barrett
    with q_barr_r where a >= q_r."""
    if output_mod_factor not in (1, 2):
        raise ValueError("output_mod_factor must be 1 or 2")
    q, _, _, q_barr = _row_columns(consts, a)
    if approx:
        red = cond_sub64_half(a - mulhi64_approx(a, q_barr) * q, 2 * q)
    else:
        red = a - mulhi64(a, q_barr) * q
    if output_mod_factor == 1:
        red = cond_sub64_half(red, q)
    return select64(ge64(a, q), red, a)
