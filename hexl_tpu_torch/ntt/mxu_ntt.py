"""The four-step (matmul) NTT, and the wrappers of K14 and K15.

The counterpart of `hexl_tpu/ntt/mxu_ntt.py`, the NTT's other regime: the
negacyclic transform of N = n1 * n2 as two passes, each an exact matrix
product of 7-bit digit planes followed by a digit-plane fold (four-step /
Bailey decomposition; the bit-reversals are folded into the weight
matrices, so the output is in bit-reversed order with no gather). The plan
is the JAX package's, in numpy: digit counts, weight matrices split into
digit planes (weights pre-scaled by 2^(7t) mod q per input digit t), and
the Shoup tables of the fused twiddle and of the top plane's fold by
rho = 2^(7(dW-1)) mod q.

The matrix product is the one step the JAX package leaves to XLA outside
any Pallas kernel (jax.lax.dot_general with f32 accumulation of bf16
digits, in t-groups kept below 2^24). Here it is `torch._int_mm` on int8
digit planes (digits are 0..127), exact int32 accumulation on the tensor
cores' int8 path: the largest sum, dx * n_in * 127^2 with dx <= 10 and
n_in <= 512, is below 2^31, so the sums are the same integers as the JAX
t-groups' and one product replaces them. (bf16 `torch.matmul` would round
its bf16 result to 8 significant bits.) On the card `_int_mm` wants more
than 16 rows in its first operand and inner and column sizes divisible by
8; every shape from N = 2^8 up meets that, and `digit_matmul` checks it.

The fold of each pass is a kernel: K14 (`csrc/mxu.cu`, replacing
mxu_ntt.py::_fold_twiddle_pallas) carry-normalizes the int32 digit planes
into the 64-bit low part L and the top plane R and writes
C = Shoup(L, T) + Shoup(R, rho*T) in [0, 4q); K15 (replacing
::_final_pallas) writes V = L + Shoup(R, rho) after one Barrett step,
[0, 2q), or [0, q) with the OMF 1 subtraction fused. On the CPU the plain
versions `fold_twiddle_plain`/`fold_final_plain` run instead (the JAX
package's `_carry_norm_rows`, `_twiddle_fuse` and `_final_value`), and
nothing else. Launches are counted under "K14" and "K15".

Forward: IMF in {1, 2, 4}, OMF in {1, 4}; the lazy output is [0, 2q), a
subset of the reference's [0, 4q), bit for bit the JAX package's.
Inverse: IMF in {1, 2}, OMF in {1, 2}, lazy output [0, 2q).
"""

from __future__ import annotations

import ctypes
import threading
from typing import Dict, Tuple

import numpy as np
import torch

from .. import _build, _device, nt
from ..limb import (barrett_reduce_u64, cond_sub64_half, s64, shoup_mul_lazy,
                    shr64, to_numpy, to_tensor)

DIGIT_BITS = 7
DIGIT_BASE = 1 << DIGIT_BITS          # 128
DIGIT_MASK = DIGIT_BASE - 1

# Weight tables grow as dx * dw * N int8 entries: the JAX package's range.
MXU_MAX_N = 1 << 18
MXU_MIN_N = 1 << 8

_P = ctypes.c_void_p
_U = ctypes.c_uint64
_I = ctypes.c_int
_LL = ctypes.c_longlong
_FOLD_ARGS = (_P, _P, _P, _P, _P, _P, _U, _I, _I, _LL, _I, _P)
_FINAL_ARGS = (_P, _P, _U, _U, _U, _U, _I, _I, _LL, _I, _P)


def _digits_needed(max_value: int) -> int:
    """Number of 7-bit digits to represent values in [0, max_value]."""
    return max(1, (int(max_value).bit_length() + DIGIT_BITS - 1)
               // DIGIT_BITS)


def _mulmod_scalar(a: np.ndarray, c: int, q: int) -> np.ndarray:
    """(a * c) mod q elementwise for uint64 a, exact: 21-bit pieces of a
    times reduced constants, each piece split once more into 11-bit halves
    so that every partial sum stays below 2^64 (for q < 2^52); q above 2^52
    takes Python integers (precompute only)."""
    a = a.astype(np.uint64)
    c = int(c) % q
    m21 = np.uint64((1 << 21) - 1)
    a0 = a & m21
    a1 = (a >> np.uint64(21)) & m21
    a2 = a >> np.uint64(42)
    c0 = np.uint64(c)
    c1 = np.uint64((c << 21) % q)
    c2 = np.uint64((c << 42) % q)

    def piece_mul(p, ck):
        ck = int(ck)
        lo = p & np.uint64((1 << 11) - 1)
        hi = p >> np.uint64(11)
        ck_hi = np.uint64((ck << 11) % q)
        # lo, hi < 2^11 and ck, ck_hi < q: the sum is < 2^12 * q, which
        # fits 64 bits only for q < 2^52.
        if q < (1 << 52):
            return (lo * np.uint64(ck) + hi * ck_hi) % np.uint64(q)
        return np.array([(int(x) * ck) % q for x in p], dtype=np.uint64)
    if q < (1 << 52):
        r = (piece_mul(a0, c0) + piece_mul(a1, c1) + piece_mul(a2, c2))
        return r % np.uint64(q)
    ao = a.astype(object)
    return ((ao * c) % q).astype(np.uint64)


def _digit_planes(w: np.ndarray, num: int) -> np.ndarray:
    """uint64 array -> `num` unsigned 7-bit digit planes (int8)."""
    v = w.astype(np.uint64)
    return np.stack([((v >> np.uint64(DIGIT_BITS * s))
                      & np.uint64(DIGIT_MASK)).astype(np.int8)
                     for s in range(num)])


def _weight_tensor(wmat: np.ndarray, q: int, dx: int) -> np.ndarray:
    """The (dx, dw, n_in, n_out) int8 digit weight tensor: plane [t, s]
    holds digit s of (wmat * 2^(7t) mod q); wmat (n_in, n_out) < q."""
    dw = _digits_needed(q - 1)
    out = np.empty((dx, dw) + wmat.shape, dtype=np.int8)
    cur = wmat.astype(np.uint64)
    scale = pow(2, DIGIT_BITS, q)
    for t in range(dx):
        out[t] = _digit_planes(cur, dw)
        if t + 1 < dx:
            cur = _mulmod_scalar(cur, scale, q)
    return out


def _shoup_table(tab: np.ndarray, q: int) -> Tuple[np.ndarray, np.ndarray]:
    """(w, w_precon) host uint64 tables for a table < q."""
    precon = np.array([(int(v) << 64) // q for v in tab.reshape(-1)],
                      dtype=np.uint64).reshape(tab.shape)
    return tab.astype(np.uint64), precon


def _power_row(base: int, n: int, q: int) -> np.ndarray:
    """[base^0, base^1, ..., base^{n-1}] mod q as uint64."""
    row = np.empty(n, dtype=np.uint64)
    v = 1
    for i in range(n):
        row[i] = v
        v = (v * base) % q
    return row


def _rowmul(a: np.ndarray, b: np.ndarray, q: int) -> np.ndarray:
    """Elementwise (a*b) mod q for uint64 rows (exact)."""
    return np.array([(int(x) * int(y)) % q for x, y in zip(a, b)],
                    dtype=np.uint64)


class MxuNttPlan:
    """Digit weights and fold tables for one (N, q), as the JAX plan.

    n2 = 2^floor(log N / 2) is pass 1's contracted axis, n1 = N / n2.
    Weights are held transposed, W2T[(s, o), (t, i)] (int8), the first
    operand of `_int_mm`; device copies are made once per device."""

    def __init__(self, degree: int, modulus: int, root: int | None = None):
        if degree < MXU_MIN_N or degree > MXU_MAX_N:
            raise ValueError("degree outside MXU regime")
        self.n = degree
        self.q = modulus
        log_n = nt.log2_exact(degree)
        self.log_n = log_n
        if root is None:
            root = nt.minimal_primitive_root(2 * degree, modulus)
        self.root = root
        q = modulus
        psi = root
        w = (psi * psi) % q
        n2 = 1 << (log_n // 2)
        n1 = degree // n2
        self.n1, self.n2 = n1, n2
        b2, b1 = nt.log2_exact(n2), nt.log2_exact(n1)

        # Forward pass-1 input < 4q (IMF <= 4); the fused twiddle/fold
        # output C < 4q feeds pass 2. Inverse input < 2q.
        self.dw = _digits_needed(q - 1)
        self.dx_fwd = _digits_needed(4 * q - 1)
        self.dx_inv = _digits_needed(2 * q - 1)
        self.dx_mid = _digits_needed(4 * q - 1)
        # rho folds the unnormalized top digit plane: value = L + R*rho.
        self.rho = pow(2, DIGIT_BITS * (self.dw - 1), q)

        br1 = np.array([nt.reverse_bits(i, b1) for i in range(n1)])
        br2 = np.array([nt.reverse_bits(i, b2) for i in range(n2)])

        # Forward. Wa[i2][a] = psi^{n1 i2} * w^{n1 i2 br2(a)}
        e_rows = [pow(psi, int(n1 * v), q) for v in range(n2)]
        w_n1 = pow(w, n1, q)
        wa = np.empty((n2, n2), dtype=np.uint64)
        for r in range(n2):
            row = _power_row(pow(w_n1, r, q), n2, q)
            wa[r] = (np.uint64(e_rows[r]) * row[br2]) % np.uint64(q) \
                if q < (1 << 32) else _mulmod_scalar(row[br2], e_rows[r], q)
        # Wb[i1][b] = w^{n2 i1 br1(b)}
        w_n2 = pow(w, n2, q)
        wb = np.empty((n1, n1), dtype=np.uint64)
        for r in range(n1):
            wb[r] = _power_row(pow(w_n2, r, q), n1, q)[br1]
        # T[a][i1] = psi^{i1} * w^{br2(a) i1}
        tmat = np.empty((n2, n1), dtype=np.uint64)
        psi_row = _power_row(psi, n1, q)
        for a in range(n2):
            tmat[a] = _rowmul(_power_row(pow(w, int(br2[a]), q), n1, q),
                              psi_row, q)

        # Inverse. WbInv[b][i1] = w^{-n2 i1 br1(b)}
        w_n2_inv = nt.inverse_mod(w_n2, q)
        wbi = np.empty((n1, n1), dtype=np.uint64)
        for b in range(n1):
            wbi[b] = _power_row(pow(w_n2_inv, int(br1[b]), q), n1, q)
        # TInv[a][i1] = N^{-1} psi^{-i1} w^{-br2(a) i1}
        n_inv = nt.inverse_mod(degree, q)
        psi_inv = nt.inverse_mod(psi, q)
        w_inv = nt.inverse_mod(w, q)
        tinv = np.empty((n2, n1), dtype=np.uint64)
        psi_inv_row = _mulmod_scalar(_power_row(psi_inv, n1, q), n_inv, q)
        for a in range(n2):
            tinv[a] = _rowmul(_power_row(pow(w_inv, int(br2[a]), q), n1, q),
                              psi_inv_row, q)
        # WaInv[a][i2] = psi^{-n1 i2} w^{-n1 i2 br2(a)}
        psi_n1_inv = nt.inverse_mod(pow(psi, n1, q), q)
        w_n1_inv = nt.inverse_mod(w_n1, q)
        wai = np.empty((n2, n2), dtype=np.uint64)
        for a in range(n2):
            base = (pow(w_n1_inv, int(br2[a]), q) * psi_n1_inv) % q
            wai[a] = _power_row(base, n2, q)

        def weights(mat, dx):
            wt = _weight_tensor(mat, q, dx)      # (dx, dw, n_in, n_out)
            dw, n_in, n_out = wt.shape[1], wt.shape[2], wt.shape[3]
            # W2T[(s, o), (t, i)]
            return np.ascontiguousarray(
                wt.transpose(1, 3, 0, 2).reshape(dw * n_out, dx * n_in))

        self.wa = weights(wa, self.dx_fwd)        # ((s, a), (t, i2))
        self.wb = weights(wb, self.dx_mid)        # ((s, b), (t, i1))
        self.wbi = weights(wbi, self.dx_inv)      # ((s, i1), (t, b))
        self.wai = weights(wai, self.dx_mid)      # ((s, i2), (t, a))

        # Fold tables: forward T on (a, i1); inverse TInv on values laid
        # out (i1, ..., a), stored transposed.
        rho = self.rho
        self.t_tab = _shoup_table(tmat, q)
        self.rho_t_tab = _shoup_table(_mulmod_scalar(tmat, rho, q), q)
        tinv_t = np.ascontiguousarray(tinv.T)
        self.ti_tab = _shoup_table(tinv_t, q)
        self.rho_ti_tab = _shoup_table(_mulmod_scalar(tinv_t, rho, q), q)
        self.rho_precon = (rho << 64) // q
        self.mu = (1 << 64) // q        # the final Barrett constant
        self._dev: Dict[str, Dict[str, torch.Tensor]] = {}
        self._dev_lock = threading.Lock()

    def tensors(self, device) -> Dict[str, torch.Tensor]:
        """The weights (int8) and fold tables (int64 of u64 bits) on
        `device`, copied once per device."""
        key = str(torch.device(device))
        tabs = self._dev.get(key)
        if tabs is None:
            with self._dev_lock:
                tabs = self._dev.get(key)
                if tabs is None:
                    tabs = {name: torch.from_numpy(getattr(self, name)).to(
                        device) for name in ("wa", "wb", "wbi", "wai")}
                    for name in ("t_tab", "rho_t_tab", "ti_tab",
                                 "rho_ti_tab"):
                        w, wp = getattr(self, name)
                        tabs[name] = (to_tensor(w, device),
                                      to_tensor(wp, device))
                    self._dev[key] = tabs
        return tabs


_MXU_CACHE: Dict[Tuple[int, int], MxuNttPlan] = {}
_MXU_LOCK = threading.Lock()


def get_mxu_plan(degree: int, modulus: int,
                 root: int | None = None) -> MxuNttPlan:
    """The cached MXU plan of (N, q), built on first use."""
    key = (degree, modulus)
    plan = _MXU_CACHE.get(key)
    if plan is None:
        with _MXU_LOCK:
            plan = _MXU_CACHE.get(key)
            if plan is None:
                plan = MxuNttPlan(degree, modulus, root)
                _MXU_CACHE[key] = plan
    return plan


def clear_mxu_cache() -> None:
    with _MXU_LOCK:
        _MXU_CACHE.clear()


# -- the digit matmul ----------------------------------------------------------

def split_digits(x: torch.Tensor, dx: int) -> torch.Tensor:
    """x (n_in, ...) of u64 bits -> int8 digits (rest, dx * n_in), row r
    holding digit t of x[i, r] at column t * n_in + i: digit t is bits
    [7t, 7t + 7), by a logical shift (a 4q input reaches bit 63). Its
    transpose is the digit-stacked operand (dx * n_in, rest), column-major
    as cuBLAS's int8 product wants its second operand (it refused the
    row-major one on an H100)."""
    n_in = x.shape[0]
    xt = x.reshape(n_in, -1).t()
    out = torch.empty((xt.shape[0], dx, n_in), dtype=torch.int8,
                      device=x.device)
    for t in range(dx):
        shift = DIGIT_BITS * t
        # Below bit 64 - shift an arithmetic shift leaves the digit's bits
        # in place; only a digit reaching past bit 63 needs the logical one.
        d = xt >> shift if shift + DIGIT_BITS <= 64 else shr64(xt, shift)
        out[:, t] = d & DIGIT_MASK
    return out.reshape(xt.shape[0], dx * n_in)


def digit_matmul(x: torch.Tensor, w2t: torch.Tensor, dx: int) -> torch.Tensor:
    """The exact digit product: int32 planes (dw * n_out, rest) =
    W2T @ digits(x), by `torch._int_mm`."""
    digits = split_digits(x, dx).t()
    if x.device.type == "cuda":
        m, k = w2t.shape
        cols = digits.shape[1]
        if m <= 16 or k % 8 or cols % 8:
            raise ValueError(
                f"_int_mm on the card needs more than 16 rows and inner and "
                f"column sizes divisible by 8; got ({m}, {k}) x ({k}, {cols})")
    return torch._int_mm(w2t, digits)


# -- the folds: plain versions ---------------------------------------------------

def _carry_norm(planes: torch.Tensor, dw: int, n_out: int):
    """int32 digit planes (dw * n_out, cols) -> (L, R) as int64: L = the
    carry-normalized low 7(dw-1) bits, R = the top plane plus the last
    carry (the JAX package's _carry_norm_rows)."""
    p = planes.reshape(dw, n_out, -1).to(torch.int64)
    lo = torch.zeros_like(p[0])
    carry = torch.zeros_like(lo)
    for s in range(dw - 1):
        v = p[s] + carry
        lo = lo | ((v & DIGIT_MASK) << (DIGIT_BITS * s))
        carry = v >> DIGIT_BITS
    return lo, p[dw - 1] + carry


def fold_twiddle_plain(planes: torch.Tensor, plan: MxuNttPlan, tab, rho_tab,
                       n_out: int, n_tail: int) -> torch.Tensor:
    """C = Shoup(L, T) + Shoup(R, rho*T) in [0, 4q), shaped (n_out, cols);
    the tables (n_out, n_tail) are read at column mod n_tail."""
    lo, r = _carry_norm(planes, plan.dw, n_out)
    cols = lo.shape[1]

    def rows(t):
        return t.reshape(n_out, 1, n_tail).expand(
            n_out, cols // n_tail, n_tail).reshape(n_out, cols)

    a = shoup_mul_lazy(lo, rows(tab[0]), rows(tab[1]), plan.q)
    b = shoup_mul_lazy(r, rows(rho_tab[0]), rows(rho_tab[1]), plan.q)
    return a + b


def fold_final_plain(planes: torch.Tensor, plan: MxuNttPlan, n_out: int,
                     omf: int) -> torch.Tensor:
    """V = L + Shoup(R, rho), one Barrett step: [0, 2q), or [0, q) for
    omf 1 (the JAX package's _final_value, then cond_sub64)."""
    lo, r = _carry_norm(planes, plan.dw, n_out)
    v = lo + shoup_mul_lazy(r, s64(plan.rho), s64(plan.rho_precon), plan.q)
    out = barrett_reduce_u64(v, plan.q, plan.mu, 2)
    return cond_sub64_half(out, s64(plan.q)) if omf == 1 else out


# -- the folds: kernel wrappers ------------------------------------------------------

def _fold_operands(planes: torch.Tensor, plan: MxuNttPlan, n_out: int) -> bool:
    """The wrappers' checks; True on a CUDA device (the kernel runs)."""
    if planes.dtype != torch.int32 or planes.dim() != 2:
        raise TypeError("the digit planes must be a 2-D int32 tensor")
    if planes.shape[0] != plan.dw * n_out or not planes.is_contiguous():
        raise ValueError(f"expected contiguous planes of {plan.dw * n_out} "
                         f"rows, got {tuple(planes.shape)}")
    if planes.device.type not in ("cpu", "cuda"):
        raise ValueError(f"unsupported device {planes.device}")
    return planes.device.type == "cuda"


def fold_twiddle(planes: torch.Tensor, plan: MxuNttPlan, tab, rho_tab,
                 n_out: int, n_tail: int) -> torch.Tensor:
    """K14 (the plain version on the CPU): the pass boundary's fold with
    the twiddle fused, C in [0, 4q), shaped (n_out, cols)."""
    if not _fold_operands(planes, plan, n_out):
        return fold_twiddle_plain(planes, plan, tab, rho_tab, n_out, n_tail)
    _build.on_card(*tab, *rho_tab)
    cols = planes.shape[1]
    out = torch.empty((n_out, cols), dtype=torch.int64, device=planes.device)
    if out.numel():
        fn = _build.function("mxu", "hexl_mxu_fold_twiddle", _FOLD_ARGS)
        _build.launch_on(planes.device, "K14", fn, planes.data_ptr(),
                         out.data_ptr(), tab[0].data_ptr(), tab[1].data_ptr(),
                         rho_tab[0].data_ptr(), rho_tab[1].data_ptr(), plan.q,
                         plan.dw, n_out, cols, n_tail)
    return out


def fold_final(planes: torch.Tensor, plan: MxuNttPlan, n_out: int,
               omf: int) -> torch.Tensor:
    """K15 (the plain version on the CPU): the last pass's fold and Barrett
    step, [0, 2q), or [0, q) for omf 1; shaped (n_out, cols)."""
    if not _fold_operands(planes, plan, n_out):
        return fold_final_plain(planes, plan, n_out, omf)
    cols = planes.shape[1]
    out = torch.empty((n_out, cols), dtype=torch.int64, device=planes.device)
    if out.numel():
        fn = _build.function("mxu", "hexl_mxu_fold_final", _FINAL_ARGS)
        _build.launch_on(planes.device, "K15", fn, planes.data_ptr(),
                         out.data_ptr(), plan.q, plan.rho, plan.rho_precon,
                         plan.mu, plan.dw, n_out, cols, omf)
    return out


# -- the transform -------------------------------------------------------------------

def transform(x: torch.Tensor, plan: MxuNttPlan, forward: bool,
              omf: int) -> torch.Tensor:
    """Both passes on x (..., N) of u64 bits, folded by K14 and K15 (the
    plain folds on the CPU)."""
    return _passes(x, plan, forward, omf, fold_twiddle, fold_final)


def _passes(x: torch.Tensor, plan: MxuNttPlan, forward: bool, omf: int,
            boundary, final) -> torch.Tensor:
    """`transform` with the folds given: `boundary` (fold_twiddle's
    signature) and `final` (fold_final's)."""
    n1, n2, n = plan.n1, plan.n2, plan.n
    if x.shape[-1] != n:
        raise ValueError(f"last dimension must be N={n}, got "
                         f"{tuple(x.shape)}")
    lead = tuple(x.shape[:-1])
    batch = x.numel() // n
    tabs = plan.tensors(x.device)
    v = x.reshape(batch, n2, n1)
    if forward:
        # Pass 1 contracts i2: (i2, batch, i1) -> C (a, batch, i1).
        v = v.permute(1, 0, 2).contiguous()
        c = boundary(digit_matmul(v, tabs["wa"], plan.dx_fwd), plan,
                     tabs["t_tab"], tabs["rho_t_tab"], n2, n1)
        # Pass 2 contracts i1: (i1, batch, a) -> (b, batch, a).
        c = c.reshape(n2, batch, n1).permute(2, 1, 0).contiguous()
        out = final(digit_matmul(c, tabs["wb"], plan.dx_mid), plan, n1, omf)
        # Natural output order (batch, a, b).
        out = out.reshape(n1, batch, n2).permute(1, 2, 0)
    else:
        # Pass 1 contracts b: (b, batch, a) -> C (i1, batch, a).
        v = v.permute(2, 0, 1).contiguous()
        c = boundary(digit_matmul(v, tabs["wbi"], plan.dx_inv), plan,
                     tabs["ti_tab"], tabs["rho_ti_tab"], n1, n2)
        # Pass 2 contracts a: (a, batch, i1) -> (i2, batch, i1).
        c = c.reshape(n1, batch, n2).permute(2, 1, 0).contiguous()
        out = final(digit_matmul(c, tabs["wai"], plan.dx_mid), plan, n2, omf)
        out = out.reshape(n2, batch, n1).permute(1, 0, 2)
    return out.reshape(lead + (n,)).contiguous()


def _run(x, plan: MxuNttPlan, forward: bool, omf: int, device):
    (tx,), host = _device.operands((x,), device)
    out = transform(tx, plan, forward, omf)
    return to_numpy(out) if host else out


def fwd_ntt_mxu(x, plan: MxuNttPlan, input_mod_factor: int = 1,
                output_mod_factor: int = 1, device=None):
    """Forward negacyclic NTT by the four-step matmul; bit-reversed output.

    x (..., N): an int64 tensor of u64 bits (runs on its device) or numpy
    uint64 (runs on `device`, default CUDA; numpy out). Input <
    IMF*q (IMF in {1,2,4}); output [0,q) for OMF=1, else [0,2q)."""
    if input_mod_factor not in (1, 2, 4):
        raise ValueError("input_mod_factor must be 1, 2 or 4")
    if output_mod_factor not in (1, 4):
        raise ValueError("output_mod_factor must be 1 or 4")
    return _run(x, plan, True, output_mod_factor, device)


def inv_ntt_mxu(x, plan: MxuNttPlan, input_mod_factor: int = 1,
                output_mod_factor: int = 1, device=None):
    """Inverse negacyclic NTT from bit-reversed input by the four-step
    matmul. Input < IMF*q (IMF in {1,2}); output [0,q) for OMF=1 else
    [0,2q)."""
    if input_mod_factor not in (1, 2):
        raise ValueError("input_mod_factor must be 1 or 2")
    if output_mod_factor not in (1, 2):
        raise ValueError("output_mod_factor must be 1 or 2")
    return _run(x, plan, False, output_mod_factor, device)
