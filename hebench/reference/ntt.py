"""The negacyclic NTT of HEXL's convention, exact.

The forward transform is HEXL's ForwardTransformToBitReverse: Cooley-Tukey
stages over the powers of psi, the smallest primitive 2N-th root of unity
mod q, in bit-reversed order; output j is the evaluation of the input at
psi^(2 * bitrev(j) + 1). The inverse is the transform's exact inverse
(Gentleman-Sande stages over the inverse powers, then N^-1), so it returns
each residue fully reduced, as HEXL's does at an output factor of 1.
"""

from __future__ import annotations

import numpy as np
import torch

from .modarith import mulmod


def _bitrev(n: int) -> np.ndarray:
    log_n = n.bit_length() - 1
    idx = np.arange(n)
    out = np.zeros(n, dtype=np.int64)
    for b in range(log_n):
        out |= ((idx >> b) & 1) << (log_n - 1 - b)
    return out


def minimal_root(two_n: int, q: int) -> int:
    """The smallest primitive two_n-th root of unity mod the prime q."""
    if (q - 1) % two_n:
        raise ValueError(f"{q} is not 1 mod {two_n}")
    for g in range(2, q):
        r = pow(g, (q - 1) // two_n, q)
        if pow(r, two_n // 2, q) == q - 1:
            break
    best, cur, r2 = r, r, r * r % q
    for _ in range(two_n // 2):
        best = min(best, cur)
        cur = cur * r2 % q
    return best


class Tables:
    """Roots and twiddles of N over a list of primes, as (rows, N) int64
    tensors on `device`: fwd[i, k] = psi_i^bitrev(k), inv[i, k] =
    psi_i^-bitrev(k); n_inv[i] = N^-1 mod q_i."""

    def __init__(self, n: int, moduli, device="cpu"):
        if n < 2 or n & (n - 1):
            raise ValueError("N must be a power of two of at least 2")
        self.n = n
        self.moduli = tuple(int(q) for q in moduli)
        self.bits = max(q.bit_length() for q in self.moduli)
        rev = _bitrev(n)
        fwd, inv = [], []
        for q in self.moduli:
            psi = minimal_root(2 * n, q)
            pows = [1] * n
            for k in range(1, n):
                pows[k] = pows[k - 1] * psi % q
            # psi^-k = -psi^(N - k), since psi^N = -1.
            ipows = [1] + [q - pows[n - k] for k in range(1, n)]
            fwd.append(np.array(pows, dtype=np.int64)[rev])
            inv.append(np.array(ipows, dtype=np.int64)[rev])
        self.q = torch.tensor(self.moduli, dtype=torch.int64, device=device)
        self.fwd = torch.from_numpy(np.stack(fwd)).to(device)
        self.inv = torch.from_numpy(np.stack(inv)).to(device)
        self.n_inv = torch.tensor([pow(n, -1, q) for q in self.moduli],
                                  dtype=torch.int64, device=device)

    def rows(self, idx) -> "Tables":
        """The tables of the primes at positions `idx`."""
        sub = object.__new__(Tables)
        sub.n = self.n
        sub.moduli = tuple(self.moduli[i] for i in idx)
        sub.bits = max(q.bit_length() for q in sub.moduli)
        pick = torch.tensor(list(idx), dtype=torch.int64,
                            device=self.q.device)
        sub.q, sub.fwd, sub.inv, sub.n_inv = (
            t[pick] for t in (self.q, self.fwd, self.inv, self.n_inv))
        return sub


def _check(x: torch.Tensor, tab: Tables):
    if x.dim() != 3 or x.shape[0] != len(tab.moduli) or x.shape[2] != tab.n:
        raise ValueError(f"expected (rows={len(tab.moduli)}, batch, "
                         f"N={tab.n}), got {tuple(x.shape)}")


def forward(x: torch.Tensor, tab: Tables, mul=mulmod) -> torch.Tensor:
    """x (rows, batch, N), row i in [0, q_i) -> its forward transforms."""
    _check(x, tab)
    r, b, n = x.shape
    q = tab.q.view(r, 1, 1, 1)
    m, t = 1, n // 2
    while m < n:
        v = x.reshape(r, b, m, 2, t)
        w = tab.fwd[:, m:2 * m].reshape(r, 1, m, 1)
        wy = mul(v[:, :, :, 1], w, q, tab.bits)
        xs = v[:, :, :, 0]
        x = torch.stack(((xs + wy) % q, (xs - wy) % q), dim=3)
        m, t = 2 * m, t // 2
    return x.reshape(r, b, n)


def inverse(x: torch.Tensor, tab: Tables, mul=mulmod) -> torch.Tensor:
    """The exact inverse of `forward`."""
    _check(x, tab)
    r, b, n = x.shape
    q = tab.q.view(r, 1, 1, 1)
    m, t = n // 2, 1
    while m >= 1:
        v = x.reshape(r, b, m, 2, t)
        w = tab.inv[:, m:2 * m].reshape(r, 1, m, 1)
        xs, ys = v[:, :, :, 0], v[:, :, :, 1]
        x = torch.stack(((xs + ys) % q, mul((xs - ys) % q, w, q, tab.bits)),
                        dim=3)
        m, t = m // 2, 2 * t
    return mul(x.reshape(r, b, n), tab.n_inv.view(r, 1, 1),
               tab.q.view(r, 1, 1), tab.bits)
