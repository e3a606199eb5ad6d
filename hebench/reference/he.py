"""The dyadic (ciphertext x ciphertext) product and the CKKS key switch,
exact.

`key_switch` is SEAL's `switch_key_inplace` (the algorithm HEXL's
`experimental/seal/key-switch` implements) in HEXL's shapes: the target's
decomposition, the products with the keys summed mod each prime, and the
mod-down by the key prime with the (qk - 1) / 2 rounding. It is written
from that algorithm, over this package's own transforms.
"""

from __future__ import annotations

import torch

from .modarith import mulmod
from .ntt import Tables, forward, inverse


def dyadic(x: torch.Tensor, y: torch.Tensor, q: torch.Tensor, bits: int,
           mul=mulmod) -> torch.Tensor:
    """x, y (2, M, N) ciphertexts in NTT form, q (M,) -> (3, M, N): (x0 y0,
    x0 y1 + x1 y0, x1 y1) mod q_m."""
    q = q.view(-1, 1)
    x0, x1, y0, y1 = x[0], x[1], y[0], y[1]
    mid = (mul(x0, y1, q, bits) + mul(x1, y0, q, bits)) % q
    return torch.stack((mul(x0, y0, q, bits), mid, mul(x1, y1, q, bits)))


def key_switch(result: torch.Tensor, target: torch.Tensor,
               keys: torch.Tensor, msf, tab: Tables,
               mul=mulmod) -> torch.Tensor:
    """result (kc, ds, N), target (ds, N) in NTT form, keys (ds, kc, kms,
    N), msf the ds factors qk^-1 mod q_i, tab the tables of the kms moduli
    (the ds decomposition primes first, the key prime qk last) -> result
    plus the switched target, (kc, ds, N), every residue in [0, q_i)."""
    kc, ds, n = result.shape
    kms = keys.shape[2]
    if len(tab.moduli) != kms or target.shape != (ds, n) \
            or keys.shape != (ds, kc, kms, n) or len(msf) != ds:
        raise ValueError("key_switch: shapes or moduli do not match")
    rows = list(range(ds)) + [kms - 1]
    tr = tab.rows(rows)                      # q_0 .. q_{ds-1}, qk
    td, tk = tab.rows(range(ds)), tab.rows([kms - 1])
    qr = tr.q.view(-1, 1, 1)
    qk = tab.moduli[-1]
    # The target in coefficient form, each of its ds residues mod q_j.
    coeffs = inverse(target.unsqueeze(1), td, mul)[:, 0]      # (ds, N)
    # Row i (decomposition primes, then the key prime), column j: the
    # residue mod q_j taken mod r_i and transformed; at j = i the target
    # itself, already in NTT form.
    conv = coeffs.unsqueeze(0) % qr                          # (ds+1, ds, N)
    ext = forward(conv, tr, mul)
    diag = torch.arange(ds, device=ext.device)
    ext[diag, diag] = target
    # The products with the keys: row i takes key slot i (the key prime's
    # row the last slot), summed over j mod r_i.
    k_rows = keys[:, :, rows].permute(2, 0, 1, 3)             # (ds+1, ds, kc, N)
    prod = mul(ext.unsqueeze(2), k_rows, qr.unsqueeze(1), tr.bits)
    acc = prod[:, 0]
    for j in range(1, ds):
        acc = (acc + prod[:, j]) % qr                        # (ds+1, kc, N)
    # Mod-down: the key prime's row to coefficient form, rounded by
    # (qk - 1) / 2, taken mod each q_i, transformed and subtracted; the
    # difference times qk^-1 mod q_i is added to result.
    half = qk >> 1
    last = (inverse(acc[ds:], tk, mul)[0] + half) % qk        # (kc, N)
    qd = td.q.view(-1, 1, 1)
    spread = (last.unsqueeze(0) % qd - half % qd) % qd        # (ds, kc, N)
    down = forward(spread, td, mul)
    f = torch.tensor([int(v) for v in msf], dtype=torch.int64,
                     device=result.device).view(-1, 1, 1)
    delta = mul((acc[:ds] - down) % qd, f, qd, td.bits)       # (ds, kc, N)
    return ((result.transpose(0, 1) + delta) % qd).transpose(0, 1) \
        .contiguous()
