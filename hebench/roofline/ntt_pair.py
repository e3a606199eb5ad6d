"""Counts of one call pair `RnsNTT.forward` then `RnsNTT.inverse` on
(rows, polys, N): each call reads its input once and writes its output
once (8 bytes a residue), and each limb transform takes (N/2) log2 N
modular products (the inverse's scaling by N^-1 left out)."""


def counts(n: int, rows: int, polys: int) -> dict:
    log_n = n.bit_length() - 1
    limbs = rows * polys
    return {"bytes": 4 * 8 * limbs * n,
            "products": 2 * limbs * (n // 2) * log_n,
            "limb_transforms": 2 * limbs}
