"""Key-switch cases shared by the CPU tests and the card's tests (no JAX
here: the card's test file imports none)."""

import numpy as np

from hexl_tpu_torch.limb import to_tensor


def worst_case_mac(moduli, ds, kms, n, device):
    """K10's inputs at their largest: t = 4 q_i - 1 off the diagonal (the
    (4, 4) forward transforms' range) and q_i - 1 on it (the target), keys
    q_m - 1; and the exact result, row i's sum of ds products mod q_i,
    from Python integers."""
    rows = list(moduli[:ds]) + [moduli[-1]]
    t = [[(4 * q - 1 if j != i else q - 1) for j in range(ds)]
         for i, q in enumerate(rows)]
    key = [q - 1 for q in moduli]
    key_idx = list(range(ds)) + [kms - 1]
    sums = [sum(t[i][j] * key[key_idx[i]] for j in range(ds))
            for i in range(ds + 1)]
    assert max(sums) < 1 << 128
    want = [s % q for s, q in zip(sums, rows)]

    def u64(values, shape):
        arr = np.array(values, dtype=np.uint64).reshape(shape + (1,))
        return to_tensor(np.broadcast_to(arr, shape + (n,)).copy(), device)

    t = u64(t, (ds + 1, ds))
    keys = u64([[key] * 2] * ds, (ds, 2, kms))
    return t, keys, u64([[w] * 2 for w in want], (ds + 1, 2)), max(sums)
