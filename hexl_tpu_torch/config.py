"""The port's environment switches: the counterpart of `hexl_tpu/config.py`.

Five readers, each with the JAX package's variable and semantics:

  * `debug_checks()`: HEXL_TPU_DEBUG, the debug-mode input checks
    (`utils/check.py`);
  * `dist_overlap_slices()`: HEXL_TPU_DIST_OVERLAP, the slices of the
    distributed NTT's cross-phase exchange (`parallel/dist_ntt.py`);
  * `approx_mulhi_disabled()`: HEXL_TPU_DISABLE_APPROX, the kill switch of
    the approximate-quotient butterflies;
  * `approx_butterflies(device)`: whether `device` runs the approximate
    quotients of the JAX package's `config.approx_butterflies`: the
    lean16/lean8 butterflies of the 64-bit NTT, the "approx" ones of
    PipelineNTT's stages and the eltwise family's approximate Barrett and
    Shoup products;
  * `native_disabled()`: HEXL_TPU_DISABLE_NATIVE, which makes the plans
    and `nt` take their pure-Python forms instead of the g++-built host
    library (`native.py`).

The JAX package's other switches select TPU bodies the port does not have
(HEXL_TPU_NTT_BACKEND, NTT_RADIX, NTT_PACK, FFT_RADIX, FFT_PACK,
FFT_BACKEND, FORCE_PALLAS_ELTWISE, DISABLE_PALLAS) and are not read here.
No switch makes a tensor on the card run a plain version.
"""

from __future__ import annotations

import os

import torch

# Whether the lean pair beat the exact pair on the card at bench.py's shape
# (N = 2^14, 60-bit q, batch 256) beyond the spread of the timings; it did
# not (`approx_butterflies`).
CUDA_APPROX_DEFAULT = False


def _env_flag(name: str) -> bool:
    return os.environ.get(name, "").strip() not in ("", "0", "false", "False")


def debug_checks() -> bool:
    return _env_flag("HEXL_TPU_DEBUG")


def approx_mulhi_disabled() -> bool:
    """Kill switch of the approximate-quotient butterflies: with
    HEXL_TPU_DISABLE_APPROX set, every transform runs the exact Harvey
    butterflies."""
    return _env_flag("HEXL_TPU_DISABLE_APPROX")


def native_disabled() -> bool:
    """With HEXL_TPU_DISABLE_NATIVE set, `native` offers nothing and every
    caller computes in Python integers (the plain versions). Read at each
    call, so a test can set it for one block."""
    return _env_flag("HEXL_TPU_DISABLE_NATIVE")


def dist_overlap_slices() -> int:
    """HEXL_TPU_DIST_OVERLAP=S (S > 1) splits each cross-phase exchange of
    the distributed NTT into S slices, each with its own pair of
    exchanges; 0/unset keeps one exchange per phase."""
    v = os.environ.get("HEXL_TPU_DIST_OVERLAP", "0")
    try:
        return int(v)
    except ValueError:
        raise ValueError(
            f"HEXL_TPU_DIST_OVERLAP must be an integer; got {v!r}") from None


def approx_butterflies(device) -> bool:
    """Whether `device` runs the approximate quotients: the 64-bit NTT's
    lean16/lean8 butterflies (`ntt.torch_ntt.scheme_for`), PipelineNTT's
    "approx" stages (`parallel.pipeline.pipeline_scheme`) and the eltwise
    family's approximate bodies (`eltwise.ops`), as the JAX package's
    switch turns on its `jnp_ntt._bflys3`, `_bflys` and
    `jnp_kernels._approx`.

    Always False on the CPU, where the plain walk is the bit-exactness
    oracle (as the JAX package is exact on its CPU backend), and False
    with HEXL_TPU_DISABLE_APPROX set. On CUDA it is CUDA_APPROX_DEFAULT,
    which would be True only if the lean fwd+inv pair had measured faster
    than the exact one at bench.py's shape beyond the spread of the
    timings. It measured slower: on an NVIDIA H100 80GB HBM3 at a 700 W
    power limit (`chip_smoke.py`, phase 5), NTT(2^14, 60-bit) at batch 256
    took 0.2834 ms a pair exact (median of 40 CUDA-event timings, 0.2721 to
    0.3028) and 0.3146 ms in lean8 (0.3050 to 0.3390); replayed from CUDA
    graphs, 0.2487 and 0.2801 ms. On Hopper the approximate quotient costs
    as many multiplies as the exact one (8 IMADs each). The lean outputs
    equal the exact ones mod q (bit for bit when fully reduced); their lazy
    outputs differ in value. The approx butterflies and the eltwise
    approximate quotients, timed against their exact forms in turns on the
    same card (`chip_smoke.py` phase 5, two runs), were faster at no NTT
    row (1.01x to 1.40x the time) and within 3% at the eltwise rows (0.98x
    to 1.03x), so the default stays False for them too.
    """
    if approx_mulhi_disabled():
        return False
    return torch.device(device).type == "cuda" and CUDA_APPROX_DEFAULT
