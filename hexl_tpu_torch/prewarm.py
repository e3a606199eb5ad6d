"""Cold-start prewarming for deployments: the port's `hexl_tpu.prewarm`.

A process's first transform of a shape pays for work that no later call
repeats: building the plan (the twiddle tables, from the g++-built host
library), copying its tables to the card, loading the kernels' libraries
(`_build`, which compiles them with nvcc if this checkout has not yet) and
the CUDA modules of the instantiations that shape launches. `prewarm` does
that ahead of serving, so that no request pays for it.

Usage:
    import hexl_tpu_torch
    hexl_tpu_torch.prewarm([(1 << 14, 60), (1 << 15, 50)], batch=256)

Each config runs the public NTT route forward at (IMF, OMF) = (1, 1) and
(4, 4) and inverse at (1, 1) and (2, 2), the four entry points the
composites chain, on one batch of `batch` polynomials.
"""

from __future__ import annotations

import time
from typing import Iterable, Sequence, Tuple

import numpy as np
import torch

from . import _build, _device, nt
from .limb import to_tensor


def prewarm(configs: Iterable[Tuple[int, int]], batch: int = 1,
            backends: Sequence[str] = ("xla",), verbose: bool = True,
            device=None):
    """Warm the NTT entry points for each (degree, q_or_q_bits) config.

    configs: iterable of (n, q); q is taken as a modulus when it is above
             2^20, else as a bit width for `nt.generate_primes`.
    batch:   the leading batch dimension of the warm-up transforms.
    backends: the JAX package's names, mapped onto the port's routes:
             "xla" and "pallas" are both the port's NTT kernels (the
             public route: K1/K2, or K7 for q < 2^30 from N = 2^10, up to
             2^14 or 2^15; K5/K6 above); the port has one route per shape,
             so "pallas" runs the (1, 1) pair of it, "xla" all four entry
             points. "mxu" is `ntt.fwd_ntt_mxu`/`inv_ntt_mxu` (K14/K15).
             Any other name raises ValueError.
    device:  default CUDA; on "cpu" nothing is built and the plain
             versions run.

    Returns a list of (n, q, backend, seconds) records. Each record times
    its backend's transforms, synchronised; the first backend of a config
    also builds the plan and, in its first transform, copies the tables to
    the device; on CUDA the first record also includes
    `_build.build_all()` (the nvcc build, or only the check that it is on
    disk).
    """
    from .ntt import NTT, fwd_ntt_mxu, get_mxu_plan, inv_ntt_mxu

    dev = _device.resolve(device)
    cuda = dev.type == "cuda"
    records = []
    rng = np.random.default_rng(0)
    for i, (n, q_spec) in enumerate(configs):
        q = (int(q_spec) if int(q_spec) > (1 << 20)
             else int(nt.generate_primes(1, int(q_spec), True,
                                         ntt_size=n)[0]))
        t0 = time.perf_counter()
        if cuda and i == 0:
            _build.build_all()
        engine = NTT(n, q, device=dev)
        x = to_tensor(rng.integers(0, q, size=(batch, n), dtype=np.uint64),
                      dev)
        for backend in backends:
            if backend == "xla":
                for imf, omf in ((1, 1), (4, 4)):
                    engine.forward(x, imf, omf)
                for imf, omf in ((1, 1), (2, 2)):
                    engine.inverse(x, imf, omf)
            elif backend == "pallas":
                engine.forward(x, 1, 1)
                engine.inverse(x, 1, 1)
            elif backend == "mxu":
                mplan = get_mxu_plan(n, q)
                fwd_ntt_mxu(x, mplan, 1, 1)
                inv_ntt_mxu(x, mplan, 1, 1)
            else:
                raise ValueError(f"unknown backend {backend!r}")
            if cuda:
                torch.cuda.synchronize(dev)
            dt = time.perf_counter() - t0
            records.append((n, q, backend, dt))
            if verbose:
                print(f"prewarm: n=2^{n.bit_length() - 1} q={q} "
                      f"[{backend}] {dt:.1f}s", flush=True)
            t0 = time.perf_counter()
    return records

