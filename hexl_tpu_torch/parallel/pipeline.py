"""Stage-pipelined NTT over a ring of mesh positions, and the wrapper of
kernel K16 (`csrc/stage.cu`).

The counterpart of `hexl_tpu/parallel/pipeline.py`. The transform's log2(N)
radix-2 stages are split into D contiguous runs (`_partition`, front-loaded
like GPipe's layer assignment), position d of a 1-axis ("pp",) ring owns
run d, and microbatches (the leading axis of the input) stream through the
ring: at tick t position 0 takes microbatch t, every position applies its
run to the microbatch it holds (t - d), position D-1 banks the finished
microbatch t - (D-1), and each buffer moves on to the next position. The
schedule has M + D - 1 ticks; position D-1's results are the output (the
JAX package broadcasts them with a psum). Positions holding no microbatch
(the pipeline's fill and drain) skip the work the JAX program does on its
zero buffers, and the ring's last edge (D-1 -> 0), which carries only
finished microbatches that position 0 discards, is not sent: neither
changes an output.

Each stage is one launch of K16, the flat walk's stage in one kernel
(forward stage m reads rop[m + k], inverse stage t irop[root_index(N, t) +
k], the inverse's last stage fused with N^-1), with the OMF of the last
run fused into the transform's last stage: reduce_mod_lazy64 forward,
cond_sub inverse. Its plain version is the flat walk cut by stage
(`torch_ntt.fwd_stages`, `inv_stages`, `inv_final`). The JAX package runs
exact Harvey butterflies here on the CPU; the port is exact everywhere, so
outputs are bit-equal, lazy ones included. Launches count under "K16".
"""

from __future__ import annotations

import ctypes

import numpy as np
import torch

from .. import _build, _device
from ..limb import reduce_mod_lazy64, to_numpy
from ..ntt import torch_ntt
from ..ntt.plan import get_plan
from .mesh import Mesh, mesh_devices, move, ring_send

_P = ctypes.c_void_p
_U = ctypes.c_uint64
_I = ctypes.c_int
_STAGE_ARGS = (_P, _P, _P, _P, _U, _U, _U, _U, _U, _I, _I, _I, _I, _I, _I,
               _P)


def _partition(k: int, d: int):
    """Split k stages into d contiguous runs, sizes differing by <= 1
    (front-loaded, like GPipe layer assignment)."""
    base, extra = divmod(k, d)
    sizes = [base + (1 if i < extra else 0) for i in range(d)]
    bounds = np.cumsum([0] + sizes)
    return [(int(bounds[i]), int(bounds[i + 1])) for i in range(d)]


# -- stage runs: plain version and K16 ----------------------------------------

def stages_plain(x: torch.Tensor, plan, forward: bool, first: int,
                 stop: int, omf: int) -> torch.Tensor:
    """Stages first .. stop-1 of the flat walk on x (..., N): forward stage
    k has 2^k blocks, inverse stage k stride 2^k (the last one fused with
    N^-1). omf applies when the run ends with the transform's last stage."""
    log_n = plan.log_n
    if forward:
        x = torch_ntt.fwd_stages(x, plan, 1 << first, 1 << stop)
        if stop == log_n and omf == 1:
            x = reduce_mod_lazy64(x, plan.q, 4)
        return x
    x = torch_ntt.inv_stages(x, plan, 1 << first, 1 << min(stop, log_n - 1))
    if stop == log_n:
        x = torch_ntt.inv_final(x, plan, omf)
    return x


def stages(x: torch.Tensor, plan, forward: bool, first: int, stop: int,
           omf: int) -> torch.Tensor:
    """`stages_plain` as one K16 launch per stage on the GPU (the first
    into a new tensor, the rest in place on it), the plain version on the
    CPU."""
    if not _build.on_card(x):
        return stages_plain(x, plan, forward, first, stop, omf)
    if first >= stop:
        return x
    out = torch.empty_like(x)
    batch = _build.batch_of(x, plan.n)
    if batch == 0:
        return out
    w, wp = plan.twiddles(x.device, forward)
    fn = _build.function("stage", "hexl_stage", _STAGE_ARGS)
    log_n, src = plan.log_n, x
    for k in range(first, stop):
        final = int(k == log_n - 1)
        if forward:      # 2^k blocks, read from rop[2^k]
            log_t, at = log_n - 1 - k, 1 << k
        else:            # stride 2^k
            log_t, at = k, torch_ntt.root_index(plan.n, 1 << k)
        _build.launch_on(x.device, "K16", fn, src.data_ptr(), out.data_ptr(),
                         w[at:].data_ptr(), wp[at:].data_ptr(), plan.q,
                         *plan.fin(), log_n, log_t, int(forward), final, omf,
                         batch)
        src = out
    return out


class PipelineNTT:
    """Forward/inverse NTT with butterfly stages pipelined over a mesh
    axis. Microbatches (leading axis of the input) flow through the
    position ring; each position applies only its own stage run."""

    def __init__(self, degree: int, modulus: int, mesh: Mesh,
                 axis: str = "pp"):
        self.n = degree
        self.q = modulus
        self.mesh = mesh
        self.axis = axis
        self.d = mesh.shape[axis]
        self.plan = get_plan(degree, modulus)
        self.stages = degree.bit_length() - 1
        if self.stages < self.d:
            raise ValueError(
                f"degree 2^{self.stages} has fewer stages than pipeline "
                f"devices ({self.d})")

    def _ring(self) -> list:
        """The devices along `axis` (the first position of the others)."""
        index = [0] * self.mesh.devices.ndim
        index[self.mesh.axis_names.index(self.axis)] = slice(None)
        return list(self.mesh.devices[tuple(index)])

    def _apply(self, x, forward: bool, omf: int):
        ring = self._ring()
        (t,), host = _device.operands((x,), ring[0])
        if t.dim() < 2 or t.shape[-1] != self.n:
            raise ValueError("pipeline input must be (microbatch, ..., N)")
        runs = _partition(self.stages, self.d)
        m_count, d_count = t.shape[0], self.d
        x0 = move(t, ring[0])
        held = [None] * d_count           # (microbatch, tensor) per position
        done = [None] * m_count
        for tick in range(m_count + d_count - 1):
            if tick < m_count:
                held[0] = (tick, x0[tick])
            for d, (first, stop) in enumerate(runs):
                if held[d] is not None:
                    mb, v = held[d]
                    held[d] = (mb, stages(v, self.plan, forward, first, stop,
                                          omf))
            if held[-1] is not None:
                mb, v = held[-1]
                done[mb] = v
            # The ring send d -> d + 1.
            held = [None] + [
                None if h is None else (h[0], ring_send(h[1], ring[d + 1]))
                for d, h in enumerate(held[:-1])]
        out = torch.stack([move(v, t.device) for v in done])
        return to_numpy(out) if host else out

    def forward(self, x, input_mod_factor: int = 1,
                output_mod_factor: int = 1):
        """Forward NTT of (M, ..., N) microbatches through the pipeline.
        Input < IMF*q (IMF in {1,2,4}); OMF in {1,4}."""
        if input_mod_factor not in (1, 2, 4):
            raise ValueError("input_mod_factor must be 1, 2 or 4")
        if output_mod_factor not in (1, 4):
            raise ValueError("output_mod_factor must be 1 or 4")
        return self._apply(x, True, output_mod_factor)

    def inverse(self, x, input_mod_factor: int = 1,
                output_mod_factor: int = 1):
        """Inverse NTT of (M, ..., N) microbatches through the pipeline.
        Input < IMF*q (IMF in {1,2}); OMF in {1,2}."""
        if input_mod_factor not in (1, 2):
            raise ValueError("input_mod_factor must be 1 or 2")
        if output_mod_factor not in (1, 2):
            raise ValueError("output_mod_factor must be 1 or 2")
        return self._apply(x, False, output_mod_factor)


def make_pipeline_mesh(n_stages: int, devices=None) -> Mesh:
    """A 1-axis ('pp',) mesh over n_stages devices: the first n_stages of
    `devices` (repeats allowed), or CUDA devices 0 .. n_stages - 1 for
    None, which the host must have."""
    return Mesh(mesh_devices(n_stages, devices), ("pp",))
