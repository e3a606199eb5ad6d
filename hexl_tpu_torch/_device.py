"""Device resolution: the port runs on the card unless asked for the CPU."""

from __future__ import annotations

import numpy as np
import torch

from .limb import to_tensor


def resolve(device=None) -> torch.device:
    """`device` as a torch.device; None means CUDA.

    Raises when CUDA is asked for (explicitly or by default) and no card is
    present: the port never falls back to the CPU by itself.
    """
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "hexl_tpu_torch: CUDA device requested but torch.cuda is not "
            "available; pass device='cpu' to run the plain PyTorch versions")
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {dev}")
    return dev


def operands(values, device=None):
    """(tensors, host) for the operands of a public function.

    int64 tensors of u64 bits stay on their device (made contiguous);
    numpy uint64 operands go to that device too, else to `device` resolved.
    `host` is True iff an operand was numpy: the result then goes back to
    numpy, as in the JAX package. Tensors on different devices are an
    error."""
    devs = {v.device for v in values if isinstance(v, torch.Tensor)}
    if len(devs) > 1:
        raise ValueError(f"operands lie on different devices: {devs}")
    # A tensor's device needs no lookup: a CUDA tensor proves a card.
    dev = devs.pop() if devs else resolve(device)
    tensors = [v.contiguous() if isinstance(v, torch.Tensor)
               else to_tensor(np.asarray(v, dtype=np.uint64), dev)
               for v in values]
    return tensors, not all(isinstance(v, torch.Tensor) for v in values)


def broadcast(tensors):
    """The operands broadcast to one shape, each contiguous; operands that
    do not broadcast are an error, as in the JAX package."""
    try:
        shape = torch.broadcast_shapes(*(t.shape for t in tensors))
    except RuntimeError:
        raise ValueError("operands do not broadcast: " + " vs ".join(
            str(tuple(t.shape)) for t in tensors)) from None
    return [t.expand(shape).contiguous() for t in tensors]
