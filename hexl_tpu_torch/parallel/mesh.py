"""A mesh of torch devices driven by one process, and its exchanges.

The counterpart of `jax.sharding.Mesh` and of the collectives that the JAX
package's parallel layer runs inside `jax.shard_map`. The JAX package is
single-controller: one process drives every device of a mesh, and its tests
place several mesh positions on one CPU (virtual devices). Here a mesh is a
grid of `torch.device`s in the same way, driven by this process; one device
may hold several positions, as one card does on a machine with one GPU. A
multi-process `torch.distributed` world needs one card per rank, so it
cannot run these paths on such a machine.

A value on the mesh is a `Sharded`: one tensor per position, each on its
position's device. The coefficient axis (the last) is cut into contiguous
shards over the "coeff" axis; one axis of the leading dims may be cut over
the "batch" axis, or the leading dims are replicated over it (every batch
row then holds the same values and the result is row 0's, as with
`shard_map`). The exchanges between positions are copies, not kernels:
pieces that cross devices go by `Tensor.to(non_blocking=True)`
(peer-to-peer between cards), and pieces already on the destination's
device are gathered there by one `torch.stack` per destination. Nothing
here synchronises the host, but for a copy to the host. `exchanges`
counts the exchange copies and their bytes since the last
`reset_exchanges`; `scatter` and `gather` (the placement of a public
call's operands and results) are not counted.
"""

from __future__ import annotations

import collections
from dataclasses import dataclass
from typing import List, Optional

import numpy as np
import torch

from .. import _device

# Exchange copies ("copies") and their bytes ("bytes") since the last reset;
# read by chip_smoke.py beside the launch counts.
exchanges: collections.Counter = collections.Counter()


def reset_exchanges() -> None:
    exchanges.clear()


class Mesh:
    """A grid of torch devices with named axes, as `jax.sharding.Mesh`.

    devices: an array (nested lists or numpy) of devices shaped by the
    axes; `shape` maps each axis name to its size."""

    def __init__(self, devices, axis_names):
        grid = np.empty(np.shape(np.asarray(devices, dtype=object)),
                        dtype=object)
        for index, dev in np.ndenumerate(np.asarray(devices, dtype=object)):
            grid[index] = torch.device(dev)
        if grid.ndim != len(axis_names):
            raise ValueError(f"devices of shape {grid.shape} for axes "
                             f"{tuple(axis_names)}")
        self.devices = grid
        self.axis_names = tuple(axis_names)
        self.shape = collections.OrderedDict(zip(self.axis_names, grid.shape))

    def key(self) -> tuple:
        """The mesh's identity: its devices and axes."""
        return (tuple(str(d) for d in self.devices.flat),
                tuple(self.shape.items()))

    def distinct_devices(self) -> int:
        return len({str(d) for d in self.devices.flat})

    def __repr__(self) -> str:
        return f"Mesh({dict(self.shape)}, devices={list(self.devices.flat)})"


def mesh_devices(count: int, devices) -> list:
    """The first `count` of `devices` as torch devices, each one checked
    (a CUDA device needs a card). None means CUDA devices 0 .. count-1,
    which the host must have: positions are never laid over fewer cards,
    or over the CPU, unless the caller lists them so."""
    if devices is None:
        cards = torch.cuda.device_count() if torch.cuda.is_available() else 0
        if cards < count:
            raise RuntimeError(
                f"hexl_tpu_torch: a mesh of {count} positions needs {count} "
                f"CUDA devices, the host has {cards}; pass devices= (e.g. "
                f"['cuda:0'] * {count}, or ['cpu'] * {count})")
        devices = [torch.device("cuda", i) for i in range(count)]
    devices = list(devices)
    if len(devices) < count:
        raise ValueError(f"{count} mesh positions, {len(devices)} devices")
    out = []
    for dev in devices[:count]:
        dev = _device.resolve(dev)
        if dev.type == "cuda" and dev.index is None:
            dev = torch.device("cuda", torch.cuda.current_device())
        out.append(dev)
    return out


def move(t: torch.Tensor, device: torch.device) -> torch.Tensor:
    """t on `device`: without waiting when it goes to a card, and waiting
    for a copy to the host, which would otherwise be read before it
    lands."""
    return t.to(device, non_blocking=device.type == "cuda")


@dataclass
class Sharded:
    """A value on a (batch, coeff) mesh: parts[b][r] is position (b, r)'s
    tensor, holding coefficient shard r. batch_axis is the axis of the
    whole array cut over the batch rows, or None where they replicate it."""

    mesh: Mesh
    parts: List[List[torch.Tensor]]
    batch_axis: Optional[int]


def local(fn, *values) -> Sharded:
    """fn at every position on its parts of `values`, each a Sharded value
    or a list of them (passed to fn as the list of their parts); the
    layout is the first value's."""
    first = values[0] if isinstance(values[0], Sharded) else values[0][0]

    def part(v, b, r):
        if isinstance(v, Sharded):
            return v.parts[b][r]
        return [u.parts[b][r] for u in v]

    return Sharded(first.mesh, [
        [fn(*(part(v, b, r) for v in values)) for r in range(len(row))]
        for b, row in enumerate(first.parts)], first.batch_axis)


def scatter(x: torch.Tensor, mesh: Mesh,
            batch_axis: Optional[int]) -> Sharded:
    """x (..., N) placed on the mesh: shard r of the last axis to coeff
    position r; batch row b gets slice b of `batch_axis` (which the batch
    axis must divide), or all of x when batch_axis is None."""
    n_batch, n_coeff = mesh.shape["batch"], mesh.shape["coeff"]
    if x.shape[-1] % n_coeff:
        raise ValueError(f"the coefficient axis ({x.shape[-1]}) is not cut "
                         f"by the {n_coeff} coeff positions")
    width = x.shape[-1] // n_coeff
    if batch_axis is not None and x.shape[batch_axis] % n_batch:
        raise ValueError(f"axis {batch_axis} of {tuple(x.shape)} is not cut "
                         f"by the {n_batch} batch rows")
    parts = []
    for b in range(n_batch):
        row = x
        if batch_axis is not None:
            rows = x.shape[batch_axis] // n_batch
            row = x.narrow(batch_axis, b * rows, rows)
        parts.append([
            move(row[..., r * width:(r + 1) * width],
                 mesh.devices[b, r]).contiguous()
            for r in range(n_coeff)])
    return Sharded(mesh, parts, batch_axis)


def gather(x: Sharded, device: torch.device) -> torch.Tensor:
    """The whole array of a Sharded value, on `device`."""
    rows = [torch.cat([move(p, device) for p in row], dim=-1)
            for row in x.parts]
    if x.batch_axis is None:
        return rows[0]
    return torch.cat(rows, dim=x.batch_axis)


def _count(t: torch.Tensor) -> None:
    exchanges["copies"] += 1
    exchanges["bytes"] += t.numel() * t.element_size()


def all_to_all(blocks: List[torch.Tensor], devices) -> List[torch.Tensor]:
    """The exchange of one batch row over the coeff axis (`all_to_all` with
    split axis = concat axis = -2, tiled=False): blocks[r] is position r's
    (..., D, w) block; position c receives out[c] with
    out[c][..., r, :] = blocks[r][..., c, :]."""
    out = []
    for c, dev in enumerate(devices):
        pieces = []
        for block in blocks:
            piece = block[..., c, :]
            if piece.device != dev:
                piece = move(piece, dev)
                _count(piece)
            pieces.append(piece)
        out.append(torch.stack(pieces, dim=-2))
        _count(out[-1])
    return out


def ring_send(x: torch.Tensor, device: torch.device) -> torch.Tensor:
    """One step of the ring (`ppermute` to the next position): x on the next
    position's device, copied only when it lies elsewhere."""
    if x.device == device:
        return x
    out = move(x, device)
    _count(out)
    return out
