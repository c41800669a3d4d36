"""A one-axis device mesh and its two collectives (counterpart of
jax.sharding.Mesh and of the jax.lax.all_gather / all_to_all that
zkfl_tpu/parallel uses).

JAX's shard_map is single-controller: one process drives every device of a
Mesh.  The same holds here: one process drives a list of torch.devices, a
sharded tensor is a list of per-shard tensors (shard i on ``devices[i]``),
and a collective is an explicit copy of tensors between those devices.  The
list may name one device several times (``[cuda:0] * 4``): the shards then
run one after another on that device, at the per-shard widths, and the
collectives still move every block.
"""

from __future__ import annotations

from typing import List, Sequence

import torch


class Mesh:
    """A 1-D tuple of devices under one axis name; ``shape[axis_name]`` is
    the axis size, as jax.sharding.Mesh has it.  Meshes of the same devices
    and axis name are equal (per-mesh caches key on them)."""

    def __init__(self, devices: Sequence, axis_name: str):
        self.devices = tuple(torch.device(d) for d in devices)
        if not self.devices:
            raise ValueError("a mesh needs at least one device")
        self.axis_name = axis_name
        self.shape = {axis_name: len(self.devices)}

    def shard(self, x: torch.Tensor, dim: int) -> List[torch.Tensor]:
        """Split ``x`` into equal contiguous blocks along ``dim``, block i
        on device i (a view where it is already there)."""
        D = len(self.devices)
        if x.shape[dim] % D:
            raise ValueError(f"dimension {dim} of size {x.shape[dim]} does not split over {D} devices")
        return [part.to(dev) for part, dev in zip(x.chunk(D, dim), self.devices)]

    def __eq__(self, other) -> bool:
        return isinstance(other, Mesh) and (self.devices, self.axis_name) == \
            (other.devices, other.axis_name)

    def __hash__(self) -> int:
        return hash((self.devices, self.axis_name))

    def __repr__(self) -> str:
        return f"Mesh({[str(d) for d in self.devices]}, {self.axis_name!r})"


def all_gather(parts: Sequence[torch.Tensor], device: torch.device) -> torch.Tensor:
    """Each shard's tensor copied to ``device`` and stacked on a new leading
    axis (jax.lax.all_gather)."""
    return torch.stack([p.to(device) for p in parts])


def all_to_all(shards: Sequence[torch.Tensor], split_dim: int, concat_dim: int) -> List[torch.Tensor]:
    """The tiled exchange of jax.lax.all_to_all(..., tiled=True): shard i
    splits along ``split_dim`` into D blocks, block j goes to shard j's
    device, and shard j concatenates the blocks it receives along
    ``concat_dim`` in the order of their source shards."""
    D = len(shards)
    if any(s.shape[split_dim] % D for s in shards):
        raise ValueError(f"dimension {split_dim} does not split into {D} blocks")
    blocks = [s.chunk(D, split_dim) for s in shards]
    return [torch.cat([blocks[i][j].to(shards[j].device) for i in range(D)], dim=concat_dim)
            for j in range(D)]
