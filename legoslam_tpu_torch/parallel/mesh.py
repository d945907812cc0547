"""The process group window BA shards over (twin of
legoslam_tpu/parallel/mesh.py).

The reference describes its devices as a one-axis `jax.sharding.Mesh`
named "ba".  Here the axis is a `torch.distributed` process group: one
process per device, each knowing its rank, the world size and its device.
Nothing on a machine tells the processes of each other: the caller starts
them and calls `torch.distributed.init_process_group` (address, world size
and rank given explicitly) before `make_mesh`.  NCCL serves CUDA tensors,
gloo CPU tensors.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Dict, Optional

import torch
import torch.distributed as dist

BA_AXIS = "ba"


@dataclass(frozen=True)
class Mesh:
    """One axis of `world_size` processes; this process is `rank` and
    computes on `device`."""

    rank: int
    world_size: int
    device: torch.device
    group: Any = None     # None: the default process group
    axis: str = BA_AXIS

    @property
    def shape(self) -> Dict[str, int]:
        return {self.axis: self.world_size}


def make_mesh(device=None, group: Optional[Any] = None, axis: str = BA_AXIS) -> Mesh:
    """Describe the initialized process group (`group`, or the default).
    `device` defaults to the current card under NCCL and the CPU otherwise."""
    if not dist.is_initialized():
        raise RuntimeError("torch.distributed is not initialized: call init_process_group first")
    if device is None:
        nccl = dist.get_backend(group) == "nccl"
        device = torch.device("cuda", torch.cuda.current_device()) if nccl else torch.device("cpu")
    return Mesh(rank=dist.get_rank(group), world_size=dist.get_world_size(group), device=torch.device(device),
                group=group, axis=axis)
