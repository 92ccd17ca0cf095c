"""Production meshes, the cache mesh and an abstract mesh for the sharding
rules, as `repro.launch.mesh` makes them.

A production mesh is a `torch.distributed` `DeviceMesh` with named
dimensions: (16, 16) over ("data", "model") for one pod, (2, 16, 16)
over ("pod", "data", "model") for two. Like the reference's, which needs
that many devices, it needs a process group of that world size
(`torch.distributed.init_process_group` first; the "fake" backend builds
one in a single process). Functions, not module constants, so that
importing this module touches no device and no process group.
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import numpy as np
import torch

from repro_torch.runtime.supervisor import DeviceGrid


@dataclasses.dataclass(frozen=True)
class AbstractMesh:
    """Axis names and sizes with no devices and no process group, the
    counterpart of `jax.sharding.AbstractMesh`: what the sharding rules
    read of a mesh (`mesh_dim_names` and `shape`, as a `DeviceMesh` has
    them)."""

    shape: Tuple[int, ...]
    mesh_dim_names: Tuple[str, ...]

    def __post_init__(self):
        if len(self.shape) != len(self.mesh_dim_names):
            raise ValueError(f"{len(self.shape)} sizes for "
                             f"{len(self.mesh_dim_names)} names")

    @property
    def axis_names(self) -> Tuple[str, ...]:
        return self.mesh_dim_names


def make_production_mesh(*, multi_pod: bool = False,
                         device_type: str = "cuda"):
    """16×16 (data, model) single pod; 2×16×16 (pod, data, model) for two
    pods = 512 ranks, over the default process group."""
    from torch.distributed.device_mesh import init_device_mesh
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    return init_device_mesh(device_type, shape, mesh_dim_names=axes)


def data_axes(mesh) -> tuple:
    """The axes a batch dimension shards over."""
    return tuple(a for a in mesh.mesh_dim_names if a in ("pod", "data"))


def model_axis(mesh) -> str:
    return "model"


def make_cache_mesh(n_shards: int, axis: str = "cache",
                    device: Optional[str] = None) -> DeviceGrid:
    """1-D mesh for the sharded segment cache's device tier: the first
    `n_shards` CUDA devices, as the reference takes the first local
    devices, in the record `ShardedSegmentCache.from_mesh` reads. With
    `device="cpu"` every shard sits on the CPU (the tests' setting)."""
    if device == "cpu":
        devices = [torch.device("cpu")] * n_shards
    elif device is None:
        count = torch.cuda.device_count()
        if n_shards > count:
            raise ValueError(f"n_shards {n_shards} > available devices "
                             f"{count}")
        devices = [torch.device("cuda", i) for i in range(n_shards)]
    else:
        raise ValueError(f"device must be None or 'cpu', got {device!r}")
    grid = np.empty(n_shards, dtype=object)
    grid[:] = devices
    return DeviceGrid(grid, (axis,))
