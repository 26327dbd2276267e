"""Meshes (PyTorch counterpart of repro.launch.mesh).

`Mesh` describes the LM stack's data x model (x pod) layout: ordered axis
names, their sizes, and the devices, or None for an abstract mesh (the 256
or 512 chips of a production mesh, which the sharding plan and the dry run
reason about without holding them, as jax's AbstractMesh does). No process
group is made: a plan is a function of a leaf's shape and the mesh's sizes.

`ShardMesh` is the 1-D dictionary-shard mesh of the `lsm_sharded` backend
(counterpart of make_shard_mesh). The reference runs `shard_map` over a 1-D
jax mesh from one Python process. Its counterpart here is one controller
over a tuple of devices, one per shard: core/distributed.py runs each
shard's work on its device in turn and combines on the first shard's
device. A device may be named several times, so several shards can share
one card (or the CPU), as the reference's tests spoof 4 host devices with
--xla_force_host_platform_device_count.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Dict, Optional, Sequence, Tuple

import torch


@dataclasses.dataclass(frozen=True)
class Mesh:
    """Axis `axis_names[i]` has `axis_sizes[i]` devices; `devices` lists them
    in row-major order over the axes, or is None (abstract)."""

    axis_names: Tuple[str, ...]
    axis_sizes: Tuple[int, ...]
    devices: Optional[Tuple[torch.device, ...]] = None

    def __post_init__(self):
        if len(self.axis_names) != len(self.axis_sizes):
            raise ValueError(f"axis names {self.axis_names} and sizes {self.axis_sizes} differ in length")
        if self.devices is not None and len(self.devices) != self.size:
            raise ValueError(f"a {self.axis_sizes} mesh needs {self.size} devices, got {len(self.devices)}")

    @property
    def shape(self) -> Dict[str, int]:
        return dict(zip(self.axis_names, self.axis_sizes))

    @property
    def size(self) -> int:
        return math.prod(self.axis_sizes)


def make_mesh(axis_sizes, axis_names, devices: Optional[Sequence] = None) -> Mesh:
    return Mesh(tuple(axis_names), tuple(int(n) for n in axis_sizes),
                None if devices is None else tuple(torch.device(d) for d in devices))


def make_production_mesh(*, multi_pod: bool = False) -> Mesh:
    """16x16 chips per pod; multi_pod adds a leading 2-pod axis (512 chips). Abstract."""
    if multi_pod:
        return make_mesh((2, 16, 16), ("pod", "data", "model"))
    return make_mesh((16, 16), ("data", "model"))


def make_debug_mesh(data: int = 2, model: int = 2, pod: int = 0, devices: Optional[Sequence] = None) -> Mesh:
    """A small mesh for tests; abstract unless `devices` are named (a device
    may be named several times, as ShardMesh allows)."""
    if pod:
        return make_mesh((pod, data, model), ("pod", "data", "model"), devices)
    return make_mesh((data, model), ("data", "model"), devices)


@dataclasses.dataclass(frozen=True)
class ShardMesh:
    """Shard s lives on `devices[s]`; `shape[axis]` is the shard count."""

    devices: Tuple[torch.device, ...]
    axis_names: Tuple[str, ...]

    @property
    def shape(self) -> Dict[str, int]:
        return {self.axis_names[0]: len(self.devices)}


def make_shard_mesh(num_shards: Optional[int] = None, *, axis: str = "shard",
                    devices: Optional[Sequence] = None) -> ShardMesh:
    """A mesh over the first `num_shards` of `devices`.

    `devices=None` takes the visible CUDA devices, and raises when there is
    none: the shards never fall back to the CPU unless the caller names it.
    `num_shards=None` takes every device of the pool.
    """
    if devices is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "make_shard_mesh places shards on CUDA devices and none is available; "
                "pass devices=['cpu'] * num_shards to run them on the CPU"
            )
        pool = [torch.device("cuda", i) for i in range(torch.cuda.device_count())]
    else:
        pool = [torch.device(d) for d in devices]
    if num_shards is None:
        num_shards = len(pool)
    num_shards = int(num_shards)
    if num_shards < 1:
        raise ValueError(f"num_shards must be >= 1, got {num_shards}")
    if num_shards > len(pool):
        raise ValueError(
            f"num_shards={num_shards} exceeds the {len(pool)} visible "
            "device(s); name a device several times (devices=[...]) to put "
            "several shards on one"
        )
    return ShardMesh(tuple(pool[:num_shards]), (axis,))
