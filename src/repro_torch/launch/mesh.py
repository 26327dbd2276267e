"""The 1-D dictionary-shard mesh of the `lsm_sharded` backend (PyTorch
counterpart of repro.launch.mesh.make_shard_mesh).

The reference runs `shard_map` over a 1-D jax mesh from one Python process.
Its counterpart here is one controller over a tuple of devices, one per
shard: core/distributed.py runs each shard's work on its device in turn and
combines on the first shard's device. A device may be named several times,
so several shards can share one card (or the CPU), as the reference's tests
spoof 4 host devices with --xla_force_host_platform_device_count.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Optional, Sequence, Tuple

import torch


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
