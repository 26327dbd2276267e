"""Built-in backends. This package has the paper's GPU LSM ("lsm") so far;
the sorted array, the cuckoo hash and the sharded LSM of repro.api.backends
are later parts of the port (ROADMAP.md)."""

from __future__ import annotations

import dataclasses
import math

import torch

from repro_torch.api.backend import Backend, Capabilities, OccupancyStats, register_backend
from repro_torch.api.plan import QueryPlan
from repro_torch.core import cleanup, queries
from repro_torch.core.lsm import (
    LSMConfig,
    all_runs,
    lsm_debt,
    lsm_flush,
    lsm_flush_cost,
    lsm_init,
    lsm_stage,
)


def _levels_for(capacity: int, batch_size: int) -> int:
    """Smallest L with b * (2^L - 1) >= capacity."""
    batches = -(-capacity // batch_size)
    return max(1, math.ceil(math.log2(batches + 1)))


@register_backend
@dataclasses.dataclass(frozen=True)
class LSMBackend(Backend):
    """The paper's GPU LSM: amortized O(b log r) updates, ordered queries."""

    name = "lsm"
    caps = Capabilities(
        supports_updates=True,
        supports_deletes=True,
        supports_ordered_queries=True,
        supports_cleanup=True,
        supports_maintenance=True,
    )

    cfg: LSMConfig
    device: torch.device

    @classmethod
    def from_options(cls, *, device, capacity=None, batch_size=None, num_levels=None, **extra):
        if extra:
            raise TypeError(f"unknown options for backend 'lsm': {sorted(extra)}")
        b = int(batch_size) if batch_size is not None else 1024
        if num_levels is None:
            num_levels = _levels_for(int(capacity) if capacity else b * 1023, b)
        return cls(LSMConfig(batch_size=b, num_levels=int(num_levels)), torch.device(device))

    @property
    def batch_size(self) -> int:
        return self.cfg.batch_size

    @property
    def capacity(self) -> int:
        return self.cfg.capacity

    @property
    def max_query_candidates(self) -> int:
        # Levels plus the b write-buffer slots a query window can overlap.
        return self.cfg.capacity + self.cfg.batch_size

    def init(self):
        return lsm_init(self.cfg, self.device)

    def bulk_build(self, keys, values):
        raise NotImplementedError(
            "repro_torch's LSM has no bulk_build yet: it needs the bitonic sort "
            "kernel, which ROADMAP.md queue B lists for the next slice of the port "
            "(B2 bitonic_sort_pairs, with lsm_bulk_build and Dictionary.bulk_build)"
        )

    def stage_encoded(self, state, key_vars, values, count: int):
        return lsm_stage(self.cfg, state, key_vars, values, count)

    def flush_state(self, state, min_pending: int = 1):
        return lsm_flush(self.cfg, state, min_pending)

    def pending_count(self, state) -> int:
        return state.buf_n

    def occupancy(self, state):
        return OccupancyStats(
            pending=state.buf_n,
            resident=state.r * self.cfg.batch_size,
            debt=lsm_debt(self.cfg, state),
        )

    def flush_cost(self, state) -> int:
        return lsm_flush_cost(self.cfg, state)

    def lookup(self, state, keys):
        return queries.lsm_lookup(self.cfg, state, keys)

    def count(self, state, k1, k2, plan: QueryPlan):
        return queries.lsm_count(self.cfg, state, k1, k2, plan.max_candidates)

    def range(self, state, k1, k2, plan: QueryPlan):
        return queries.lsm_range(self.cfg, state, k1, k2, plan.max_candidates, plan.max_results)

    def cleanup(self, state):
        return cleanup.lsm_cleanup(self.cfg, state)

    def maintain_state(self, state, budget, *, only_if_debt=False):
        return cleanup.lsm_maintain(self.cfg, state, budget, only_if_debt=only_if_debt)

    def size(self, state):
        return queries.valid_count_runs(all_runs(self.cfg, state))

    def overflowed(self, state) -> bool:
        return state.overflowed
