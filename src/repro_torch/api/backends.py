"""Built-in backends: the paper's GPU LSM ("lsm") and its two baselines, the
sorted array ("sorted_array") and the static cuckoo hash ("cuckoo", §5.1).
The sharded LSM ("lsm_sharded") of repro.api.backends is a later part of the
port (ROADMAP.md queue A, item 10); `Dictionary.create` refuses it."""

from __future__ import annotations

import dataclasses
import math

import torch

from repro_torch.api.backend import Backend, Capabilities, OccupancyStats, register_backend
from repro_torch.api.plan import QueryPlan
from repro_torch.core import cleanup, queries
from repro_torch.core import cuckoo as ck
from repro_torch.core import sorted_array as sa
from repro_torch.core.lsm import (
    LSMConfig,
    all_runs,
    lsm_bulk_build,
    lsm_debt,
    lsm_flush,
    lsm_flush_cost,
    lsm_init,
    lsm_stage,
    lsm_update,
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

    @property
    def has_write_buffer(self) -> bool:
        return True

    def init(self):
        return lsm_init(self.cfg, self.device)

    def bulk_build(self, keys, values):
        return lsm_bulk_build(self.cfg, keys, values)

    def update_encoded(self, state, key_vars, values):
        return lsm_update(self.cfg, state, key_vars, values)

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


@register_backend
@dataclasses.dataclass(frozen=True)
class SortedArrayBackend(Backend):
    """One sorted run: O(n) per batch update (the Table 2 baseline), same
    query semantics as the LSM via the shared run-based pipelines."""

    name = "sorted_array"
    caps = Capabilities(
        supports_updates=True,
        supports_deletes=True,
        supports_ordered_queries=True,
        supports_cleanup=True,
    )

    cfg: sa.SAConfig
    b: int  # facade batch width; the SA core itself takes any width
    device: torch.device

    @classmethod
    def from_options(cls, *, device, capacity=None, batch_size=None, **extra):
        if extra:
            raise TypeError(f"unknown options for backend 'sorted_array': {sorted(extra)}")
        cap = int(capacity) if capacity is not None else 1 << 20
        b = int(batch_size) if batch_size is not None else min(1024, cap)
        return cls(sa.SAConfig(capacity=cap), b, torch.device(device))

    @property
    def batch_size(self) -> int:
        return self.b

    @property
    def capacity(self) -> int:
        return self.cfg.capacity

    def init(self):
        return sa.sa_init(self.cfg, self.device)

    def bulk_build(self, keys, values):
        return sa.sa_bulk_build(self.cfg, keys, values)

    def update_encoded(self, state, key_vars, values):
        return sa.sa_update_batch(self.cfg, state, key_vars, values)

    def stage_encoded(self, state, key_vars, values, count: int):
        # No staging buffer: apply at once with the recency sort. Staged
        # elements are the newest run either way, so queries agree with the
        # buffered LSM lane for lane (flush_state is a no-op).
        return sa.sa_stage(self.cfg, state, key_vars, values, count)

    def occupancy(self, state):
        # No buffer, no debt tracker: everything lives in the one run.
        return OccupancyStats(pending=0, resident=state.n, debt=0)

    def lookup(self, state, keys):
        return sa.sa_lookup(self.cfg, state, keys)

    def count(self, state, k1, k2, plan: QueryPlan):
        return sa.sa_count(self.cfg, state, k1, k2, plan.max_candidates)

    def range(self, state, k1, k2, plan: QueryPlan):
        return sa.sa_range(self.cfg, state, k1, k2, plan.max_candidates, plan.max_results)

    def cleanup(self, state):
        return sa.sa_cleanup(self.cfg, state)

    def size(self, state):
        return sa.sa_size(self.cfg, state)

    def overflowed(self, state) -> bool:
        return bool(state.n > self.cfg.capacity)


@register_backend
@dataclasses.dataclass(frozen=True)
class CuckooBackend(Backend):
    """Static cuckoo hash (CUDPP-style): O(1) lookups, bulk build only, no
    ordered queries (the paper's Table 1 comparison)."""

    name = "cuckoo"
    caps = Capabilities(
        supports_updates=False,
        supports_deletes=False,
        supports_ordered_queries=False,
        supports_cleanup=False,
    )

    cfg: ck.CuckooConfig
    declared_capacity: int
    device: torch.device

    @classmethod
    def from_options(cls, *, device, capacity=None, load_factor=0.8, seed=0, max_rounds=100,
                     batch_size=None, **extra):
        if extra:
            raise TypeError(f"unknown options for backend 'cuckoo': {sorted(extra)}")
        del batch_size  # accepted for create() symmetry; meaningless here
        cap = int(capacity) if capacity is not None else 1 << 20
        table_size = max(int(cap / float(load_factor)), 1)
        return cls(ck.CuckooConfig(table_size=table_size, max_rounds=int(max_rounds), seed=int(seed)),
                   cap, torch.device(device))

    @property
    def batch_size(self) -> int:
        return 1  # no incremental updates; the facade never splits for cuckoo

    @property
    def capacity(self) -> int:
        return self.declared_capacity

    def init(self):
        m = self.cfg.table_size
        return ck.CuckooTable(
            slot_keys=torch.full((m,), ck.EMPTY, dtype=torch.int32, device=self.device),
            slot_vals=torch.zeros(m, dtype=torch.int32, device=self.device),
            build_ok=True,
        )

    def bulk_build(self, keys, values):
        return ck.cuckoo_build(self.cfg, keys, values)

    def lookup(self, state, keys):
        return ck.cuckoo_lookup(self.cfg, state, keys)

    def size(self, state):
        return (state.slot_keys != ck.EMPTY).sum().to(torch.int32)

    def overflowed(self, state) -> bool:
        return not state.build_ok
