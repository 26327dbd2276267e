"""Sorted-array (SA) baseline (paper §5.1) on device tensors: one big sorted
run (PyTorch counterpart of repro.core.sorted_array).

Updates merge the sorted incoming batch into the whole array: O(n) work per
batch against the LSM's O(b log r), the gap the paper's Table 2 measures.
The merge is the Merge Path kernel (`ops.merge_sorted`, batch as the newer
run `a`) into capacity + batch slots, of which the state keeps the first
`capacity` as a view: the placebo overflow past the end is dropped, as the
reference's `mode="drop"` scatter drops it. The caller keeps
live elements + batch <= capacity (`sa_would_overflow`).

The state is updated IN PLACE, as the LSM's is: every mutator returns the
state object it was given, with its arrays replaced. `n` (resident elements,
stale included, placebos excluded) stays an int32 device scalar, so an update
never waits on the device. Queries reuse the run-based pipelines of
core/queries.py with a single run.
"""

from __future__ import annotations

import dataclasses

import torch

from repro_torch.core import queries
from repro_torch.core import semantics as sem
from repro_torch.core.lsm import compact_real
from repro_torch.kernels import ops


@dataclasses.dataclass(frozen=True)
class SAConfig:
    capacity: int


@dataclasses.dataclass
class SAState:
    key_vars: torch.Tensor  # int32[capacity]
    values: torch.Tensor    # int32[capacity]
    n: torch.Tensor         # int32[]: resident elements (stale included, placebos excluded)


def sa_init(cfg: SAConfig, device) -> SAState:
    kv, val = sem.placebo(cfg.capacity, device)
    return SAState(kv, val, torch.zeros((), dtype=torch.int32, device=device))


def sa_bulk_build(cfg: SAConfig, keys, values) -> SAState:
    """Build from n unique keys on their device: one sort, placebo-padded."""
    keys = sem.as_int32(keys)
    values = sem.as_int32(values, keys.device)
    n = keys.shape[0]
    if n > cfg.capacity:
        raise ValueError("bulk build exceeds capacity")
    state = sa_init(cfg, keys.device)
    state.key_vars[:n], state.values[:n] = ops.sort_pairs(sem.encode_insert(keys), values)
    state.n.fill_(n)
    return state


def sa_update_batch(cfg: SAConfig, state: SAState, key_vars, values) -> SAState:
    """Merge a batch of encoded updates into the array (sort + full merge).

    In-batch duplicates follow the paper's rule: the full-key-variable sort
    puts a tombstone before any same-batch insert of its key, and among
    identical inserts the earlier lane first (the sort is stable)."""
    key_vars = sem.as_int32(key_vars)
    bkv, bval = ops.sort_pairs(key_vars, sem.as_int32(values, key_vars.device))
    return _sa_merge_sorted(cfg, state, bkv, bval)


def sa_stage(cfg: SAConfig, state: SAState, key_vars, values, count=None) -> SAState:
    """Apply one encoded sub-batch with the write-buffer recency rule.

    The SA has no staging buffer: applying at once is equivalent to the
    LSM's buffer-then-flush, since staged elements are queried as the newest
    run either way. The recency sort makes the later lane win, even a later
    insert over an earlier tombstone of the same call, unlike
    `sa_update_batch`'s paper rule. `count` is unused: placebo lanes are
    invisible and excluded from the occupancy count."""
    del count
    key_vars = sem.as_int32(key_vars)
    bkv, bval = ops.sort_pairs_recency(key_vars, sem.as_int32(values, key_vars.device))
    return _sa_merge_sorted(cfg, state, bkv, bval)


def _sa_merge_sorted(cfg: SAConfig, state: SAState, bkv, bval) -> SAState:
    merged_kv, merged_val = ops.merge_sorted(bkv, bval, state.key_vars, state.values)
    state.key_vars, state.values = merged_kv[: cfg.capacity], merged_val[: cfg.capacity]
    # Placebo padding lanes (facade partial batches) are not resident elements.
    state.n = state.n + (bkv != sem.PLACEBO_KV).sum().to(torch.int32)
    return state


def sa_insert(cfg: SAConfig, state: SAState, keys, values) -> SAState:
    return sa_update_batch(cfg, state, sem.encode_insert(keys), values)


def sa_delete(cfg: SAConfig, state: SAState, keys) -> SAState:
    kv = sem.encode_delete(keys)
    return sa_update_batch(cfg, state, kv, torch.full_like(kv, sem.EMPTY_VALUE))


def sa_would_overflow(cfg: SAConfig, state: SAState, batch: int) -> torch.Tensor:
    return state.n + batch > cfg.capacity


def sa_cleanup(cfg: SAConfig, state: SAState) -> SAState:
    """Purge stale elements (older duplicates, tombstones): the single-run
    analogue of the LSM's CLEANUP. Survivors compact to the front, the tail
    refills with placebos."""
    state.key_vars, state.values, state.n = compact_real(
        state.key_vars, state.values, queries.survivor_mask(state.key_vars)
    )
    return state


def _runs(state: SAState):
    return [(state.key_vars, state.values)]


def _flat(state: SAState):
    # The one run is its own concatenation: count/range gather from it directly.
    return state.key_vars, state.values


def sa_lookup(cfg: SAConfig, state: SAState, query_keys):
    return queries.lookup_runs(_runs(state), query_keys)


def sa_count(cfg: SAConfig, state: SAState, k1, k2, max_candidates: int):
    return queries.count_runs(_runs(state), k1, k2, max_candidates, _flat(state))


def sa_range(cfg: SAConfig, state: SAState, k1, k2, max_candidates: int, max_results: int):
    return queries.range_runs(_runs(state), k1, k2, max_candidates, max_results, _flat(state))


def sa_size(cfg: SAConfig, state: SAState) -> torch.Tensor:
    """Live (visible) elements (int32 device scalar): the survivor count of
    the one run, which is already merged."""
    return queries.survivor_mask(state.key_vars).sum().to(torch.int32)
