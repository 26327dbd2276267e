"""The paper's LSM on device tensors (PyTorch counterpart of repro.core.lsm).

Layout: one arena
-----------------
The sorted view of the write buffer and the levels live in ONE pair of int32
arenas (`arena_kv`, `arena_val`) of b * 2^L slots, in newest-first order:

    [buffer (b) | level 0 (b) | level 1 (2b) | ... | level L-1 (b * 2^(L-1))]

so level i is the slice [b * 2^i, b * 2^(i+1)). `key_vars`, `values`,
`buf_sorted_kv` and `buf_sorted_val` are views of it. The arena IS the
newest-first concatenation of every run, which the count/range gather reads
without copying, and a cascade step merges [carry, level 0..j-1] straight
into level j's slice: the regions are disjoint.

State is updated IN PLACE. Every mutator returns the state object it was
given; the facade's linear handles (api/dictionary.py) make sure nobody reads
the old version.

Host scalars
------------
`r`, `buf_n` and `overflowed` are Python values on the host. Every change to
them is known on the host, except the survivor counts of cleanup and
maintain, which are read from the device there. So an update never waits on
the device. `lvl_debt` is device data (measured on merged runs) and stays a
tensor.

Empty slots hold placebos, which sort last and are invisible to queries.
The write buffer ("level -1", docs/DESIGN.md §5) stages ragged sub-batches
in arrival order and is queried as the newest run; only when more than b
elements are pending do the oldest b flush through the cascade.
"""

from __future__ import annotations

import dataclasses

import torch

from repro_torch import obs
from repro_torch.core import cascade
from repro_torch.core import semantics as sem
from repro_torch.kernels import ops


@dataclasses.dataclass(frozen=True)
class LSMConfig:
    """Static configuration: batch size b and level count L (capacity b*(2^L-1))."""

    batch_size: int
    num_levels: int

    def __post_init__(self):
        if self.batch_size < 1:
            raise ValueError("batch_size must be >= 1")
        if self.num_levels < 1:
            raise ValueError("num_levels must be >= 1")

    @property
    def capacity(self) -> int:
        return self.batch_size * ((1 << self.num_levels) - 1)

    @property
    def max_batches(self) -> int:
        return (1 << self.num_levels) - 1

    def level_size(self, i: int) -> int:
        return self.batch_size * (1 << i)


@dataclasses.dataclass
class LSMState:
    arena_kv: torch.Tensor   # int32[b * 2^L]: sorted buffer view, levels 0..L-1
    arena_val: torch.Tensor
    buf_kv: torch.Tensor     # int32[b]: staged lanes, arrival order
    buf_val: torch.Tensor
    buf_seq: torch.Tensor    # int32[b]: arrival rank (== position; b on placebo lanes)
    lvl_debt: torch.Tensor   # int32[L]: per-level reclaimable-stale estimate
    r: int                   # resident batches; bit i set <=> level i full
    buf_n: int               # buffer occupancy
    overflowed: bool         # latches when an update overflowed

    @property
    def batch_size(self) -> int:
        return self.buf_kv.shape[0]

    @property
    def num_levels(self) -> int:
        return (self.arena_kv.shape[0] // self.batch_size).bit_length() - 1

    def _levels(self, arena):
        b = self.batch_size
        return tuple(arena[b << i: b << (i + 1)] for i in range(self.num_levels))

    @property
    def key_vars(self):
        """Level i as a view: int32[b * 2^i]."""
        return self._levels(self.arena_kv)

    @property
    def values(self):
        return self._levels(self.arena_val)

    @property
    def buf_sorted_kv(self):
        """The buffer sorted by recency (ascending original key, newest first
        within equal keys, placebos last): the newest run of every query."""
        return self.arena_kv[: self.batch_size]

    @property
    def buf_sorted_val(self):
        return self.arena_val[: self.batch_size]


def level_view(cfg: LSMConfig, state: LSMState, i: int):
    """Level i as a (sorted, possibly all-placebo) run: views of the arena."""
    return state.key_vars[i], state.values[i]


def level_runs(cfg: LSMConfig, state: LSMState):
    """All levels as (key_vars, values) runs, newest (level 0) first."""
    return list(zip(state.key_vars, state.values))


def buffer_run(cfg: LSMConfig, state: LSMState):
    """The write buffer as a sorted run (the newest run)."""
    return state.buf_sorted_kv, state.buf_sorted_val


def all_runs(cfg: LSMConfig, state: LSMState):
    """Every queryable run, newest first: write buffer, then levels 0..L-1."""
    return [buffer_run(cfg, state)] + level_runs(cfg, state)


def arena_view(state: LSMState):
    """All levels concatenated, without the buffer (debug/test helper). A
    copy: the mutators update the arena in place, and a caller snapshots
    this to see that an op left the levels as they were."""
    b = state.batch_size
    return state.arena_kv[b:].clone(), state.arena_val[b:].clone()


def _reset_buffer(state: LSMState) -> None:
    b = state.batch_size
    for t, fill in ((state.buf_kv, sem.PLACEBO_KV), (state.buf_val, sem.EMPTY_VALUE),
                    (state.buf_sorted_kv, sem.PLACEBO_KV), (state.buf_sorted_val, sem.EMPTY_VALUE),
                    (state.buf_seq, b)):
        t.fill_(fill)
    state.buf_n = 0


def compact_real(key_vars, values, mask):
    """Stable-partition the `mask` lanes to the front in arrival order; the
    other lanes become placebos -> (kv, val, count). Masked-out lanes scatter
    to a drop slot past the end, so nothing waits on the device."""
    n = key_vars.shape[0]
    pos = torch.where(mask, torch.cumsum(mask, 0) - 1, n)
    out_kv, out_val = sem.placebo(n + 1, key_vars.device)
    out_kv.scatter_(0, pos, key_vars)
    out_val.scatter_(0, pos, values)
    return out_kv[:n], out_val[:n], mask.sum().to(torch.int32)


def lsm_init(cfg: LSMConfig, device) -> LSMState:
    b = cfg.batch_size
    arena_kv, arena_val = sem.placebo(b << cfg.num_levels, device)
    buf_kv, buf_val = sem.placebo(b, device)
    return LSMState(
        arena_kv=arena_kv,
        arena_val=arena_val,
        buf_kv=buf_kv,
        buf_val=buf_val,
        buf_seq=torch.full((b,), b, dtype=torch.int32, device=device),
        lvl_debt=torch.zeros(cfg.num_levels, dtype=torch.int32, device=device),
        r=0,
        buf_n=0,
        overflowed=False,
    )


def lsm_stage(cfg: LSMConfig, state: LSMState, key_vars, values, count: int) -> LSMState:
    """Stage one encoded sub-batch into the write buffer ("level -1").

    key_vars/values: int32[b] with the `count` real lanes at the front in
    arrival order (a host int, 0 <= count <= b). The lanes append after the
    buffer's contents. If more than b elements are then pending, the OLDEST b
    flush through the cascade as one batch (sorted newest-first within equal
    keys) and the newest remainder stays in the buffer.
    """
    b = cfg.batch_size
    if key_vars.shape != (b,) or values.shape != (b,):
        raise ValueError(f"sub-batch must have shape ({b},), got {tuple(key_vars.shape)}/{tuple(values.shape)}")
    if not 0 <= count <= b:
        raise ValueError(f"count must be in [0, {b}], got {count}")
    with obs.span("lsm.stage"):
        total = state.buf_n + count
        pk, pv = sem.placebo(b, key_vars.device)
        staged_kv = torch.cat([state.buf_kv, pk])
        staged_val = torch.cat([state.buf_val, pv])
        staged_kv[state.buf_n: total] = key_vars[:count]
        staged_val[state.buf_n: total] = values[:count]
        if total > b:
            # The first b staged lanes are all real, in arrival order.
            state = cascade.push_batch(cfg, state, *ops.sort_pairs_recency(staged_kv[:b], staged_val[:b]))
            staged_kv, staged_val, total = staged_kv[b:], staged_val[b:], total - b
        else:
            staged_kv, staged_val = staged_kv[:b], staged_val[:b]
        skv, sval = ops.sort_pairs_recency(staged_kv, staged_val)
        state.buf_sorted_kv.copy_(skv)
        state.buf_sorted_val.copy_(sval)
        state.buf_kv.copy_(staged_kv)
        state.buf_val.copy_(staged_val)
        lane = torch.arange(b, dtype=torch.int32, device=key_vars.device)
        state.buf_seq.copy_(torch.where(lane < total, lane, b))
        state.buf_n = total
    return state


def lsm_update(cfg: LSMConfig, state: LSMState, key_vars, values) -> LSMState:
    """Insert a mixed batch of b encoded updates (inserts and/or tombstones).

    Paper §3.2/§4.1: sort the batch by the full key variable (a stable sort,
    so a tombstone beats any same-batch insert of its key and, among
    identical inserts, the earlier lane wins), then push it through the
    cascade. This is the direct, paper-exact path: it bypasses the write
    buffer, so with a non-empty buffer the staged elements would
    (incorrectly) rank as newer than this batch. As in the reference, callers
    keep the buffer empty or stage through `lsm_stage` (the facade).
    """
    b = cfg.batch_size
    key_vars = sem.as_int32(key_vars)
    values = sem.as_int32(values, key_vars.device)
    if key_vars.shape != (b,) or values.shape != (b,):
        raise ValueError(f"batch must have shape ({b},), got {tuple(key_vars.shape)}/{tuple(values.shape)}")
    carry_kv, carry_val = ops.sort_pairs(key_vars, values)
    return cascade.push_batch(cfg, state, carry_kv, carry_val)


def lsm_insert(cfg: LSMConfig, state: LSMState, keys, values) -> LSMState:
    """Insert a batch of b (key, value) pairs (original keys, not encoded)."""
    return lsm_update(cfg, state, sem.encode_insert(keys), values)


def lsm_delete(cfg: LSMConfig, state: LSMState, keys) -> LSMState:
    """Delete a batch of b keys via tombstones (paper §3.3)."""
    kv = sem.encode_delete(keys)
    return lsm_update(cfg, state, kv, torch.full_like(kv, sem.EMPTY_VALUE))


def lsm_update_mixed(cfg: LSMConfig, state: LSMState, keys, values, is_delete) -> LSMState:
    """Mixed batch: is_delete[i] selects tombstone vs regular insert."""
    kv = sem.encode(keys, is_delete)
    tomb = sem.is_tombstone(kv)
    return lsm_update(cfg, state, kv, torch.where(tomb, sem.EMPTY_VALUE, sem.as_int32(values, kv.device)))


def _bulk_batches(cfg: LSMConfig, n: int) -> int:
    k = -(-n // cfg.batch_size)  # the last batch may be placebo-padded
    if k > cfg.max_batches:
        raise ValueError("bulk build exceeds configured capacity")
    return k


def lsm_bulk_build(cfg: LSMConfig, keys, values) -> LSMState:
    """Build from n unique keys on their device: one sort, then the level
    segmentation of CLEANUP (paper §5.2).

    n need not be a multiple of b: the last resident batch is placebo-padded.
    More than `max_batches` batches raise ValueError.
    """
    keys = sem.as_int32(keys)
    values = sem.as_int32(values, keys.device)
    _bulk_batches(cfg, keys.shape[0])
    kv, vals = ops.sort_pairs(sem.encode_insert(keys), values)
    return lsm_build_sorted(cfg, kv, vals)


def lsm_build_sorted(cfg: LSMConfig, key_vars, values) -> LSMState:
    """The bulk build's levels from n sorted key variables of unique keys,
    on their device (the sharded build slices one sort into shards)."""
    n = key_vars.shape[0]
    b = cfg.batch_size
    k = _bulk_batches(cfg, n)
    state = lsm_init(cfg, key_vars.device)
    # Only the k * b slots the resident levels take need the placebo tail.
    sorted_kv, sorted_val = sem.placebo(k * b, key_vars.device)
    sorted_kv[:n], sorted_val[:n] = key_vars, values
    cascade.redistribute(cfg, sorted_kv, sorted_val, k, state.key_vars, state.values)
    state.r = k
    return state


def lsm_flush(cfg: LSMConfig, state: LSMState, min_pending: int = 1) -> LSMState:
    """Flush the write buffer through the cascade if it holds >= min_pending
    elements (never when empty). A partial buffer is placebo-padded to a
    full batch, which consumes one batch slot."""
    if state.buf_n >= max(int(min_pending), 1):
        # The sorted view IS the cascade-ready batch, and it lies outside the
        # levels, so the merge may read it in place.
        state = cascade.push_batch(cfg, state, state.buf_sorted_kv, state.buf_sorted_val)
        _reset_buffer(state)
    return state


def lsm_num_elements(cfg: LSMConfig, state: LSMState) -> int:
    """Resident element count, stale included: r * b + staged."""
    return state.r * cfg.batch_size + state.buf_n


def lsm_debt(cfg: LSMConfig, state: LSMState) -> torch.Tensor:
    """Total compaction debt (int32 device scalar): what `lsm_maintain` budgets against."""
    return state.lvl_debt.sum().to(torch.int32)


def lsm_flush_cost(cfg: LSMConfig, state: LSMState) -> int:
    """Elements the cascade would touch if the buffer flushed now, as the JAX
    reference estimates it: b * (trailing_ones(r) + 1); 0 when the buffer is
    empty."""
    if state.buf_n == 0:
        return 0
    trailing = 0
    while trailing < cfg.num_levels and (state.r >> trailing) & 1:
        trailing += 1
    return cfg.batch_size * (trailing + 1)
