"""CLEANUP (paper §3.6 / §4.5) and budgeted incremental maintenance.

  * `lsm_cleanup` — the full rebuild: ONE K-way merge of the write buffer
    (newest) and every level, the survivor mask, compaction into a
    placebo-filled array of capacity slots, and a re-slice by the bits of the
    new resident count. Survivors beyond capacity (the buffer can add b) are
    dropped and the overflow latch is set.
  * `lsm_maintain(budget)` — compacts the deepest level PREFIX 0..j whose
    arena fits the budget (b * (2^(j+1) - 1) <= budget): newest per key
    survives; tombstones are purged only when no deeper level holds residents.
    A budget of None (or >= capacity + b) is a full cleanup; below b, a no-op.

Both read their survivor count from the device (the one host sync of each),
since it sets the new resident count. `only_if_debt=True` reads the prefix
debt from the device and skips the work when it is zero.
"""

from __future__ import annotations

import torch

from repro_torch.core import cascade
from repro_torch.core import semantics as sem
from repro_torch.core.lsm import LSMConfig, LSMState, _reset_buffer, all_runs, level_runs
from repro_torch.kernels import ops


def merge_all_levels(cfg: LSMConfig, state: LSMState):
    """Stable newest-first merge of every level into one sorted run."""
    return ops.merge_cascade(level_runs(cfg, state))


def lsm_cleanup(cfg: LSMConfig, state: LSMState) -> LSMState:
    from repro_torch.core.queries import survivor_mask

    b = cfg.batch_size
    merged_kv, merged_val = ops.merge_cascade(all_runs(cfg, state))
    compact_kv, compact_val, total = cascade.compact_run(
        merged_kv, merged_val, survivor_mask(merged_kv), cfg.capacity
    )
    del merged_kv, merged_val
    r_new = -(-min(total, cfg.capacity) // b)
    cascade.redistribute(cfg, compact_kv, compact_val, r_new, state.key_vars, state.values)
    _reset_buffer(state)
    state.lvl_debt.zero_()
    state.r = r_new
    state.overflowed = state.overflowed or total > cfg.capacity
    return state


def maintain_prefix_level(cfg: LSMConfig, budget: int) -> int:
    """Deepest level j whose prefix arena 0..j fits the budget
    (b * (2^(j+1) - 1) <= budget); -1 when even level 0 does not fit."""
    j = -1
    for i in range(cfg.num_levels):
        if cfg.batch_size * ((1 << (i + 1)) - 1) <= budget:
            j = i
    return j


def _compact_prefix(cfg: LSMConfig, state: LSMState, j: int) -> LSMState:
    b = cfg.batch_size
    prefix_n = b * ((1 << (j + 1)) - 1)
    merged_kv, merged_val = ops.merge_cascade(level_runs(cfg, state)[: j + 1])
    orig = sem.original_key(merged_kv)
    prev = torch.cat([orig.new_full((1,), -1), orig[:-1]])
    keep = (orig != prev) & (orig != sem.PLACEBO_KEY)
    # Tombstones still shadow older elements below the compaction horizon;
    # they may go only when no deeper level holds residents. The write buffer
    # is newer than the prefix, so it never constrains this.
    if (state.r >> (j + 1)) == 0:
        keep &= ~sem.is_tombstone(merged_kv)
    compact_kv, compact_val, total = cascade.compact_run(merged_kv, merged_val, keep, prefix_n)
    # total <= prefix_n: at most one survivor per key of the prefix.
    r_prefix = -(-total // b)
    cascade.redistribute(
        cfg, compact_kv, compact_val, r_prefix, state.key_vars[: j + 1], state.values[: j + 1]
    )
    state.r = (state.r & ~((1 << (j + 1)) - 1)) | r_prefix
    # Retained tombstones re-enter the estimate when a cascade merge next
    # re-materialises these levels.
    state.lvl_debt[: j + 1] = 0
    return state


def lsm_maintain(cfg: LSMConfig, state: LSMState, budget: int | None = None, *,
                 only_if_debt: bool = False) -> LSMState:
    """Budgeted incremental compaction touching at most `budget` elements.

    Queries are exact at every budget: maintenance is observationally
    invisible. `only_if_debt=True` skips the compaction when the tracked debt
    of the prefix is zero (the gate of piggybacked maintenance)."""
    if budget is None or budget >= cfg.capacity + cfg.batch_size:
        return lsm_cleanup(cfg, state)
    j = maintain_prefix_level(cfg, budget)
    if j < 0:
        return state
    if only_if_debt and int(state.lvl_debt[: j + 1].sum()) == 0:
        return state
    return _compact_prefix(cfg, state, j)


def lsm_valid_count(cfg: LSMConfig, state: LSMState):
    """Live (visible) elements, write-buffer residents included."""
    from repro_torch.core.queries import valid_count_runs

    return valid_count_runs(all_runs(cfg, state))
