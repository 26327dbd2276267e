"""Binary-counter cascade engine, shared by every LSM mutation.

  * `push_batch` — one binary-counter increment: ONE K-way merge of
    [carry, level 0..j-1] into level j, where j is the lowest zero bit of r.
    The merge writes straight into level j's slice of the arena, and levels
    0..j-1 are refilled with placebos in place.
  * `compact_run` — survivors of a sorted run, in order, at the front of a
    placebo-filled buffer.
  * `redistribute` — slice a sorted, unique-key prefix into levels by the bits
    of the new resident count.
  * `run_stale_count` — the compaction debt of one run.

JAX's `lax.switch` over placement levels becomes a host branch on the host
mirror of r: no update waits on the device.
"""

from __future__ import annotations

import torch

from repro_torch import obs
from repro_torch.core import semantics as sem
from repro_torch.kernels import ops


def placement_level(r: int) -> int:
    """Index of the lowest zero bit of r: the level a carry batch lands in."""
    return ((~r) & (r + 1)).bit_length() - 1


def run_stale_count(run_kv) -> torch.Tensor:
    """Real elements of one sorted run that compacting the run alone would
    reclaim (shadowed duplicates plus tombstones), as an int32 device scalar."""
    from repro_torch.core.queries import survivor_mask

    real = (sem.original_key(run_kv) != sem.PLACEBO_KEY).sum()
    return (real - survivor_mask(run_kv).sum()).to(torch.int32)


def push_batch(cfg, state, carry_kv, carry_val):
    """Push one sorted b-wide batch through the binary-counter cascade.

    The carry must be ascending in original key with the newest element first
    among equal keys. Mutates `state` in place and returns it. On overflow
    (r == max_batches) the levels are kept and the latch is set.
    """
    if state.r >= cfg.max_batches:
        state.overflowed = True
        return state
    with obs.span("cascade.push"):
        j = placement_level(state.r)
        obs.count(f"cascade.carries.L{j}")
        obs.count("cascade.merged_elements", cfg.batch_size << j)
        levels = [(state.key_vars[i], state.values[i]) for i in range(j)]
        with obs.span("cascade.merge"):
            ops.merge_cascade(
                [(carry_kv, carry_val)] + levels, out=(state.key_vars[j], state.values[j])
            )
        with obs.span("cascade.debt"):
            for kv, val in levels:
                kv.fill_(sem.PLACEBO_KV)
                val.fill_(sem.EMPTY_VALUE)
            state.lvl_debt[:j] = 0
            state.lvl_debt[j] = run_stale_count(state.key_vars[j])
        state.r += 1
    return state


def compact_run(merged_kv, merged_val, keep, out_size: int):
    """The `keep` elements of a sorted run, in order, at the front of a
    placebo-filled buffer of `out_size` slots -> (kv, val, total), where
    total is the UNCLAMPED survivor count (a host int: the callers size the
    levels by it). Survivors beyond out_size are dropped."""
    total = int(keep.sum())
    kv, val = sem.placebo(out_size, merged_kv.device)
    n = min(total, out_size)
    # The read of the count, and each boolean-mask gather (which sizes its
    # output on the host), wait for the device.
    kv[:n] = merged_kv[keep][:n]
    val[:n] = merged_val[keep][:n]
    obs.count("host_syncs", 3)
    return kv, val, total


def redistribute(cfg, compact_kv, compact_val, r_new: int, levels_kv, levels_val):
    """Slice a sorted, unique-key array into the given levels 0..len-1.

    Level i receives, if bit i of r_new is set, the slice starting at
    b * (r_new & (2^i - 1)) (smallest keys in the smallest levels, paper
    §4.5), and placebos otherwise. Writes the level tensors in place.
    """
    b = cfg.batch_size
    for i, (kv, val) in enumerate(zip(levels_kv, levels_val)):
        if (r_new >> i) & 1:
            start = b * (r_new & ((1 << i) - 1))
            kv.copy_(compact_kv[start:start + kv.shape[0]])
            val.copy_(compact_val[start:start + kv.shape[0]])
        else:
            kv.fill_(sem.PLACEBO_KV)
            val.fill_(sem.EMPTY_VALUE)
