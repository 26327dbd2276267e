"""Bulk queries over the LSM: lookup, count, range (paper §3.4-3.5, §4.2-4.4).

All three are expressed over *runs*: sorted (key_var, value) tensors ordered
newest first (the write buffer, then level 0..L-1). Count and range are the
paper's five-stage pipeline at fixed shapes:
  1. per-run lower/upper bound searches (the bound kernel, one launch for
     every run and both ends of every window);
  2. per-query candidate offsets by prefix sums;
  3. a gather into a [num_queries, max_candidates] placebo-filled tile;
  4. a row-wise stable sort by original key (stability keeps recency);
  5. mask arithmetic: count/emit the first element of each equal-key segment
     iff it is regular (docs/DESIGN.md §8).
"""

from __future__ import annotations

import torch

from repro_torch import obs
from repro_torch.core import semantics as sem
from repro_torch.core.lsm import LSMConfig, LSMState, all_runs
from repro_torch.kernels import ops


def lookup_runs(runs, query_keys):
    """LOOKUP over newest-first runs: the first matching run wins; a tombstone
    resolves to not found. Returns (found: bool[nq], values: int32[nq])."""
    with obs.span("queries.lookup"):
        return ops.lookup_runs_fused(runs, query_keys)


def lsm_lookup(cfg: LSMConfig, state: LSMState, query_keys):
    return lookup_runs(all_runs(cfg, state), query_keys)


def _gather_candidates(runs, k1, k2, max_candidates: int, flat=None):
    """Stages 1-4 for [k1, k2] queries.

    `flat`, if given, is the newest-first concatenation of `runs` (the LSM
    arena), which spares the copy. Returns (orig, kv, val, total, ok):
    orig/kv/val are [nq, max_candidates], row-sorted by original key and
    stable in recency, placebo-padded; total is each query's exact candidate
    count; ok is total <= max_candidates.
    """
    nq = k1.shape[0]
    device = k1.device
    with obs.span("queries.bounds"):
        lows, highs = ops.window_bounds(runs, k1, k2)           # [n_runs, nq] each
    with obs.span("queries.tile"):
        counts_m = (highs - lows).clamp(min=0)
        offsets = (torch.cumsum(counts_m, 0) - counts_m).to(torch.int32)
        total = counts_m.sum(0).to(torch.int32)
        ok = total <= max_candidates

        slots = torch.arange(max_candidates, dtype=torch.int64, device=device)[None, :]
        gather_idx = torch.zeros((nq, max_candidates), dtype=torch.int64, device=device)
        valid_slot = torch.zeros((nq, max_candidates), dtype=torch.bool, device=device)
        start = 0
        for r, (kv, _) in enumerate(runs):
            off = offsets[r][:, None]
            sel = (slots >= off) & (slots < off + counts_m[r][:, None])
            idx = start + lows[r][:, None] + (slots - off)
            gather_idx = torch.where(sel, idx, gather_idx)
            valid_slot |= sel
            start += kv.shape[0]

        if flat is None:
            flat = (torch.cat([kv for kv, _ in runs]), torch.cat([v for _, v in runs]))
        cand_kv = torch.where(valid_slot, flat[0][gather_idx], sem.PLACEBO_KV)
        cand_val = torch.where(valid_slot, flat[1][gather_idx], sem.EMPTY_VALUE)
    obs.count("queries.tile_slots", nq * max_candidates)
    if obs.enabled():
        obs.count_device("queries.candidates", total.clamp(max=max_candidates))

    # Stage 4: rows were filled newest run first, so a stable sort by
    # original key keeps the newest element first in each equal-key segment.
    with obs.span("queries.row_sort"):
        orig_s, perm = torch.sort(sem.original_key(cand_kv), dim=1, stable=True)
        return orig_s, cand_kv.gather(1, perm), cand_val.gather(1, perm), total, ok


def _validate(orig_s, kv_s):
    """Stage 5: the first element of each equal-key segment, iff regular."""
    prev = torch.cat([torch.full_like(orig_s[:, :1], -1), orig_s[:, :-1]], dim=1)
    return (orig_s != prev) & ~sem.is_tombstone(kv_s) & (orig_s != sem.PLACEBO_KEY)


def count_runs(runs, k1, k2, max_candidates: int, flat=None):
    """COUNT(k1, k2) over runs -> (counts: int32[nq], ok: bool[nq])."""
    orig_s, kv_s, _, _, ok = _gather_candidates(runs, k1, k2, max_candidates, flat)
    with obs.span("queries.select"):
        return _validate(orig_s, kv_s).sum(1).to(torch.int32), ok


def range_runs(runs, k1, k2, max_candidates: int, max_results: int, flat=None):
    """RANGE(k1, k2) -> (keys [nq, max_results], values, counts, ok); rows are
    padded with PLACEBO_KEY / EMPTY_VALUE beyond counts."""
    orig_s, kv_s, val_s, _, ok = _gather_candidates(runs, k1, k2, max_candidates, flat)
    with obs.span("queries.select"):
        valid = _validate(orig_s, kv_s)
        counts = valid.sum(1).to(torch.int32)
        ok = ok & (counts <= max_results)

        nq = orig_s.shape[0]
        tgt = torch.cumsum(valid, 1) - 1
        # Column max_results is a drop slot for non-survivors and overflow.
        tgt = torch.where(valid & (tgt < max_results), tgt, max_results)
        out_keys = torch.full((nq, max_results + 1), sem.PLACEBO_KEY, dtype=torch.int32, device=k1.device)
        out_vals = torch.full((nq, max_results + 1), sem.EMPTY_VALUE, dtype=torch.int32, device=k1.device)
        out_keys.scatter_(1, tgt, orig_s)
        out_vals.scatter_(1, tgt, val_s)
        return out_keys[:, :max_results], out_vals[:, :max_results], counts, ok


def survivor_mask(key_vars):
    """The CLEANUP survivor rule over one sorted run: the first (newest)
    element of its equal-key segment, regular, and not a placebo."""
    orig = sem.original_key(key_vars)
    prev = torch.cat([orig.new_full((1,), -1), orig[:-1]])
    return (orig != prev) & ~sem.is_tombstone(key_vars) & (orig != sem.PLACEBO_KEY)


def valid_count_runs(runs):
    """Live elements across newest-first runs (int32 device scalar): one K-way
    merge, then the survivor count."""
    merged_kv, _ = ops.merge_cascade(runs)
    return survivor_mask(merged_kv).sum().to(torch.int32)


def _arena(state: LSMState):
    return state.arena_kv, state.arena_val


def lsm_count(cfg: LSMConfig, state: LSMState, k1, k2, max_candidates: int):
    return count_runs(all_runs(cfg, state), k1, k2, max_candidates, _arena(state))


def lsm_range(cfg: LSMConfig, state: LSMState, k1, k2, max_candidates: int, max_results: int):
    return range_runs(all_runs(cfg, state), k1, k2, max_candidates, max_results, _arena(state))
