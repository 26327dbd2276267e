"""Bulk queries over the LSM: lookup, count, range (paper §3.4-3.5, §4.2-4.4).

All three are expressed over *runs*: sorted (key_var, value) tensors ordered
newest first (the write buffer, then level 0..L-1). Count and range are the
paper's five-stage pipeline at fixed shapes: stage 1, per-run lower/upper
bound searches (the bound kernel, one launch for every run and both ends of
every window); stages 2-5, each window's candidates, survivors and row
(`kernels/window_select.py`: one kernel launch on the card; on the CPU the
reference's tile, stable row sort and masks).
"""

from __future__ import annotations

import torch

from repro_torch import obs
from repro_torch.core import semantics as sem
from repro_torch.core.lsm import LSMConfig, LSMState, all_runs
from repro_torch.kernels import ops, window_select


def lookup_runs(runs, query_keys):
    """LOOKUP over newest-first runs: the first matching run wins; a tombstone
    resolves to not found. Returns (found: bool[nq], values: int32[nq])."""
    with obs.span("queries.lookup"):
        return ops.lookup_runs_fused(runs, query_keys)


def lsm_lookup(cfg: LSMConfig, state: LSMState, query_keys):
    return lookup_runs(all_runs(cfg, state), query_keys)


def _bounds(runs, k1, k2):
    """Stage 1: per run, the lower bound of k1 and the upper bound of k2 ->
    int32 [n_runs, nq] each (the bound kernel, one launch for every run)."""
    with obs.span("queries.bounds"):
        return ops.window_bounds(runs, k1, k2)


def count_runs(runs, k1, k2, max_candidates: int, flat=None):
    """COUNT(k1, k2) over runs -> (counts: int32[nq], ok: bool[nq]). `flat`,
    if given, is the newest-first concatenation of `runs` (the LSM arena),
    which spares the CPU path a copy."""
    lows, highs = _bounds(runs, k1, k2)
    return window_select.count_windows(runs, lows, highs, max_candidates, flat)


def range_runs(runs, k1, k2, max_candidates: int, max_results: int, flat=None):
    """RANGE(k1, k2) -> (keys [nq, max_results], values, counts, ok); rows are
    padded with PLACEBO_KEY / EMPTY_VALUE beyond counts."""
    lows, highs = _bounds(runs, k1, k2)
    return window_select.range_windows(runs, lows, highs, max_candidates, max_results, flat)


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
