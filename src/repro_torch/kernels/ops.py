"""The LSM's compute hot spots, as the core modules call them.

Each function takes tensors on one device. On a CUDA device the kernel
wrappers (`merge_path`, `bitonic_sort`, `lsm_lookup`) launch the hand-written
CUDA kernels and raise if a build or launch fails; on the CPU they run their
plain versions. Nothing else selects a path: no environment variable, and
none of the reference's shape gates (power-of-two sorts, 256-multiple
merges). The write buffer's recency sort has no kernel of its own (the JAX
package leaves it to `lax.sort`) and is a PyTorch sort here.
"""

from __future__ import annotations

import torch

from repro_torch import obs
from repro_torch.core import semantics as sem
from repro_torch.kernels import bitonic_sort, lsm_lookup, merge_path


def merge_sorted(a_kv, a_val, b_kv, b_val):
    """Stable original-key merge of two sorted runs; `a` is the newer run
    (ties: a first)."""
    return merge_path.merge_path(a_kv, a_val, b_kv, b_val)


def merge_cascade(runs, *, out=None):
    """K-way stable merge of (kv, val) runs given NEWEST FIRST, comparing
    original keys: ties go to the earlier run, then the lower index. `out`
    optionally receives the result (it must not overlap the runs)."""
    return merge_path.merge_cascade_path(
        [kv for kv, _ in runs], [v for _, v in runs], out=out
    )


def sort_pairs(key_vars, values):
    """Sort (key_var, value) pairs by the full key variable, stable: a
    tombstone comes before every insert of its key, and identical key
    variables keep input order."""
    return bitonic_sort.bitonic_sort_pairs(key_vars, values)


def sort_pairs_recency(key_vars, values):
    """Sort by original key; among equal keys the later input lane first,
    whatever its status bit (the write buffer's arrival-order rule). Placebos
    sort last. One stable sort on the int64 key (orig << 32) | (n - lane)."""
    with obs.span("ops.sort_recency"):
        n = key_vars.shape[0]
        rev = torch.arange(n, 0, -1, dtype=torch.int64, device=key_vars.device)
        key = (sem.original_key(key_vars).to(torch.int64) << 32) | rev
        perm = torch.sort(key, stable=True).indices
        return key_vars[perm], values[perm]


def lower_bound(sorted_kv, query_keys):
    """First index whose original key is >= the query, per query (int32).

    Takes the run's key variables: the kernel shifts them itself."""
    return lsm_lookup.bound(sorted_kv, query_keys, shift=1, upper=False)


def upper_bound(sorted_kv, query_keys):
    """First index whose original key is > the query, per query (int32)."""
    return lsm_lookup.bound(sorted_kv, query_keys, shift=1, upper=True)


def window_bounds(runs, k1, k2):
    """Count/range stage 1 over runs (any order): per run, the lower bound of
    k1 and the upper bound of k2 by original key -> int32 (lows, highs), each
    [len(runs), nq]; one launch of the bound kernel for all runs."""
    return lsm_lookup.bounds_runs([kv for kv, _ in runs], k1, k2, shift=1)


def lookup_runs_fused(runs, query_keys):
    """LOOKUP over runs given newest first -> (found: bool, values: int32).

    The kernel returns each query's winning element; a tombstone (or a
    placebo, for the query PLACEBO_KEY) resolves to not found."""
    best_kv, best_val = lsm_lookup.fused_lookup_runs(
        [kv for kv, _ in runs], [v for _, v in runs], query_keys
    )
    found = (sem.original_key(best_kv) == query_keys) & ~sem.is_tombstone(best_kv)
    return found, torch.where(found, best_val, sem.EMPTY_VALUE)


def lookup_level(level_kv, level_val, query_keys):
    """One run of LOOKUP on the bound kernel -> (hit, is_tomb, value)."""
    idx = lower_bound(level_kv, query_keys)
    idx_c = idx.clamp(0, level_kv.shape[0] - 1).long()
    found_kv = level_kv[idx_c]
    hit = (idx < level_kv.shape[0]) & (sem.original_key(found_kv) == query_keys)
    return hit, sem.is_tombstone(found_kv), level_val[idx_c]
