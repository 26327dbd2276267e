"""Semantic oracles for the LSM kernels, written with `torch.searchsorted`.

They state what each kernel computes in the plainest form; the tests hold the
kernels' plain versions (`merge_path`, `lsm_lookup`) and the JAX reference
against them. Nothing on the main path calls this module.
"""

from __future__ import annotations

import torch

from repro_torch.core import semantics as sem


def merge_ref(a_kv, a_val, b_kv, b_val):
    """Stable merge of two sorted runs by original key; `a` is the newer run
    and takes ties. a[i] lands at i + |{j : b[j] < a[i]}|, b[j] at
    j + |{i : a[i] <= b[j]}|."""
    a_keys, b_keys = sem.original_key(a_kv), sem.original_key(b_kv)
    na, nb = a_kv.shape[0], b_kv.shape[0]
    idx_a = torch.arange(na, device=a_kv.device) + torch.searchsorted(b_keys, a_keys, right=False)
    idx_b = torch.arange(nb, device=b_kv.device) + torch.searchsorted(a_keys, b_keys, right=True)
    out_kv = torch.zeros(na + nb, dtype=torch.int32, device=a_kv.device)
    out_val = torch.zeros(na + nb, dtype=torch.int32, device=a_kv.device)
    out_kv[idx_a], out_kv[idx_b] = a_kv, b_kv
    out_val[idx_a], out_val[idx_b] = a_val, b_val
    return out_kv, out_val


def merge_cascade_ref(runs_kv, runs_val):
    """K-way newest-first merge as a left fold of `merge_ref` (the accumulated
    side is always the newer one)."""
    out_kv, out_val = runs_kv[0], runs_val[0]
    for kv, val in zip(runs_kv[1:], runs_val[1:]):
        out_kv, out_val = merge_ref(out_kv, out_val, kv, val)
    return out_kv, out_val


def sort_ref(key_vars, values):
    """Sort a batch by the FULL key variable (status bit included), stable:
    a tombstone for key k comes before any same-batch insert of k (paper
    §4.1), and identical key variables keep input order."""
    order = torch.sort(key_vars, stable=True).indices
    return key_vars[order], values[order]


def fused_lookup_ref(flat_kv, flat_val, query_keys):
    """First flat match per query, by a dense [q, n] match matrix (test
    oracle only: O(q * n))."""
    match = sem.original_key(flat_kv)[None, :] == query_keys[:, None]
    any_match = match.any(dim=1)
    first = match.to(torch.int8).argmax(dim=1)
    best_kv = torch.where(any_match, flat_kv[first], sem.PLACEBO_KV)
    best_val = torch.where(any_match, flat_val[first], sem.EMPTY_VALUE)
    return best_kv, best_val


def lower_bound_ref(sorted_orig_keys, query_keys):
    """Index of the first element >= query (std::lower_bound)."""
    return torch.searchsorted(sorted_orig_keys, query_keys, right=False).to(torch.int32)


def upper_bound_ref(sorted_orig_keys, query_keys):
    """Index of the first element > query (std::upper_bound)."""
    return torch.searchsorted(sorted_orig_keys, query_keys, right=True).to(torch.int32)


def lookup_level_ref(level_kv, level_val, query_keys):
    """One run of LOOKUP: (hit, is_tomb, value) of each query's lower-bound element."""
    orig = sem.original_key(level_kv)
    idx = torch.searchsorted(orig, query_keys, right=False)
    idx_c = idx.clamp(0, level_kv.shape[0] - 1)
    found_kv = level_kv[idx_c]
    hit = (idx < level_kv.shape[0]) & (sem.original_key(found_kv) == query_keys)
    return hit, sem.is_tombstone(found_kv), level_val[idx_c]
