"""Searches over sorted runs: lower/upper bounds and the multi-run LOOKUP.

`bound` (one run) and `bounds_runs` (every run of an LSM, both ends of a
count/range window, in one launch) launch `csrc/bounds.cu` (replacing the
Pallas `repro.kernels.lsm_lookup.lower_bound_streamed`), and
`fused_lookup_runs` launches `csrc/fused_lookup.cu` (replacing the Pallas
`repro.kernels.lsm_lookup.fused_lookup_runs`) on CUDA tensors. On CPU tensors
each runs its plain version below, a binary search written over all queries
at once; the bound kernels run the same binary search, one lane a query.

The TPU kernels compare every query with every key (O(q * n)), which a TPU
streams at its memory rate; on Hopper one search per query and run
does the same job in O(q log n) loads, as the paper does it (§4.2).
"""

from __future__ import annotations

import torch

from repro_torch.core import semantics as sem
from repro_torch.kernels._build import I32, I64, MAX_RUNS, P, Kernel, check_cuda_int32, run_pointers

BOUND_KERNEL = Kernel(
    "bounds.cu", "repro_bound",
    [P, I64, P, I64, I32, I32, P, P],  # keys, n, q, nq, shift, upper, out, stream
    # kv[], n[], k, k1, k2, nq, shift, lows, highs, stream
    also={"repro_bounds_runs": [P, P, I32, P, P, I64, I32, P, P, P]},
)
LOOKUP_KERNEL = Kernel(
    "fused_lookup.cu", "repro_fused_lookup",
    [P, P, P, I32, P, I64, P, P, P],  # kv[], val[], n[], k, q, nq, out_kv, out_val, stream
)


def search_plain(keys, queries, *, shift: int, upper: bool) -> torch.Tensor:
    """Binary search of every query at once (int64 indices): the first i with
    (keys[i] >> shift) >= q, or > q when `upper`."""
    n = keys.shape[0]
    lo = torch.zeros(queries.shape, dtype=torch.int64, device=queries.device)
    hi = torch.full(queries.shape, n, dtype=torch.int64, device=queries.device)
    for _ in range(n.bit_length()):
        mid = (lo + hi) // 2
        v = keys[mid.clamp(max=n - 1)] >> shift
        right = (v <= queries) if upper else (v < queries)
        active = lo < hi
        lo = torch.where(active & right, mid + 1, lo)
        hi = torch.where(active & ~right, mid, hi)
    return lo


def bound(sorted_kv, query_keys, *, shift: int = 1, upper: bool = False) -> torch.Tensor:
    """int32 lower bound (or upper bound) of each query in `sorted_kv >> shift`."""
    if sorted_kv.device.type == "cpu":
        return search_plain(sorted_kv, query_keys, shift=shift, upper=upper).to(torch.int32)
    device = check_cuda_int32("bound", sorted_kv, query_keys)
    n, nq = sorted_kv.shape[0], query_keys.shape[0]
    if n >= 1 << 31:
        raise ValueError(f"bound returns int32 indices; run of {n} elements is too long")
    out = torch.empty(nq, dtype=torch.int32, device=device)
    BOUND_KERNEL.launch(
        device, sorted_kv.data_ptr(), n, query_keys.data_ptr(), nq, shift, int(upper), out.data_ptr()
    )
    return out


def bounds_runs_plain(runs_kv, k1, k2, *, shift: int = 1):
    """Per run, the lower bound of k1 and the upper bound of k2 -> int32
    (lows, highs), each [len(runs_kv), nq]."""
    lows = [search_plain(kv, k1, shift=shift, upper=False) for kv in runs_kv]
    highs = [search_plain(kv, k2, shift=shift, upper=True) for kv in runs_kv]
    return torch.stack(lows).to(torch.int32), torch.stack(highs).to(torch.int32)


def bounds_runs(runs_kv, k1, k2, *, shift: int = 1):
    """Count/range stage 1 in one launch: for every run (in `kv >> shift`,
    any lengths, 0 included), the lower bound of each k1 and the upper bound
    of each k2 -> int32 (lows, highs), each [len(runs_kv), nq]."""
    k = len(runs_kv)
    if not 1 <= k <= MAX_RUNS or k1.shape != k2.shape:
        raise ValueError(f"bounds_runs takes 1 to {MAX_RUNS} runs and k1, k2 of one shape")
    if k1.device.type == "cpu":
        return bounds_runs_plain(runs_kv, k1, k2, shift=shift)
    device = check_cuda_int32("bounds_runs", k1, k2, *runs_kv)
    kvp, _, n = run_pointers(runs_kv)
    if max(n) >= 1 << 31:
        raise ValueError("bounds_runs returns int32 indices; a run of 2^31 elements or more is too long")
    nq = k1.shape[0]
    out = torch.empty((2, k, nq), dtype=torch.int32, device=device)
    lows = out.data_ptr()  # out[0], then out[1] = highs at 4 * k * nq bytes on
    BOUND_KERNEL.launch(device, kvp, n, k, k1.data_ptr(), k2.data_ptr(), nq, shift,
                        lows, lows + 4 * k * nq, entry="repro_bounds_runs")
    return out[0], out[1]


def fused_lookup_plain(runs_kv, runs_val, query_keys):
    """Newest-first per-run binary search; first run whose lower-bound element
    has the query's original key wins."""
    nq = query_keys.shape[0]
    device = query_keys.device
    best_kv = torch.full((nq,), sem.PLACEBO_KV, dtype=torch.int32, device=device)
    best_val = torch.full((nq,), sem.EMPTY_VALUE, dtype=torch.int32, device=device)
    resolved = torch.zeros(nq, dtype=torch.bool, device=device)
    for kv, val in zip(runs_kv, runs_val):
        n = kv.shape[0]
        if n == 0:
            continue
        idx = search_plain(kv, query_keys, shift=1, upper=False).clamp(max=n - 1)
        hit = ~resolved & ((kv[idx] >> 1) == query_keys)
        best_kv = torch.where(hit, kv[idx], best_kv)
        best_val = torch.where(hit, val[idx], best_val)
        resolved |= hit
    return best_kv, best_val


def fused_lookup_runs(runs_kv, runs_val, query_keys):
    """Multi-run LOOKUP over runs given newest first -> (best_kv, best_val).

    Per query, the element with the lowest index in the newest-first
    concatenation whose original key equals the query; (PLACEBO_KV,
    EMPTY_VALUE) when none does. Found and tombstone are decoded by the caller
    (`ops.lookup_runs_fused`).
    """
    k = len(runs_kv)
    if k < 1 or len(runs_val) != k:
        raise ValueError(f"need matching kv/val run lists, got {k} and {len(runs_val)}")
    if query_keys.device.type == "cpu":
        return fused_lookup_plain(runs_kv, runs_val, query_keys)
    device = check_cuda_int32("fused_lookup_runs", query_keys, *runs_kv, *runs_val)
    nq = query_keys.shape[0]
    out_kv = torch.empty(nq, dtype=torch.int32, device=device)
    out_val = torch.empty(nq, dtype=torch.int32, device=device)
    kvp, valp, n = run_pointers(runs_kv, runs_val)
    LOOKUP_KERNEL.launch(device, kvp, valp, n, k, query_keys.data_ptr(), nq, out_kv.data_ptr(), out_val.data_ptr())
    return out_kv, out_val
