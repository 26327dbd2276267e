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

The lookup kernel starts every run's search in a sample of the run held in
shared memory (`sample_layout` places the samples of all runs in one budget),
advances the searches of two runs of a query at once and, for many queries,
takes the queries in order of their keys' top bits; `lookup_grid` sizes its
persistent grid.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from repro_torch.core import semantics as sem
from repro_torch.kernels._build import I32, I64, MAX_RUNS, P, Kernel, check_cuda_int32, run_pointers, sm_count

BOUND_KERNEL = Kernel(
    "bounds.cu", "repro_bound",
    [P, I64, P, I64, I32, I32, P, P],  # keys, n, q, nq, shift, upper, out, stream
    # kv[], n[], k, k1, k2, nq, shift, lows, highs, stream
    also={"repro_bounds_runs": [P, P, I32, P, P, I64, I32, P, P, P]},
)
LOOKUP_KERNEL = Kernel(
    "fused_lookup.cu", "repro_fused_lookup",
    # kv[], val[], n[], k, layout, total, q, nq, blocks, scratch, out_kv, out_val, stream
    [P, P, P, I32, P, I32, P, I64, I32, P, P, P, P],
)

# Shared memory for the samples of every run in one lookup block, in int32
# slots: 32 KB (budgets of 2^12 to 3 * 2^14 slots swept on the H100: no
# larger one was faster). The kernel takes at most 48 KB.
SAMPLE_INTS = 1 << 13
# Resident lookup blocks an SM: two of 512 threads (a sweep of 1024 to 2048
# threads an SM on the H100 set it: PERF.md).
LOOKUP_BLOCKS_PER_SM = 2


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


def sample_layout(lengths, budget: int = SAMPLE_INTS):
    """Where the lookup kernel keeps the samples of each run in shared memory
    -> (lg, count, off, total), one entry per run.

    Every run gets at most `per_run` slots, the largest power of two <=
    budget / len(lengths): its keys at positions j << lg (lg the least that
    fits, 0 for a run that fits whole), then its last key. An empty run gets
    none. The runs' slots follow each other from slot 0; `total` is their sum.
    """
    per_run = 1 << ((budget // len(lengths)).bit_length() - 1)
    if per_run < 2:
        raise ValueError(f"a sample budget of {budget} slots is too small for {len(lengths)} runs")
    lg, count, off, total = [], [], [], 0
    for n in lengths:
        shift = 0
        while n and ((n - 1) >> shift) + 2 > per_run:
            shift += 1
        lg.append(shift)
        count.append(((n - 1) >> shift) + 2 if n else 0)
        off.append(total)
        total += count[-1]
    return lg, count, off, total


@functools.lru_cache(maxsize=64)
def _layout_arg(lengths: tuple, budget: int):
    """`sample_layout` as the kernel takes it: int32 [lg..., count..., off...], and total."""
    lg, count, off, total = sample_layout(lengths, budget)
    return (ctypes.c_int * (3 * len(lengths)))(*lg, *count, *off), total


def lookup_grid(nq: int, threads: int, sms: int) -> int:
    """Persistent blocks of the lookup kernel: LOOKUP_BLOCKS_PER_SM on each
    of `sms` SMs, fewer when the queries fill fewer."""
    return max(1, min(-(-nq // threads), LOOKUP_BLOCKS_PER_SM * sms))


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
    kvp, valp, n = run_pointers(runs_kv, runs_val)
    if max(n) >= 1 << 31:
        raise ValueError("fused_lookup_runs takes int32 positions; a run of 2^31 elements or more is too long")
    layout, total = _layout_arg(tuple(n), SAMPLE_INTS)
    nq = query_keys.shape[0]
    blocks = lookup_grid(nq, LOOKUP_KERNEL.constant("repro_lookup_threads"), sm_count(device.index))
    out = torch.empty((2, nq), dtype=torch.int32, device=device)
    # The kernel's scratch: the queries in bucket order (2 * nq, from
    # repro_lookup_bucket_min queries on), the samples (total), the bucket
    # counts and cursors (2 * buckets).
    order = 2 * nq if nq >= LOOKUP_KERNEL.constant("repro_lookup_bucket_min") else 0
    scratch = torch.empty(order + total + 2 * LOOKUP_KERNEL.constant("repro_lookup_buckets"), dtype=torch.int32,
                          device=device)
    LOOKUP_KERNEL.launch(device, kvp, valp, n, k, layout, total, query_keys.data_ptr(), nq, blocks,
                         scratch.data_ptr(), out[0].data_ptr(), out[1].data_ptr())
    return out[0], out[1]
