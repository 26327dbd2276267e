#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port of the GPU LSM (src/repro_torch) on one NVIDIA card.

    python3 chip_smoke.py [--seed 0]

Phases, one line each with its seconds:
  1. the card: `nvidia-smi` name and power limit, and torch's device name;
  2. build: every CUDA kernel from src/repro_torch/csrc, one nvcc per source,
     all started together;
  3. each kernel against its plain PyTorch version on the card, by exact
     equality, at the main path's sizes and at edge cases (for the K-way
     merge: tie-heavy runs across many tiles, LSM placebo tails, K = 1,
     grouped rounds with a ragged last group, and its split launcher at
     every tile boundary of an LSM-shaped case; for the bound kernel: runs
     of 0, 1, 3 and 2^k +- 1 keys with long placebo segments, and count/range
     stage 1 over 13 runs with an empty buffer run and windows with k1 > k2;
     for Merge Path: edge lengths, windows, inputs and outputs off a 16-byte
     boundary, and its split launcher at every tile boundary; for the lookup:
     13 LSM-shaped runs, the same runs over 64 keys so equal-key segments
     cross many sample strides, one run of 2^27 slots, empty runs and 32
     runs, each at query counts on both sides of the kernel's bucket
     threshold and with tombstone hits);
  4. the main path through the `Dictionary` facade at the paper's Table 2
     scale (n = 2^27 resident elements, b = 2^16, L = 12): fill by inserts,
     delete, re-insert, flush, lookup, count, range, maintain, cleanup, size,
     every result held exactly against a numpy oracle of last-write-wins,
     and every kernel's launch count moved;
  5. each kernel's time at the main path's shapes beside its bound, its plain
     version's time and a PyTorch library call's, as one `kernels` JSON line
     (the cascade merge also at one push_batch shape; the bound kernel also
     device only, from a replayed CUDA graph, and as count/range stage 1 in
     one launch beside 26 library searches and 26 single-run launches; the
     lookup also device only, with its footprint in 32-byte sectors beside
     its element bound, and at the sorted array's shape, one run of 2^27
     slots, on phase 6's data; the
     rows of the batch sort, timed as the whole function with its block sort
     and first K-way round beside it, and of the pairwise merge, with its
     split and merge passes apart, are timed after phase 6, on its data);
     the host microseconds of one kernel launch, and profiles of one count
     call, one lookup call, one insert call and direct update batches;
  6. the paper-exact update path, bulk build and the sorted-array baseline
     at full width (phase 4's dictionary freed first): an LSM of capacity
     2^27 (b = 2^16, L = 12) bulk-built from 2^26 unique keys, then 1024
     direct `lsm_update_mixed` batches of 2^16 lanes, lookup, count, range,
     cleanup and size; a sorted array of capacity 2^27 bulk-built from the
     same keys, then 64 facade update calls (recency rule) and 64 direct
     batches (paper rule), and the same queries. Every result is held exactly
     against an oracle built on the card; the update rates are printed;
  7. the `DictionaryServer` at full width (b = 2^16, capacity 2^27, L = 12):
     a `resident` tenant filled with 2^26 unique keys in 64 updates of 2^20
     lanes, then 4096 tenants replaying a `mixed` trace of 2^16 events (decode
     trickles, prefill bursts, eviction storms: all four op kinds) through
     `replay_server` with a step every 4096 ops, one more step under the
     profiler, and a cleanup; every ticket held against per-tenant dict
     oracles in trace order, and the end state (every key the traffic
     touched, 2^20 resident keys) before and after the cleanup;
  8. the cuckoo baseline at Table 3's protocol: phase 6's 2^26 unique keys
     bulk-built at load 0.8 in at most 100 rounds, then 2^20 lookups of
     keys all present and 2^20 of keys all absent, exact;
  9. the dedup pipeline: 16 steps of 4096 documents of 2048 tokens into an
     LSM of b = 4096 and 2^28 slots, then step 0's batch replayed (every
     document a duplicate), duplicates, tokens and the index held against a
     host set of the hashes seen.
The last line is {"ok": true, "device": {...}}. Any failure exits non-zero
before it. Without a CUDA device, or without the repository's src/ beside
it, the script exits non-zero and prints no result.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import math
import subprocess
import sys
import time
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parent

MAX_USER_KEY = (1 << 30) - 2
PLACEBO_KEY = (1 << 30) - 1
PLACEBO_KV = PLACEBO_KEY << 1
INT32_MAX = (1 << 31) - 1
EDGE_KEYS = [0, 1, MAX_USER_KEY, PLACEBO_KEY, INT32_MAX, -1]

# Published H100 SXM peaks: HBM bytes/s, and the non-tensor fp32 rate standing
# in for int32 compares (NVIDIA's datasheet lists no int32 rate; fp32's is the
# larger, so the bound stays a lower bound).
HBM_BYTES_PER_S = 3.35e12
OPS_PER_S = 67e12


class SmokeError(RuntimeError):
    pass


def log(msg: str) -> None:
    print(msg, flush=True)


def require(cond: bool, msg: str) -> None:
    if not cond:
        raise SmokeError(msg)


# ---------------------------------------------------------------------------
# inputs
# ---------------------------------------------------------------------------


def sorted_run(rng, n, key_hi, tomb_frac=0.3, placebo_frac=0.25):
    """A run as the LSM keeps it: ascending original key, mixed status bits,
    a placebo tail with EMPTY_VALUE values."""
    tail = int(n * placebo_frac)
    keys = np.sort(rng.integers(0, key_hi, n - tail))
    kv = np.concatenate([(keys << 1) | (rng.random(keys.size) >= tomb_frac),
                         np.full(tail, PLACEBO_KV)]).astype(np.int32)
    val = rng.integers(-(1 << 20), 1 << 20, n).astype(np.int32)
    val[n - tail:] = 0
    return kv, val


def dev_tensor(torch, a, device):
    return torch.from_numpy(np.ascontiguousarray(a)).to(device)


def device_run(torch, gen, n, key_hi, device, tomb_frac=0.3, placebo_frac=0.25):
    """sorted_run made on the card (a run of 2^27 slots takes seconds on the host)."""
    tail = int(n * placebo_frac)
    keys = torch.sort(torch.randint(0, key_hi, (n - tail,), generator=gen, device=device, dtype=torch.int32)).values
    live = (torch.rand(n - tail, generator=gen, device=device) >= tomb_frac).to(torch.int32)
    kv = torch.cat([(keys << 1) | live, torch.full((tail,), PLACEBO_KV, dtype=torch.int32, device=device)])
    val = torch.randint(-(1 << 20), 1 << 20, (n,), generator=gen, device=device, dtype=torch.int32)
    val[n - tail:] = 0
    return kv, val


def lookup_queries(torch, gen, kvs, key_hi, nq, device):
    """Half the queries keys of the runs, half uniform below key_hi + 3, and the edge keys."""
    keys = torch.cat([kv >> 1 for kv in kvs])
    n_hit = nq // 2 if keys.numel() else 0
    return torch.cat([keys[torch.randint(0, max(keys.numel(), 1), (n_hit,), generator=gen, device=device)],
                      torch.randint(0, key_hi + 3, (nq - n_hit - len(EDGE_KEYS),), generator=gen, device=device,
                                    dtype=torch.int32),
                      torch.tensor(EDGE_KEYS, dtype=torch.int32, device=device)])


# ---------------------------------------------------------------------------
# phase 3: kernels against their plain versions
# ---------------------------------------------------------------------------


def max_err(torch, got, exp) -> int:
    err = 0
    for g, e in zip(got, exp):
        require(g.shape == e.shape, f"shape {tuple(g.shape)} != {tuple(e.shape)}")
        if g.numel():
            err = max(err, int((g.long() - e.long()).abs().max()))
    return err


def check_kernels(torch, device, rng):
    from repro_torch.kernels import bitonic_sort, lsm_lookup, merge_path

    errs = {"merge_cascade": 0, "bound": 0, "fused_lookup": 0, "bitonic_sort": 0, "merge_path": 0}
    cases = 0
    merge_cases = [
        ([1 << 20], 1000, False),
        ([255, 257], 40, False),
        ([0, 1, 1 << 20], 5000, False),
        ([0, 1, 255, 257, 1 << 20, 1, 0, 255, 257, 1 << 16, 3, 1 << 18, 7], 3000, False),
        ([1 << 16] * 13, 1 << 30, False),
        ([1 << 20, 255], 1 << 12, True),
    ]
    for lengths, key_hi, full in merge_cases:
        runs = [sorted_run(rng, n, key_hi) for n in lengths]
        if full:  # compare_full merges runs sorted by the full key variable
            runs = [(np.sort(kv), v) for kv, v in runs]
        kvs = [dev_tensor(torch, kv, device) for kv, _ in runs]
        vals = [dev_tensor(torch, v, device) for _, v in runs]
        got = merge_path.merge_cascade_path(kvs, vals, compare_full=full)
        exp = merge_path.merge_cascade_plain(kvs, vals, shift=0 if full else 1)
        torch.cuda.synchronize()
        errs["merge_cascade"] = max(errs["merge_cascade"], max_err(torch, got, exp))
        cases += 1

    # Tie-heavy K-way cases: 32 runs of one key spanning many 4096-element
    # tiles (both compare modes); LSM levels with placebo tails, every third
    # level all placebos, so many tile boundaries fall inside one equal-key
    # segment across runs; K = 1. Then the split launcher at every tile
    # boundary of the LSM case.
    lsm_lengths = [1 << 12] + [1 << (12 + i) for i in range(12)]
    tie_cases = [
        ([sorted_run(rng, (1 << 15) + s, 1, placebo_frac=0) for s in range(32)], (False, True)),
        ([sorted_run(rng, n, 1 << 22, placebo_frac=1.0 if s % 3 == 2 else 0.25)
          for s, n in enumerate(lsm_lengths)], (False,)),
        ([sorted_run(rng, 0, 10)], (False,)), ([sorted_run(rng, 1, 10)], (False,)),
        ([sorted_run(rng, (1 << 20) + 3, 1 << 20)], (False, True)),
    ]
    for runs, modes in tie_cases:
        for full in modes:
            if full:
                runs = [(np.sort(kv), v) for kv, v in runs]
            kvs = [dev_tensor(torch, kv, device) for kv, _ in runs]
            vals = [dev_tensor(torch, v, device) for _, v in runs]
            got = merge_path.merge_cascade_path(kvs, vals, compare_full=full)
            exp = merge_path.merge_cascade_plain(kvs, vals, shift=0 if full else 1)
            torch.cuda.synchronize()
            errs["merge_cascade"] = max(errs["merge_cascade"], max_err(torch, got, exp))
            cases += 1
    kvs = [dev_tensor(torch, kv, device) for kv, _ in tie_cases[1][0]]
    total = sum(lsm_lengths)
    diags = torch.cat([torch.arange(0, total, 4096, device=device), torch.tensor([total], device=device)])
    got = merge_path.cascade_split(kvs, diags)
    exp = merge_path.cascade_split_plain(kvs, diags, shift=1)
    torch.cuda.synchronize()
    errs["merge_cascade"] = max(errs["merge_cascade"], max_err(torch, [got], [exp]))
    cases += 1
    del kvs, vals, tie_cases

    # Bound: one 2^26 run at full width; edge lengths (0, 1, 3, 2^k +- 1)
    # with few keys and a long placebo tail; then count/range stage 1 in one
    # launch over 13 runs (an empty buffer run, every fourth level all
    # placebos), windows with k1 > k2 and the edge keys.
    kv, _ = sorted_run(rng, 1 << 26, MAX_USER_KEY + 1)
    q = np.concatenate([rng.integers(0, MAX_USER_KEY + 1, (1 << 20) - 4),
                        [0, MAX_USER_KEY, PLACEBO_KEY, INT32_MAX]]).astype(np.int32)
    cases_b = [(kv, q)]
    for n in (0, 1, 3, 31, 33, 4095, 4097, (1 << 16) + 1):
        cases_b.append((sorted_run(rng, n, 5, placebo_frac=0.4)[0],
                        np.concatenate([rng.integers(-1, 7, 999), EDGE_KEYS]).astype(np.int32)))
    for kv, q in cases_b:
        kv_d, q_d = dev_tensor(torch, kv, device), dev_tensor(torch, q, device)
        for upper in (False, True):
            got = lsm_lookup.bound(kv_d, q_d, shift=1, upper=upper)
            exp = lsm_lookup.search_plain(kv_d, q_d, shift=1, upper=upper).to(torch.int32)
            torch.cuda.synchronize()
            errs["bound"] = max(errs["bound"], max_err(torch, [got], [exp]))
            cases += 1
    del kv_d, cases_b
    for key_hi in (4, 1 << 22):
        runs = [sorted_run(rng, n, key_hi, placebo_frac=1.0 if s % 4 == 3 else 0.25)[0]
                for s, n in enumerate([0] + [(1 << 10) << i for i in range(12)])]
        k1 = np.concatenate([rng.integers(-1, key_hi + 2, (1 << 16) - 6), EDGE_KEYS]).astype(np.int64)
        k2 = np.clip(k1 + rng.integers(-8, 1 << 10, k1.size), -INT32_MAX - 1, INT32_MAX).astype(np.int32)
        kvs = [dev_tensor(torch, kv, device) for kv in runs]
        k1_d, k2_d = dev_tensor(torch, k1.astype(np.int32), device), dev_tensor(torch, k2, device)
        got = lsm_lookup.bounds_runs(kvs, k1_d, k2_d)
        exp = lsm_lookup.bounds_runs_plain(kvs, k1_d, k2_d)
        torch.cuda.synchronize()
        errs["bound"] = max(errs["bound"], max_err(torch, got, exp))
        cases += 1

    # Lookup, each case exact and with tombstone hits, each shape on both
    # sides of the kernel's bucket threshold (from it on the queries are
    # searched in bucket order, below it in their own order): the main path's
    # shape (13 runs, buffer + 12 levels, 2^24 slots); the same runs with 64
    # keys, so every equal-key segment crosses many sample strides; one run
    # of 2^27 slots (the sorted array's shape); empty runs; 32 runs.
    bucket_min = lsm_lookup.LOOKUP_KERNEL.constant("repro_lookup_bucket_min")
    gen = torch.Generator(device=device)
    gen.manual_seed(int(rng.integers(1 << 31)))
    lookup_cases = [(lsm_lengths, 1 << 22, 1 << 20), (lsm_lengths, 1 << 22, 1 << 12), (lsm_lengths, 64, 1 << 20),
                    (lsm_lengths, 64, bucket_min - 1), ([1 << 27], MAX_USER_KEY + 1, 1 << 20),
                    ([1 << 27], MAX_USER_KEY + 1, bucket_min - 1), ([0, 5000, 0, 1 << 16, 0], 1000, (1 << 16) + 3),
                    ([0, 5000, 0, 1 << 16, 0], 1000, bucket_min + 3), ([3000 + 7 * s for s in range(32)], 500, 1000),
                    ([3000 + 7 * s for s in range(32)], 500, bucket_min)]
    for lengths, key_hi, nq in lookup_cases:
        runs = [device_run(torch, gen, n, key_hi, device) for n in lengths]
        kvs, vals = [kv for kv, _ in runs], [v for _, v in runs]
        q_d = lookup_queries(torch, gen, kvs, key_hi, nq, device)
        exp = lsm_lookup.fused_lookup_plain(kvs, vals, q_d)
        got = lsm_lookup.fused_lookup_runs(kvs, vals, q_d)
        torch.cuda.synchronize()
        errs["fused_lookup"] = max(errs["fused_lookup"], max_err(torch, got, exp))
        tomb_hits = int(((got[0] >> 1 == q_d) & (got[0] & 1 == 0)).sum())
        require(tomb_hits > 0, f"lookup check over runs {lengths[:3]}..., {nq} queries, has no tombstone hits")
        cases += 1
    del runs, kvs, vals, q_d, got, exp

    # Batch sort: few distinct keys, so identical key variables repeat and
    # the values (the lanes) show that the order is stable.
    for n in (1, 7, 8, 1000, 4096, 4097, 1 << 16, (1 << 22) + 5):
        kv = dev_tensor(torch, (rng.integers(0, 50, n) << 1 | (rng.random(n) < 0.6)).astype(np.int32), device)
        val = torch.arange(n, dtype=torch.int32, device=device)
        for fn, plain in ((bitonic_sort.bitonic_sort_pairs, bitonic_sort.sort_pairs_plain),
                          (bitonic_sort.block_sort, bitonic_sort.block_sort_plain)):
            got, exp = fn(kv, val), plain(kv, val)
            torch.cuda.synchronize()
            errs["bitonic_sort"] = max(errs["bitonic_sort"], max_err(torch, got, exp))
            cases += 1

    # Pairwise merge: every pair of edge lengths (0, 1, 3, 2^k +- 1 and one
    # merge tile +- 1), one large pair and the sorted array's shape (a tiny
    # `a`, a long `b` with a placebo tail), both compare modes; inputs at
    # the start of their storage and 1-3 elements into it (windows and bases
    # off a 16-byte boundary), a fresh output and a caller's output 1
    # element into its storage. Then the split kernel alone at every tile
    # boundary and every 7th diagonal.
    tile = merge_path.path_tile()
    edges = (0, 1, 3, 255, 257, tile - 1, tile + 1)
    pairs = [(na, nb) for na in edges for nb in edges] + [(1 << 16, 1 << 20), (1 << 20, 1 << 16), (64, 1 << 22)]

    def at_offset(a, k):
        return torch.cat([torch.zeros(k, dtype=torch.int32, device=device), dev_tensor(torch, a, device)])[k:]

    for c, (na, nb) in enumerate(pairs):
        for full in (False, True):
            key_hi = 1 if c % 3 == 0 else 300  # one key everywhere: ties across whole tiles
            runs = [sorted_run(rng, m, key_hi, placebo_frac=0.5 if m == nb else 0.25) for m in (na, nb)]
            if full:
                runs = [(np.sort(kv), v) for kv, v in runs]
            args = [at_offset(a, c % 4) for run in runs for a in run]
            exp = merge_path.merge_path_plain(*args, shift=0 if full else 1)
            out = [torch.empty(na + nb + 1, dtype=torch.int32, device=device)[1:] for _ in range(2)]
            for o in (None, out):
                got = merge_path.merge_path(*args, compare_full=full, out=o)
                torch.cuda.synchronize()
                errs["merge_path"] = max(errs["merge_path"], max_err(torch, got, exp))
                cases += 1
            a_kv, b_kv = args[0], args[2]
            n = na + nb
            diags = torch.cat([torch.arange(0, n + 1, tile, device=device), torch.arange(0, n + 1, 7, device=device),
                               torch.tensor([n], device=device)])
            shift = 0 if full else 1
            got = merge_path.merge_split(a_kv, b_kv, diags, compare_full=full)
            exp = merge_path.merge_split_plain(a_kv >> shift, b_kv >> shift, diags)
            torch.cuda.synchronize()
            errs["merge_path"] = max(errs["merge_path"], max_err(torch, [got], [exp]))
            cases += 1
    # Grouped K-way merges on the full key variable (the sort's rounds), the
    # last group short and with fewer runs.
    for n, width, k in ((32 * 4096 * 3 + 12345, 4096, 32), ((1 << 20) + 3000, 1000, 5)):
        kv = dev_tensor(torch, rng.permutation(sorted_run(rng, n, 1 << 12)[0]), device)
        kv = torch.cat([torch.sort(kv[s:s + width]).values for s in range(0, n, width)])  # sorted runs
        val = torch.arange(n, dtype=torch.int32, device=device)
        got = merge_path.merge_groups(kv, val, width, k, compare_full=True)
        exp = merge_path.merge_groups_plain(kv, val, width, k, shift=0)
        torch.cuda.synchronize()
        errs["merge_cascade"] = max(errs["merge_cascade"], max_err(torch, got, exp))
        cases += 1
    return errs, cases


# ---------------------------------------------------------------------------
# phase 4: the main path against a numpy oracle
# ---------------------------------------------------------------------------


def drive_main_path(torch, device, seed, *, log2_n, b, lanes, n_lookups, n_windows, reps):
    """Fill, churn, query and compact through the facade; hold every answer
    against an oracle of last-write-wins. Data and oracle are made on the
    device from `seed` (torch.Generator, torch.unique, torch.searchsorted:
    library calls, none of them the port's code). Returns (final handle,
    rates dict, lookup queries)."""
    from repro_torch.api import Dictionary, QueryPlan

    def sync():
        if device.type == "cuda":
            torch.cuda.synchronize()

    gen = torch.Generator(device=device)
    gen.manual_seed(seed)

    def randint(hi, size):
        return torch.randint(0, hi, (size,), generator=gen, device=device, dtype=torch.int32)

    n = 1 << log2_n
    t0 = time.perf_counter()
    keys = randint(MAX_USER_KEY + 1, n)
    # The first write of a key carries key % 1009; a later write of the same
    # key in the fill adds its position in the stream, so the oracle (the last
    # write per key, from a stable sort) holds recency among duplicates too.
    sorted_keys, order = torch.sort(keys, stable=True)
    new_key = sorted_keys[1:] != sorted_keys[:-1]
    first, last = torch.ones(n, dtype=torch.bool, device=device), torch.ones(n, dtype=torch.bool, device=device)
    first[1:], last[:-1] = new_key, new_key
    later = torch.empty_like(first)
    later[order] = ~first
    stream_pos = torch.arange(n, dtype=torch.int32, device=device)
    vals = keys % 1009 + torch.where(later, stream_pos, 0)
    uniq, uniq_vals = sorted_keys[last], vals[order[last]]
    del sorted_keys, order, new_key, first, last, later, stream_pos
    m = min(1 << 20, uniq.numel() // 8)
    pos = torch.randperm(uniq.numel(), generator=gen, device=device)[:m]
    deleted = uniq[pos]
    reinserted = deleted[: m // 2]
    keep = torch.ones_like(uniq, dtype=torch.bool)
    keep[pos[m // 2:]] = False
    live = uniq[keep]
    live_vals = uniq_vals[keep].long()
    live_vals[torch.searchsorted(live, reinserted)] = reinserted.long() % 1009 + 1009
    dup_writes = n - uniq.numel()
    d = Dictionary.create("lsm", batch_size=b, capacity=n, device=device, validate=False)
    require(d.capacity == b * ((1 << math.ceil(math.log2(n // b + 1))) - 1), "unexpected capacity")
    sync()
    log(f"phase 4 set-up: data, oracle and create on the device ({dup_writes} of {n} writes repeat a key), "
        f"{time.perf_counter() - t0:.2f} s")
    rates = {}

    t0 = time.perf_counter()
    for s in range(0, n, lanes):
        d = d.insert(keys[s:s + lanes], vals[s:s + lanes])
    sync()
    rates["fill_s"] = time.perf_counter() - t0
    rates["insert_M_elem_per_s"] = n / rates["fill_s"] / 1e6
    log(f"phase 4 fill: {n} inserts in calls of {lanes}, {rates['fill_s']:.3f} s, "
        f"{rates['insert_M_elem_per_s']:.2f} M elem/s")

    t0 = time.perf_counter()
    d = d.delete(deleted)
    d = d.insert(reinserted, reinserted % 1009 + 1009)
    d = d.flush()
    sync()
    rates["churn_s"] = time.perf_counter() - t0
    require(not d.overflowed() and d.pending() == 0, "overflow or pending after flush")
    log(f"phase 4 churn: delete {m}, re-insert {m // 2}, flush, {rates['churn_s']:.3f} s")

    def timed(call, check, reps):
        """One warm-up call, then `reps` timed calls; every result checked.
        Returns the seconds of the timed calls together."""
        check(call())
        sync()
        t0 = time.perf_counter()
        results = [call() for _ in range(reps)]
        sync()
        dt = time.perf_counter() - t0
        for r in results:
            check(r)
        return dt

    def lookup_checker(q, what):
        idx = torch.searchsorted(live, q).clamp(max=live.numel() - 1)
        exp_found = live[idx] == q
        exp_vals = torch.where(exp_found, live_vals[idx], 0)

        def check(res):
            found, got = res
            require(torch.equal(found, exp_found), f"{what}: lookup found differs")
            require(torch.equal(got.long(), exp_vals), f"{what}: lookup values differ")
        return check

    q = torch.cat([keys[randint(n, n_lookups // 2).long()], randint(MAX_USER_KEY + 1, n_lookups - n_lookups // 2)])
    dt = timed(lambda: d.lookup(q), lookup_checker(q, "lookup"), reps)
    rates["lookup_M_q_per_s"] = reps * n_lookups / dt / 1e6
    log(f"phase 4 lookup: {reps} calls of {n_lookups} queries after a warm-up, {dt:.4f} s, "
        f"{rates['lookup_M_q_per_s']:.2f} M q/s")

    k1 = randint(MAX_USER_KEY - 1022, n_windows)
    k2 = k1 + 1023
    lo = torch.searchsorted(live, k1)
    exp_counts = torch.searchsorted(live, k2, right=True) - lo
    plan = QueryPlan(max_candidates=1024, max_results=512)
    require(int(exp_counts.max()) <= 512, "a window holds more than max_results live keys")
    col = torch.arange(512, device=device)
    inside = col[None, :] < exp_counts[:, None]
    src = (lo[:, None] + col[None, :]).clamp(max=live.numel() - 1)
    exp_keys = torch.where(inside, live[src], PLACEBO_KEY)
    exp_vals = torch.where(inside, live_vals[src], 0)

    def check_count(res):
        counts, ok = res
        require(bool(ok.all()), "count plan truncated")
        require(torch.equal(counts.long(), exp_counts), "count differs")

    def check_range(res):
        rkeys, rvals, rcounts, rok = res
        require(bool(rok.all()), "range plan truncated")
        require(torch.equal(rcounts.long(), exp_counts), "range counts differ")
        require(torch.equal(rkeys, exp_keys), "range keys differ")
        require(torch.equal(rvals.long(), exp_vals), "range values differ")

    for name, call, check in (("count", d.count, check_count), ("range", d.range, check_range)):
        dt = timed(lambda: call(k1, k2, plan), check, reps)
        rates[f"{name}_M_q_per_s"] = reps * n_windows / dt / 1e6
        log(f"phase 4 {name}: {reps} calls of {n_windows} windows of 1024 keys after a warm-up, {dt:.4f} s, "
            f"{rates[f'{name}_M_q_per_s']:.3f} M q/s")

    for name, step in (("maintain", lambda h: h.maintain(7 * b)), ("cleanup", lambda h: h.cleanup())):
        sync()
        t0 = time.perf_counter()
        d = step(d)
        sync()
        rates[f"{name}_s"] = time.perf_counter() - t0
        log(f"phase 4 {name}: {rates[f'{name}_s']:.4f} s, r = {d.state.r}")
    lookup_checker(q, "lookup after cleanup")(d.lookup(q))
    t0 = time.perf_counter()
    size = int(d.size())
    rates["size_s"] = time.perf_counter() - t0
    require(size == live.numel(), f"size {size} != oracle {live.numel()}")
    require(not d.overflowed(), "overflow latched")
    log(f"phase 4 size: {size} live of {n} inserted, {rates['size_s']:.4f} s; every result equals the oracle")
    return d, rates, q


# ---------------------------------------------------------------------------
# phase 5: kernel times at the main path's shapes
# ---------------------------------------------------------------------------


def time_ms(torch, fn, iters=5):
    fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def graph_ms(torch, fn, launches=20, reps=10):
    """Device-only time of one `fn()`: `launches` calls captured in one CUDA
    graph, the graph replayed `reps` times between two CUDA events, so no
    host time falls between the kernels."""
    stream = torch.cuda.Stream()
    stream.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(stream):
        fn()  # warm-up on the capture stream
    torch.cuda.current_stream().wait_stream(stream)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph, stream=stream):
        for _ in range(launches):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        graph.replay()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / (launches * reps)


def kernel_ms(torch, fn, names, reps=5):
    """Device time per call of each kernel whose name contains one of
    `names`, from `reps` calls of `fn` under torch.profiler."""
    from torch.profiler import ProfilerActivity, profile as torch_profile

    fn()
    torch.cuda.synchronize()
    with torch_profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    times = {name: 0.0 for name in names}
    for e in prof.key_averages():
        for name in names:
            if e.device_type.name == "CUDA" and name in e.key:
                times[name] += e.self_device_time_total / 1e3 / reps
    return times


def launch_host_us(torch, device, runs):
    """Host microseconds per call of the bound kernel's launch path, this
    tree's `Kernel.launch` against the path it replaced (the device made
    current and `torch.cuda.current_stream` read on every launch), in turns;
    and of the whole `lsm_lookup.bound` and `bounds_runs` wrappers (on
    `runs`). Each with 32 queries, so the card keeps up with the host."""
    from repro_torch.kernels import lsm_lookup

    kernel = lsm_lookup.BOUND_KERNEL
    keys = torch.arange(0, 8192, 2, dtype=torch.int32, device=device)
    q = torch.arange(0, 32, dtype=torch.int32, device=device)
    out = torch.empty(32, dtype=torch.int32, device=device)
    args = (keys.data_ptr(), keys.numel(), q.data_ptr(), 32, 1, 0, out.data_ptr())
    fn = kernel._load()["repro_bound"]

    def replaced():
        with torch.cuda.device(device):
            err = fn(*args, torch.cuda.current_stream(device).cuda_stream)
        require(err == 0, "launch failed")

    paths = {"replaced": replaced, "launch": lambda: kernel.launch(device, *args),
             "bound wrapper": lambda: lsm_lookup.bound(keys, q),
             f"bounds_runs wrapper ({len(runs)} runs)": lambda: lsm_lookup.bounds_runs(runs, q, q)}
    us = {name: [] for name in paths}
    for _ in range(2):
        for name, call in paths.items():
            for _ in range(200):
                call()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            for _ in range(5000):
                call()
            us[name].append((time.perf_counter() - t0) / 5000 * 1e6)
            torch.cuda.synchronize()
    return us


def depth(n: int) -> int:
    """Probes of one binary search over n keys."""
    return n.bit_length()


def search_footprint(torch, kv, q, active, upper=False):
    """Replay a binary search (csrc/common.cuh repro_search: the fewest keys a
    comparison search reads) of the lower bound (or upper bound) on original
    keys for the `active` queries. Returns the bounds, a mask of the keys the
    searches read, and the number of probes."""
    n = kv.shape[0]
    seen = torch.zeros(n, dtype=torch.bool, device=kv.device)
    lo = torch.zeros(q.shape, dtype=torch.int64, device=kv.device)
    hi = torch.where(active, torch.full_like(lo, n), lo)
    probes = torch.zeros((), dtype=torch.int64, device=kv.device)
    for _ in range(depth(n)):
        live = lo < hi
        mid = lo + ((hi - lo) >> 1)
        seen[mid[live]] = True
        probes += live.sum()
        v = kv[mid.clamp(max=n - 1)] >> 1
        right = v <= q if upper else v < q
        lo = torch.where(live & right, mid + 1, lo)
        hi = torch.where(live & ~right, mid, hi)
    return lo, seen, int(probes)


def bound(nbytes, ops):
    """(bound_ms, bound_by): the larger of bytes over the HBM rate and
    operations over the peak rate."""
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S * 1e3, ops / OPS_PER_S * 1e3
    return max(t_bytes, t_ops), "bytes" if t_bytes >= t_ops else "operations"


def checker(torch, errs):
    def check(name, kernel_fn, plain_fn):
        errs[name] = max(errs[name], max_err(torch, kernel_fn(), plain_fn()))
        require(errs[name] == 0, f"{name} differs from its plain version at the main path's shape")
    return check


def lookup_footprint(torch, kvs, vals, q):
    """Replay the lookup's searches (the runs newest first, each query's
    binary search until its first match) on the data. Returns the distinct
    keys and values read, the distinct 32-byte sectors they lie in, and the
    probes and match checks."""
    from repro_torch.kernels import lsm_lookup

    nq = q.shape[0]
    active = torch.ones(nq, dtype=torch.bool, device=q.device)
    read = sectors = probes = 0
    for kv, val in zip(kvs, vals):
        n = kv.shape[0]
        if n == 0:
            continue
        idx, seen, p = search_footprint(torch, kv, q, active)
        ends = active & (idx < n)
        seen[idx[ends]] = True
        hit = ends & ((kv[idx.clamp(max=n - 1)] >> 1) == q)
        val_read = torch.unique(idx[hit])
        read += int(seen.sum()) + val_read.numel()
        sectors += torch.unique((kv.data_ptr() // 4 + seen.nonzero()) >> 3).numel()
        sectors += torch.unique((val.data_ptr() // 4 + val_read) >> 3).numel()
        probes += p + int(ends.sum())
        active &= ~hit
    got_kv, _ = lsm_lookup.fused_lookup_runs(kvs, vals, q)
    require(torch.equal(~active, (got_kv >> 1) == q), "lookup footprint replay differs")
    return read, sectors, probes


def lookup_times(torch, kvs, vals, q, check, what):
    """The lookup kernel at one shape: held against its plain version (exact),
    then timed back to back, device only (a replayed graph), and its plain
    version. Bytes of the bound: the queries and both outputs once, and each
    distinct key and value the searches read once; beside it, the same reads
    counted in whole 32-byte sectors. Operations: one compare per probe and
    per match check. Returns the row's (ms, plain_ms, library_ms, bytes, ops,
    also)."""
    from repro_torch.kernels import lsm_lookup

    check("fused_lookup", lambda: lsm_lookup.fused_lookup_runs(kvs, vals, q),
          lambda: lsm_lookup.fused_lookup_plain(kvs, vals, q))
    ms = time_ms(torch, lambda: lsm_lookup.fused_lookup_runs(kvs, vals, q), iters=20)
    device = graph_ms(torch, lambda: lsm_lookup.fused_lookup_runs(kvs, vals, q))
    plain = time_ms(torch, lambda: lsm_lookup.fused_lookup_plain(kvs, vals, q), iters=3)
    nq = q.shape[0]
    read, sectors, probes = lookup_footprint(torch, kvs, vals, q)
    elem_bound = bound(12 * nq + 4 * read, probes)[0]
    sector_bound = bound(12 * nq + 32 * sectors, probes)[0]
    log(f"  lookup footprint, {what}: {probes} probes and checks, {read} distinct elements read in {sectors} "
        f"32-byte sectors; bound {elem_bound:.5f} ms by elements, {sector_bound:.5f} ms by sectors")

    also = [dict(what=f"{what}, {nq} queries: device only (graph of 20 launches); bound by 32-byte sectors",
                 ms=None, device_ms=device, bound_ms=elem_bound, sector_bound_ms=sector_bound, sectors=sectors)]
    return ms, plain, None, 12 * nq + 4 * read, probes, also


def kernel_rows(torch, d, q_lookup, k1, errs, launches):
    """Per kernel, at the main path's shapes and on its final state: hold the
    kernel against its plain version once more (exact), then time the kernel,
    the plain version and the library call."""
    from repro_torch.kernels import lsm_lookup, merge_path

    st = d.state  # runs newest first: the sorted write buffer, then level 0..L-1
    kvs, vals = [st.buf_sorted_kv, *st.key_vars], [st.buf_sorted_val, *st.values]
    lens = [kv.shape[0] for kv in kvs]
    total = sum(lens)
    rows = []
    check = checker(torch, errs)

    def row(name, source, replaces, ms, plain_ms, library_ms, nbytes, ops, also=()):
        bound_ms, bound_by = bound(nbytes, ops)
        rows.append(dict(name=name, route="cuda", source=source, replaces=replaces,
                         launches=launches[name], max_abs_err=errs[name], ms=ms, plain_ms=plain_ms,
                         bound_ms=bound_ms, bound_by=bound_by, library_ms=library_ms, also=list(also)))

    def cascade_times(kvs, vals, what, iters):
        """Kernel, plain and library (a stable `torch.sort` of the original
        keys) times of one cascade merge, and its byte bound."""
        orig = torch.cat(kvs) >> 1
        ms = time_ms(torch, lambda: merge_path.merge_cascade_path(kvs, vals), iters=iters)
        plain = time_ms(torch, lambda: merge_path.merge_cascade_plain(kvs, vals), iters=2)
        lib = time_ms(torch, lambda: torch.sort(orig, stable=True), iters=iters)
        return dict(what=what, ms=ms, plain_ms=plain, bound_ms=bound(16 * orig.numel(), 0)[0], library_ms=lib)

    # Merge: every run of the structure, as size() merges them; and one
    # push_batch of the cascade at b = 2^16 (the carry and levels 0..5 into
    # level 6: K = 7, 2^22 elements), on runs made like the LSM's.
    check("merge_cascade", lambda: merge_path.merge_cascade_path(kvs, vals),
          lambda: merge_path.merge_cascade_plain(kvs, vals))
    whole = cascade_times(kvs, vals, f"size() merge, {len(kvs)} runs, {total} slots", 3)
    b = st.buf_sorted_kv.shape[0]
    push_kv, push_val = [], []
    for n in [b] + [b << j for j in range(6)]:
        keys = torch.sort(torch.randint(0, MAX_USER_KEY + 1, (n - n // 4,), device=kvs[0].device,
                                        dtype=torch.int32)).values
        push_kv.append(torch.cat([(keys << 1) | (keys & 1), torch.full((n // 4,), PLACEBO_KV, dtype=torch.int32,
                                                                       device=keys.device)]))
        push_val.append(torch.arange(n, dtype=torch.int32, device=keys.device))
    check("merge_cascade", lambda: merge_path.merge_cascade_path(push_kv, push_val),
          lambda: merge_path.merge_cascade_plain(push_kv, push_val))
    push = cascade_times(push_kv, push_val, f"push_batch merge, 7 runs, {sum(x.shape[0] for x in push_kv)} slots", 20)
    del push_kv, push_val
    row("merge_cascade", "src/repro_torch/csrc/merge_cascade.cu", "src/repro/kernels/merge_path.py:263",
        whole["ms"], whole["plain_ms"], whole["library_ms"], 16 * total, total * (len(kvs) - 1).bit_length(),
        also=[push])

    # Bound: count/range stage 1 as the main path runs it, one `bounds_runs`
    # launch: every run, the lower bound of k1 and the upper bound of
    # k2 = k1 + 1023 (library: 26 `torch.searchsorted`). Bytes: k1, k2 and
    # both outputs once, and each distinct key the binary searches of a run
    # read once (a key that both ends' searches read counts once: the top of
    # each run's search tree). Beside it, the same device only (a replayed
    # graph), the 26 single-run launches that stage 1 made before (`bound`
    # per run and end), and one single-run search (`bound`, the deepest full
    # level against the windows, the row's shape before).
    require(st.r > 0, "no full level to search")
    nq = k1.shape[0]
    k2 = k1 + 1023
    check("bound", lambda: lsm_lookup.bounds_runs(kvs, k1, k2), lambda: lsm_lookup.bounds_runs_plain(kvs, k1, k2))
    origs = [kv >> 1 for kv in kvs]

    def library_stage1():
        for o in origs:
            torch.searchsorted(o, k1)
            torch.searchsorted(o, k2, right=True)

    def per_run_stage1():
        for kv in kvs:
            lsm_lookup.bound(kv, k1)
            lsm_lookup.bound(kv, k2, upper=True)

    everyone = torch.ones_like(k1, dtype=torch.bool)
    lows, highs = lsm_lookup.bounds_runs(kvs, k1, k2)
    read = probes = 0
    for j, kv in enumerate(kvs):
        if kv.shape[0]:
            lo, seen_lo, p_lo = search_footprint(torch, kv, k1, everyone)
            hi, seen_hi, p_hi = search_footprint(torch, kv, k2, everyone, upper=True)
            require(torch.equal(lo.to(torch.int32), lows[j]) and torch.equal(hi.to(torch.int32), highs[j]),
                    "stage 1 footprint replay differs")
            read, probes = read + int((seen_lo | seen_hi).sum()), probes + p_lo + p_hi
    log(f"  stage 1 footprint: {probes} probes, {read} distinct keys read of {total}")
    stage1_args = (8 * nq + 8 * len(kvs) * nq + 4 * read, probes)
    ms = time_ms(torch, lambda: lsm_lookup.bounds_runs(kvs, k1, k2), iters=20)
    plain = time_ms(torch, lambda: lsm_lookup.bounds_runs_plain(kvs, k1, k2), iters=2)
    lib = time_ms(torch, library_stage1, iters=5)
    stage1_device = dict(what=f"stage 1 device only: bounds_runs, {len(kvs)} runs, {nq} windows, both ends "
                              f"(graph of 20 launches; library: {2 * len(kvs)} torch.searchsorted, graph of 2 stages)",
                         ms=graph_ms(torch, lambda: lsm_lookup.bounds_runs(kvs, k1, k2)),
                         bound_ms=bound(*stage1_args)[0], library_ms=graph_ms(torch, library_stage1, launches=2))
    per_run = dict(what=f"stage 1 as {2 * len(kvs)} single-run bound launches (before this design), "
                        "back to back and device only (graph of 2 stages)",
                   ms=time_ms(torch, per_run_stage1, iters=5),
                   device_ms=graph_ms(torch, per_run_stage1, launches=2), bound_ms=bound(*stage1_args)[0])
    log(f"  stage 1: one bounds_runs launch {ms:.4f} ms back to back, {stage1_device['ms']:.4f} device "
        f"only; {2 * len(kvs)} torch.searchsorted {lib:.4f} / {stage1_device['library_ms']:.4f}; "
        f"{2 * len(kvs)} single-run bound launches {per_run['ms']:.4f} / {per_run['device_ms']:.4f}")

    level = st.key_vars[st.r.bit_length() - 1]
    level_orig = level >> 1
    check("bound", lambda: [lsm_lookup.bound(level, k1)],
          lambda: [lsm_lookup.search_plain(level, k1, shift=1, upper=False)])
    idx, seen, p = search_footprint(torch, level, k1, everyone)
    require(torch.equal(idx.to(torch.int32), lsm_lookup.bound(level, k1)), "bound footprint replay differs")
    log(f"  single-run bound footprint: {p} probes, {int(seen.sum())} distinct keys read of {level.shape[0]}")
    one_run_bound = bound(8 * nq + 4 * int(seen.sum()), p)[0]
    one_run = dict(what=f"one run of {level.shape[0]} (the deepest full level), {nq} queries, lower bound: "
                        "back to back, and device only (graph of 20 launches)",
                   ms=time_ms(torch, lambda: lsm_lookup.bound(level, k1), iters=20),
                   device_ms=graph_ms(torch, lambda: lsm_lookup.bound(level, k1)),
                   plain_ms=time_ms(torch, lambda: lsm_lookup.search_plain(level, k1, shift=1, upper=False),
                                    iters=5),
                   bound_ms=one_run_bound,
                   library_ms=time_ms(torch, lambda: torch.searchsorted(level_orig, k1), iters=20),
                   library_device_ms=graph_ms(torch, lambda: torch.searchsorted(level_orig, k1)))
    row("bound", "src/repro_torch/csrc/bounds.cu", "src/repro/kernels/lsm_lookup.py:88",
        ms, plain, lib, *stage1_args, also=[stage1_device, per_run, one_run])
    us = launch_host_us(torch, level.device, kvs)
    log("  launch path, host us per call (two turns each): " + "; ".join(
        f"{name} {', '.join(f'{x:.2f}' for x in v)}" for name, v in us.items()))

    # Lookup: the lookup queries against every run, newest first, as phase 4
    # left them after cleanup (every level a slice of one key range); beside
    # it, device only (a replayed graph). The single-run sorted-array line is
    # added after phase 6, on its data.
    row("fused_lookup", "src/repro_torch/csrc/fused_lookup.cu", "src/repro/kernels/lsm_lookup.py:179",
        *lookup_times(torch, kvs, vals, q_lookup, check, f"{len(kvs)} runs, {total} slots"))
    log_rows(rows)
    return rows


def sa_lookup_line(torch, device, sa_d, rows, errs, seed):
    """The lookup row at the sorted array's shape (one run of capacity 2^27
    slots, phase 6's final state): 2^20 queries, half of them its keys."""
    st = sa_d.state
    gen = torch.Generator(device=device)
    gen.manual_seed(seed + 3)
    q = lookup_queries(torch, gen, [st.key_vars[: int(st.n)]], MAX_USER_KEY + 1, 1 << 20, device)
    ms, plain, _, nbytes, ops, also = lookup_times(torch, [st.key_vars], [st.values], q, checker(torch, errs),
                                                   f"the sorted array's one run of {st.key_vars.shape[0]} slots")
    also[0].update(ms=ms, plain_ms=plain, bound_ms=bound(nbytes, ops)[0])
    r = next(r for r in rows if r["name"] == "fused_lookup")
    r["also"] += also
    r["max_abs_err"] = errs["fused_lookup"]
    log(f"phase 5 fused_lookup, sorted array's shape: {ms:.4f} ms back to back, {also[0]['device_ms']:.4f} device only "
        f"(bound {also[0]['bound_ms']:.5f}, by sectors {also[0]['sector_bound_ms']:.5f}, plain {plain:.4f})")


def profile(torch, what, fn, top=5, show=(), phase=5):
    """`fn()` under torch.profiler: wall time, device busy time (the sum of
    kernel times on the one stream), the `top` kernels and the time and busy
    share of the kernels named in `show`. Returns fn's result."""
    from torch.profiler import ProfilerActivity, profile as torch_profile

    with torch_profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        res = fn()
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6
    kernels = [e for e in prof.key_averages() if e.device_type.name == "CUDA"]
    busy_us = sum(e.self_device_time_total for e in kernels)
    ranked = sorted(kernels, key=lambda e: -e.self_device_time_total)[:top]
    log(f"phase {phase} profile: {what}, wall {wall_us / 1e3:.2f} ms, device busy "
        f"{busy_us / 1e3:.2f} ms, idle share {1 - busy_us / wall_us:.3f}; top kernels: "
        + "; ".join(f"{e.key[:60]} {e.self_device_time_total / 1e3:.3f} ms x{e.count}" for e in ranked))
    for name in show:
        us = sum(e.self_device_time_total for e in kernels if name in e.key)
        log(f"  {name}: {us / 1e3:.4f} ms, {us / busy_us:.4f} of device busy")
    return res


def profile_direct(torch, device, lsm_d, sa_d, b, count, seed):
    """`count` more direct batches of b random lanes on each structure of
    phase 6 (after its checks), under the profiler."""
    from repro_torch.core import lsm, sorted_array

    gen = torch.Generator(device=device)
    gen.manual_seed(seed + 2)
    keys = torch.randint(0, MAX_USER_KEY + 1, (count, b), generator=gen, device=device, dtype=torch.int32)
    dels = torch.rand((count, b), generator=gen, device=device) < 0.2
    kv = (keys << 1) | (~dels).to(torch.int32)
    st = lsm_d.state
    cfg = lsm.LSMConfig(b, st.num_levels)

    def lsm_batches():
        for i in range(count):
            lsm.lsm_update_mixed(cfg, st, keys[i], keys[i], dels[i])

    sa_cfg = sorted_array.SAConfig(sa_d.capacity)

    def sa_batches():
        for i in range(count):
            sorted_array.sa_update_batch(sa_cfg, sa_d.state, kv[i], keys[i])

    profile(torch, f"{count} direct LSM batches of {b} lanes", lsm_batches)
    profile(torch, f"{count} direct sorted-array batches of {b} lanes", sa_batches)


# ---------------------------------------------------------------------------
# phase 6: the paper-exact update path, bulk build and the sorted array
# ---------------------------------------------------------------------------


def oracle_live(torch, keys, prio, status, vals, prio_bits):
    """The dictionary after a set of writes: per key, the write of the
    smallest priority wins, and the key is live if that write is an insert.
    Returns (live keys ascending, their values as int64)."""
    comp, order = torch.sort((keys.long() << prio_bits) | prio)
    k = comp >> prio_bits
    first = torch.ones_like(k, dtype=torch.bool)
    first[1:] = k[1:] != k[:-1]
    win = order[first]
    live = status[win] == 1
    return k[first][live], vals[win][live].long()


def query_checks(torch, live, live_vals, q, k1, k2, max_results):
    """Checkers of lookup, count and range results against a live set."""
    idx = torch.searchsorted(live, q).clamp(max=live.numel() - 1)
    exp_found = live[idx] == q
    exp_lookup = torch.where(exp_found, live_vals[idx], 0)
    lo = torch.searchsorted(live, k1)
    exp_counts = torch.searchsorted(live, k2, right=True) - lo
    require(int(exp_counts.max()) <= max_results, "a window holds more than max_results live keys")
    col = torch.arange(max_results, device=q.device)
    inside = col[None, :] < exp_counts[:, None]
    src = (lo[:, None] + col[None, :]).clamp(max=live.numel() - 1)
    exp_keys = torch.where(inside, live[src], PLACEBO_KEY)
    exp_vals = torch.where(inside, live_vals[src], 0)

    def lookup(res, what):
        found, got = res
        require(torch.equal(found, exp_found), f"{what}: lookup found differs")
        require(torch.equal(got.long(), exp_lookup), f"{what}: lookup values differ")

    def count(res, what):
        counts, ok = res
        require(bool(ok.all()), f"{what}: count plan truncated")
        require(torch.equal(counts.long(), exp_counts), f"{what}: count differs")

    def range_(res, what):
        rkeys, rvals, rcounts, rok = res
        require(bool(rok.all()), f"{what}: range plan truncated")
        require(torch.equal(rcounts.long(), exp_counts), f"{what}: range counts differ")
        require(torch.equal(rkeys, exp_keys), f"{what}: range keys differ")
        require(torch.equal(rvals.long(), exp_vals), f"{what}: range values differ")
    return lookup, count, range_


def paper_rule_prio(torch, dels):
    """Write priorities (smaller wins) of the lanes of [count, b] direct
    batches under the paper's rule: a later batch first; within a batch a
    tombstone first, then inserts in lane order (the stable sort by the full
    key variable). Returns (flat priorities, flat status bits, bits used)."""
    count, b = dels.shape
    lane_bits = (b - 1).bit_length()
    batch = torch.arange(count, device=dels.device)[:, None]
    lane = torch.arange(b, device=dels.device)[None, :]
    status = (~dels).long()
    prio = ((count - 1 - batch) << (lane_bits + 1)) | (status << lane_bits) | lane
    return prio.reshape(-1), status.reshape(-1), (count - 1).bit_length() + 1 + lane_bits


def recency_prio(torch, dels):
    """The same under the write buffer's rule (facade calls): a later call
    first, and within a call the later lane, whatever its status."""
    count, b = dels.shape
    lane_bits = (b - 1).bit_length()
    call = torch.arange(count, device=dels.device)[:, None]
    lane = torch.arange(b, device=dels.device)[None, :]
    prio = ((count - 1 - call) << lane_bits) | (b - 1 - lane)
    return prio.reshape(-1), (~dels).long().reshape(-1), (count - 1).bit_length() + lane_bits


def drive_slice(torch, device, seed, *, log2_bulk, b, capacity, lsm_batches, sa_calls, sa_batches,
                n_lookups, n_windows):
    """Bulk build, direct paper-rule updates and queries on the LSM, then the
    same on the sorted array with facade (recency-rule) calls as well; every
    answer held against an oracle built on the device from `seed`. Returns
    (rates dict, bulk keys, bulk values, LSM handle, sorted-array handle),
    the handles after their final cleanup."""
    from repro_torch.api import Dictionary, QueryPlan
    from repro_torch.core import lsm, sorted_array

    def sync():
        if device.type == "cuda":
            torch.cuda.synchronize()

    gen = torch.Generator(device=device)
    gen.manual_seed(seed + 1)

    def randint(hi, size):
        return torch.randint(0, hi, (size,), generator=gen, device=device, dtype=torch.int32)

    t0 = time.perf_counter()
    n = 1 << log2_bulk
    cand = torch.unique(randint(MAX_USER_KEY + 1, n + n // 8))
    require(cand.numel() >= n, "too few unique candidate keys")
    bulk_keys = cand[torch.randperm(cand.numel(), generator=gen, device=device)[:n]]
    bulk_vals = randint(1 << 30, n)
    bulk_status = torch.ones(n, dtype=torch.long, device=device)
    del cand

    def batches(count, first_value):
        """`count` batches of b lanes, flat: new keys, re-writes and deletes
        of bulk keys, and in-batch duplicates of an earlier lane's key (half
        of them deletes). Values are distinct and positive."""
        total = count * b
        kind = torch.rand(total, generator=gen, device=device)
        keys = torch.where(kind < 0.3, randint(MAX_USER_KEY + 1, total), bulk_keys[randint(n, total).long()])
        dels = (kind >= 0.6) & (kind < 0.75)
        back = 1 + randint(16, total).long()
        lanes = torch.arange(total, device=device)
        dup = (kind >= 0.75) & (lanes % b >= back)
        src = torch.where(dup, lanes - back, lanes)
        keys = keys[src]
        dels = torch.where(dup, torch.rand(total, generator=gen, device=device) < 0.5, dels)
        vals = first_value + lanes.to(torch.int32)
        return keys.view(count, b), vals.view(count, b), dels.view(count, b), int(dup.sum())

    rates = {}
    plan = QueryPlan(max_candidates=1024, max_results=512)
    k1 = randint(MAX_USER_KEY - 1022, n_windows)
    k2 = k1 + 1023

    def queries(d, live, live_vals, what):
        q = torch.cat([live[randint(live.numel(), n_lookups // 2).long()],
                       randint(MAX_USER_KEY + 1, n_lookups - n_lookups // 2)])
        lookup, count, range_ = query_checks(torch, live, live_vals, q, k1, k2, plan.max_results)
        for name, call, check in (("lookup", lambda: d.lookup(q), lookup),
                                  ("count", lambda: d.count(k1, k2, plan), count),
                                  ("range", lambda: d.range(k1, k2, plan), range_)):
            sync()
            t1 = time.perf_counter()
            res = call()
            sync()
            check(res, f"{what} {name}")
            log(f"phase 6 {what} {name}: {time.perf_counter() - t1:.4f} s, equal to the oracle")
        t1 = time.perf_counter()
        d = d.cleanup()
        sync()
        log(f"phase 6 {what} cleanup: {time.perf_counter() - t1:.4f} s")
        lookup(d.lookup(q), f"{what} lookup after cleanup")
        size = int(d.size())
        require(size == live.numel(), f"{what}: size {size} != oracle {live.numel()}")
        require(not d.overflowed(), f"{what}: overflow latched")
        log(f"phase 6 {what} size: {size} live; every result equals the oracle")
        return d

    # --- LSM: bulk build, then direct updates under the paper's in-batch rule.
    keys, vals, dels, n_dup = batches(lsm_batches, 1)
    prio, status, bits = paper_rule_prio(torch, dels)  # the bulk build is older than every batch
    live, live_vals = oracle_live(
        torch, torch.cat([keys.reshape(-1), bulk_keys]), torch.cat([prio, torch.full((n,), 1 << bits, device=device)]),
        torch.cat([status, bulk_status]), torch.cat([vals.reshape(-1), bulk_vals]), bits + 1)
    sync()
    log(f"phase 6 set-up: {n} bulk keys, {lsm_batches} batches of {b} lanes ({n_dup} in-batch duplicates), "
        f"oracle of {live.numel()} live keys, {time.perf_counter() - t0:.2f} s")

    d = Dictionary.create("lsm", batch_size=b, capacity=capacity, device=device)
    st = d.state
    cfg = lsm.LSMConfig(b, st.num_levels)
    require(cfg.num_levels == (capacity // b).bit_length() and st.arena_kv.numel() == b << cfg.num_levels,
            "unexpected LSM shape")
    sync()
    t1 = time.perf_counter()
    d = d.bulk_build(bulk_keys, bulk_vals)
    sync()
    rates["lsm_bulk_build_M_elem_per_s"] = n / (time.perf_counter() - t1) / 1e6
    st = d.state
    require(st.r == n // b, f"bulk build left r = {st.r}")
    t1 = time.perf_counter()
    for i in range(lsm_batches):
        lsm.lsm_update_mixed(cfg, st, keys[i], vals[i], dels[i])
    sync()
    dt = time.perf_counter() - t1
    rates["lsm_update_M_elem_per_s"] = lsm_batches * b / dt / 1e6
    require(st.r == n // b + lsm_batches and not st.overflowed, f"after the updates r = {st.r}")
    log(f"phase 6 lsm: bulk build {rates['lsm_bulk_build_M_elem_per_s']:.3f} M elem/s; {lsm_batches} direct "
        f"batches {dt:.3f} s, {rates['lsm_update_M_elem_per_s']:.3f} M elem/s; L = {cfg.num_levels}, r = {st.r}")
    del keys, vals, dels, st
    lsm_d = queries(d, live, live_vals, "lsm")
    del d, live, live_vals

    # --- Sorted array: bulk build, facade calls (the later lane and call
    # win), then direct batches (the paper's rule), which are newest.
    t0 = time.perf_counter()
    f_keys, f_vals, f_dels, f_dup = batches(sa_calls, 1 << 28)
    kind = torch.arange(sa_calls, device=device) % 3  # insert, delete, mixed update
    f_dels = torch.where((kind == 1)[:, None], True, torch.where((kind == 0)[:, None], False, f_dels))
    e_keys, e_vals, e_dels, e_dup = batches(sa_batches, 1 << 29)
    # Newest first: the direct batches, then the facade calls, then the bulk build.
    e_prio, e_status, e_bits = paper_rule_prio(torch, e_dels)
    f_prio, f_status, f_bits = recency_prio(torch, f_dels)
    top = (1 << e_bits) + (1 << f_bits)
    live, live_vals = oracle_live(
        torch, torch.cat([e_keys.reshape(-1), f_keys.reshape(-1), bulk_keys]),
        torch.cat([e_prio, (1 << e_bits) + f_prio, torch.full((n,), top, device=device)]),
        torch.cat([e_status, f_status, bulk_status]),
        torch.cat([e_vals.reshape(-1), f_vals.reshape(-1), bulk_vals]), top.bit_length())
    sync()
    log(f"phase 6 sa set-up: {sa_calls} facade calls and {sa_batches} direct batches of {b} lanes "
        f"({f_dup + e_dup} in-batch duplicates), oracle of {live.numel()} live keys, "
        f"{time.perf_counter() - t0:.2f} s")

    d = Dictionary.create("sorted_array", capacity=capacity, batch_size=b, device=device)
    cfg = sorted_array.SAConfig(capacity)
    sync()
    t1 = time.perf_counter()
    d = d.bulk_build(bulk_keys, bulk_vals)
    sync()
    rates["sa_bulk_build_M_elem_per_s"] = n / (time.perf_counter() - t1) / 1e6
    t1 = time.perf_counter()
    for c in range(sa_calls):
        if c % 3 == 0:
            d = d.insert(f_keys[c], f_vals[c])
        elif c % 3 == 1:
            d = d.delete(f_keys[c])
        else:
            d = d.update(f_keys[c], f_vals[c], is_delete=f_dels[c])
    sync()
    rates["sa_facade_M_elem_per_s"] = sa_calls * b / (time.perf_counter() - t1) / 1e6
    e_kv = (e_keys << 1) | (~e_dels).to(torch.int32)
    e_vals = torch.where(e_dels, 0, e_vals)
    st = d.state
    t1 = time.perf_counter()
    for e in range(sa_batches):
        sorted_array.sa_update_batch(cfg, st, e_kv[e], e_vals[e])
    sync()
    dt = time.perf_counter() - t1
    rates["sa_update_M_elem_per_s"] = sa_batches * b / dt / 1e6
    require(int(st.n) == n + (sa_calls + sa_batches) * b, f"sa n = {int(st.n)}")
    log(f"phase 6 sa: bulk build {rates['sa_bulk_build_M_elem_per_s']:.3f} M elem/s; {sa_calls} facade calls "
        f"{rates['sa_facade_M_elem_per_s']:.3f} M elem/s; {sa_batches} direct batches {dt:.3f} s, "
        f"{rates['sa_update_M_elem_per_s']:.3f} M elem/s")
    del st
    return rates, bulk_keys, bulk_vals, lsm_d, queries(d, live, live_vals, "sa")


def slice_kernel_rows(torch, device, bulk_keys, bulk_vals, b, capacity, errs, launches):
    """The rows of the batch sort and the pairwise merge, on phase 6's data:
    each kernel held once more against its plain version at these shapes,
    then timed beside its plain version and a stable `torch.sort`."""
    from repro_torch.kernels import bitonic_sort, merge_path

    check = checker(torch, errs)
    kv, val = (bulk_keys << 1) | 1, bulk_vals
    n = kv.shape[0]

    def sort_lib(x, v):
        s, order = torch.sort(x, stable=True)
        return s, v[order]

    # The whole sort (tile sort, then its K-way rounds) at 2^26 and at b;
    # the library call is a stable `torch.sort` plus the value gather. The
    # bound is the least traffic: each element read and written once.
    whole = []
    for m in (n, b):
        x, v = kv[:m].contiguous(), val[:m].contiguous()
        check("bitonic_sort", lambda: bitonic_sort.bitonic_sort_pairs(x, v), lambda: bitonic_sort.sort_pairs_plain(x, v))
        whole.append(dict(what=f"sort_pairs whole, n = {m}, block sort + {len(bitonic_sort.merge_rounds(m))} "
                               f"K-way rounds {bitonic_sort.merge_rounds(m)}",
                          ms=time_ms(torch, lambda: bitonic_sort.bitonic_sort_pairs(x, v)),
                          plain_ms=time_ms(torch, lambda: bitonic_sort.sort_pairs_plain(x, v)),
                          bound_ms=bound(16 * m, 0)[0],
                          library_ms=time_ms(torch, lambda: sort_lib(x, v))))
    # Its parts at 2^26: the block sort (library: a stable row sort of the
    # tiles plus the gather) and the first K-way round (library: a stable
    # `torch.sort` of the array plus the gather).
    check("bitonic_sort", lambda: bitonic_sort.block_sort(kv, val), lambda: bitonic_sort.block_sort_plain(kv, val))
    tiles = kv.view(-1, bitonic_sort.TILE)
    whole.append(dict(what=f"block sort alone, n = {n}",
                      ms=time_ms(torch, lambda: bitonic_sort.block_sort(kv, val)),
                      plain_ms=time_ms(torch, lambda: bitonic_sort.block_sort_plain(kv, val)),
                      bound_ms=bound(16 * n, 0)[0],
                      library_ms=time_ms(torch, lambda: torch.take_along_dim(
                          val.view(-1, bitonic_sort.TILE), torch.sort(tiles, dim=1, stable=True).indices, dim=1))))
    width, k = bitonic_sort.merge_rounds(n)[0]
    tkv, tval = bitonic_sort.block_sort(kv, val)
    check("merge_cascade", lambda: merge_path.merge_groups(tkv, tval, width, k, compare_full=True),
          lambda: merge_path.merge_groups_plain(tkv, tval, width, k, shift=0))
    whole.append(dict(what=f"first K-way round alone, {k} runs of {width} a group, n = {n}",
                      ms=time_ms(torch, lambda: merge_path.merge_groups(tkv, tval, width, k, compare_full=True)),
                      plain_ms=time_ms(torch, lambda: merge_path.merge_groups_plain(tkv, tval, width, k, shift=0),
                                       iters=2),
                      bound_ms=bound(16 * n, 0)[0], library_ms=time_ms(torch, lambda: sort_lib(tkv, tval))))
    del tkv, tval
    top = whole.pop(0)
    rows = [dict(name="bitonic_sort", route="cuda", source="src/repro_torch/csrc/bitonic_sort.cu",
                 replaces="src/repro/kernels/bitonic_sort.py:74", launches=launches["bitonic_sort"],
                 max_abs_err=errs["bitonic_sort"], ms=top["ms"], plain_ms=top["plain_ms"],
                 bound_ms=top["bound_ms"], bound_by="bytes", library_ms=top["library_ms"], also=whole)]

    # Merge: two sorted halves of the 2^26 keys, and one SA merge of a sorted
    # 2^16 batch into a 2^27-slot array; the library call is a stable sort of
    # the concatenation on the same comparison key.
    half = n // 2
    rkv = torch.cat([torch.sort(kv[:half]).values, torch.sort(kv[half:]).values])
    halves = (rkv[:half], val[:half], rkv[half:], val[half:])
    check("merge_path", lambda: merge_path.merge_path(*halves, compare_full=True),
          lambda: merge_path.merge_path_plain(*halves, shift=0))
    ms = time_ms(torch, lambda: merge_path.merge_path(*halves, compare_full=True))
    plain = time_ms(torch, lambda: merge_path.merge_path_plain(*halves, shift=0))
    lib = time_ms(torch, lambda: sort_lib(rkv, val))
    bound_ms, bound_by = bound(16 * n, 0)
    passes = [merge_passes(torch, lambda: merge_path.merge_path(*halves, compare_full=True), f"two halves of {n}",
                           bound_ms)]
    del rkv, halves
    a_kv, a_val = bitonic_sort.sort_pairs_plain(kv[:b], val[:b])
    arr_kv, arr_val = torch.full((capacity,), PLACEBO_KV, dtype=torch.int32, device=device), torch.zeros(
        capacity, dtype=torch.int32, device=device)
    arr_kv[:n], arr_val[:n] = bitonic_sort.sort_pairs_plain(kv, val)
    out = (torch.empty(capacity + b, dtype=torch.int32, device=device),
           torch.empty(capacity + b, dtype=torch.int32, device=device))
    check("merge_path", lambda: merge_path.merge_path(a_kv, a_val, arr_kv, arr_val, out=out),
          lambda: merge_path.merge_path_plain(a_kv, a_val, arr_kv, arr_val))
    cat_kv, cat_val = torch.cat([a_kv, arr_kv]), torch.cat([a_val, arr_val])
    sa = dict(what=f"SA merge of {b} into {capacity} slots (shift 1)",
              ms=time_ms(torch, lambda: merge_path.merge_path(a_kv, a_val, arr_kv, arr_val, out=out)),
              plain_ms=time_ms(torch, lambda: merge_path.merge_path_plain(a_kv, a_val, arr_kv, arr_val)),
              bound_ms=bound(16 * (capacity + b), 0)[0],
              library_ms=time_ms(torch, lambda: sort_lib(cat_kv >> 1, cat_val)))
    passes.append(merge_passes(torch, lambda: merge_path.merge_path(a_kv, a_val, arr_kv, arr_val, out=out),
                               f"SA merge of {b} into {capacity} slots", sa["bound_ms"]))
    rows.append(dict(name="merge_path", route="cuda", source="src/repro_torch/csrc/merge_path.cu",
                     replaces="src/repro/kernels/merge_path.py:117", launches=launches["merge_path"],
                     max_abs_err=errs["merge_path"], ms=ms, plain_ms=plain, bound_ms=bound_ms, bound_by=bound_by,
                     library_ms=lib, also=[sa, *passes]))
    log_rows(rows)
    return rows


def merge_passes(torch, fn, what, bound_ms):
    """The Merge Path's two launches timed apart, device time per call from
    the profiler: the split pass and the tile merge (whose bound is the
    merge's: every byte moves there)."""
    t = kernel_ms(torch, fn, ["merge_split_kernel", "merge_tiles_kernel"])
    log(f"  merge_path passes, {what}: split {t['merge_split_kernel']:.4f} ms, merge {t['merge_tiles_kernel']:.4f} ms")
    return dict(what=f"{what}: split pass, then merge pass (profiler device ms)",
                ms=t["merge_split_kernel"] + t["merge_tiles_kernel"], split_ms=t["merge_split_kernel"],
                merge_ms=t["merge_tiles_kernel"], bound_ms=bound_ms)


# ---------------------------------------------------------------------------
# phase 7: the DictionaryServer, its fill and multi-tenant traffic
# ---------------------------------------------------------------------------


def resident_value(keys):
    """The value phase 7 writes for a key of its `resident` tenant."""
    return ((keys.astype(np.int64) * 7 + 3) % (1 << 30)).astype(np.int32)


def check_tickets(trace, results, oracles):
    """Apply `trace` to per-tenant dict oracles in trace order (each tenant's
    program order, as tenant extents are disjoint) and hold every ticket's
    result against them: lookup found and values, count counts and ok,
    range keys, values, counts and ok. Returns the keys each tenant touched."""
    touched = {}
    for i, (op, res) in enumerate(zip(trace, results)):
        o = oracles.setdefault(op.tenant, {})
        seen = touched.setdefault(op.tenant, set())
        if op.kind == "update":
            require(res == len(op.keys), f"op {i}: update resolved to {res}")
            for k, v, dl in zip(op.keys.tolist(), op.values.tolist(), op.is_delete.tolist()):
                if dl:
                    o.pop(k, None)
                else:
                    o[k] = v
            seen.update(op.keys.tolist())
        elif op.kind == "lookup":
            found, vals = res
            keys = op.keys.tolist()
            require(found.tolist() == [k in o for k in keys], f"op {i}: lookup found differs")
            require(vals.tolist() == [o.get(k, 0) for k in keys], f"op {i}: lookup values differ")
            seen.update(keys)
        else:
            k1, k2 = int(op.k1[0]), int(op.k2[0])
            live = sorted(k for k in o if k1 <= k <= k2)
            if op.kind == "count":
                counts, ok = res
                require(counts.tolist() == [len(live)] and ok.tolist() == [True], f"op {i}: count differs")
            else:
                rk, rv, rc, rok = res
                pad = op.max_results - len(live)
                require(pad >= 0 and rc.tolist() == [len(live)] and rok.tolist() == [True],
                        f"op {i}: range counts differ")
                require(rk[0].tolist() == live + [PLACEBO_KEY] * pad, f"op {i}: range keys differ")
                require(rv[0].tolist() == [o[k] for k in live] + [0] * pad, f"op {i}: range values differ")
    return touched


def check_end_state(srv, oracles, touched, sample, what):
    """Look up, through the server, every key each tenant touched and the
    sampled resident keys; hold them against the oracles."""
    tickets = {name: srv.submit_lookup(name, np.fromiter(sorted(keys), np.int64, len(keys)))
               for name, keys in touched.items()}
    res_ticket = srv.submit_lookup("resident", sample)
    srv.step()
    for name, t in tickets.items():
        o = oracles[name]
        keys = sorted(touched[name])
        found, vals = t.result()
        require(found.tolist() == [k in o for k in keys] and vals.tolist() == [o.get(k, 0) for k in keys],
                f"{what}: tenant {name} differs from its oracle")
    found, vals = res_ticket.result()
    require(bool(found.all()) and np.array_equal(vals, resident_value(sample)), f"{what}: resident keys differ")


def drive_server(torch, device, seed, *, b, capacity, log2_resident, fill_calls, tenants, key_space, events,
                 step_every, n_sample, max_candidates):
    """The DictionaryServer on the card: a `resident` tenant filled with
    2^log2_resident unique keys in `fill_calls` updates (a step after each),
    then `tenants` tenants replaying a `mixed` trace of `events` events
    through `replay_server`, one more profiled step of a second trace, and a
    cleanup; every ticket and the end state before and after the cleanup held
    against per-tenant oracles. Returns a rates dict."""
    from repro_torch.api import QueryPlan
    from repro_torch.serve import DictionaryServer, ServerConfig, make_trace
    from repro_torch.serve.traffic import replay_server

    def sync():
        if device.type == "cuda":
            torch.cuda.synchronize()

    gen = torch.Generator(device=device)
    gen.manual_seed(seed + 3)
    rates = {}
    # The auto-sized plan of a dictionary this large would give every count
    # and range window a tile of capacity / 4 candidates; trace windows span
    # at most 32 keys, so 1024 candidates hold every version of them.
    srv = DictionaryServer(ServerConfig(backend="lsm", batch_size=b, capacity=capacity, device=device,
                                        default_plan=QueryPlan(max_candidates=max_candidates)))
    n_res = 1 << log2_resident
    srv.register_tenant("resident", key_space=2 * n_res)
    res_keys = torch.randperm(2 * n_res, generator=gen, device=device)[:n_res].to(torch.int32).cpu().numpy()
    lanes = n_res // fill_calls
    sync()
    t0 = time.perf_counter()
    for c in range(fill_calls):
        keys = res_keys[c * lanes:(c + 1) * lanes]
        srv.submit_update("resident", keys, resident_value(keys))
        srv.step()
    sync()
    rates["fill_s"] = time.perf_counter() - t0
    rates["fill_M_elem_per_s"] = n_res / rates["fill_s"] / 1e6
    require(srv.pending_estimate() == srv.dictionary.pending(), "pending model differs from the buffer")
    log(f"phase 7 fill: {n_res} unique keys of tenant 'resident' in {fill_calls} updates of {lanes} lanes, "
        f"{rates['fill_s']:.3f} s, {rates['fill_M_elem_per_s']:.3f} M elem/s; r = {srv.dictionary.state.r}, "
        f"L = {srv.dictionary.state.num_levels}, flushes {srv.stats.flushes}")

    t0 = time.perf_counter()
    names, trace = make_trace("mixed", num_tenants=tenants, key_space=key_space, events=events, seed=seed,
                              window=32)
    _, more = make_trace("mixed", num_tenants=tenants, key_space=key_space, events=step_every, seed=seed + 1,
                         window=32)
    more = more[:step_every]
    for name in names:
        srv.register_tenant(name, key_space=key_space)
    log(f"phase 7 traffic: {len(trace)} ops of {tenants} tenants ({events} events), made in "
        f"{time.perf_counter() - t0:.2f} s")
    before = srv.stats.as_dict()
    sync()
    t0 = time.perf_counter()
    results = replay_server(srv, trace, step_every=step_every)
    rates["replay_s"] = time.perf_counter() - t0
    n_lanes = sum(op.lanes for op in trace)
    rates["replay_ops_per_s"] = len(trace) / rates["replay_s"]
    rates["replay_lanes_per_s"] = n_lanes / rates["replay_s"]
    after = srv.stats.as_dict()
    steps = after["device_steps"] - before["device_steps"]
    log(f"phase 7 replay: {len(trace)} ops, {n_lanes} lanes, step every {step_every} ops, {rates['replay_s']:.3f} s: "
        f"{rates['replay_ops_per_s']:.1f} ops/s, {rates['replay_lanes_per_s']:.1f} lanes/s; {steps} device steps, "
        f"{len(trace) / steps:.2f} ops per device step")

    submit = {"update": lambda op: srv.submit_update(op.tenant, op.keys, op.values, op.is_delete),
              "lookup": lambda op: srv.submit_lookup(op.tenant, op.keys),
              "count": lambda op: srv.submit_count(op.tenant, op.k1, op.k2),
              "range": lambda op: srv.submit_range(op.tenant, op.k1, op.k2, op.max_results)}
    tickets = [submit[op.kind](op) for op in more]
    what = f"one server step of {len(more)} ops"
    if device.type == "cuda":
        profile(torch, what, srv.step, top=6, show=("kway_merge_kernel", "bounds_runs_kernel", "fused_lookup_kernel",
                                                    "radixSort"), phase=7)
    else:
        srv.step()
    results_more = [t.result() for t in tickets]
    log(f"phase 7 stats: {json.dumps(srv.stats.as_dict())}")

    t0 = time.perf_counter()
    oracles = {}
    touched = check_tickets(trace + more, results + results_more, oracles)
    sample = res_keys[torch.randint(0, n_res, (n_sample,), generator=gen, device=device).cpu().numpy()]
    check_end_state(srv, oracles, touched, sample, "before cleanup")
    log(f"phase 7 check: {len(trace) + len(more)} tickets and the end state of {len(touched)} tenants and "
        f"{n_sample} resident keys equal to the oracles, {time.perf_counter() - t0:.2f} s")
    sync()
    t0 = time.perf_counter()
    srv.cleanup()
    sync()
    rates["cleanup_s"] = time.perf_counter() - t0
    check_end_state(srv, oracles, touched, sample, "after cleanup")
    require(not srv.dictionary.overflowed(), "overflow latched")
    log(f"phase 7 cleanup: {rates['cleanup_s']:.4f} s, r = {srv.dictionary.state.r}; the end state still equals "
        f"the oracles")
    return rates


# ---------------------------------------------------------------------------
# phase 8: the cuckoo baseline at Table 3's protocol
# ---------------------------------------------------------------------------


def drive_cuckoo(torch, device, seed, keys, vals, *, n_lookups, reps):
    """Bulk-build the cuckoo backend from `keys` (unique), then time lookups
    of keys all present and all absent, each result held against the keys.
    If the build rule cannot place every key in its 100 rounds, n is halved
    until it can (the cut is logged). Returns a rates dict."""
    from repro_torch.api import Dictionary

    def sync():
        if device.type == "cuda":
            torch.cuda.synchronize()

    gen = torch.Generator(device=device)
    gen.manual_seed(seed + 4)
    rates = {}
    n = keys.numel()
    while True:
        d = Dictionary.create("cuckoo", capacity=n, load_factor=0.8, max_rounds=100, device=device)
        sync()
        t0 = time.perf_counter()
        d = d.bulk_build(keys[:n], vals[:n])
        sync()
        rates["build_s"] = time.perf_counter() - t0
        if not d.overflowed():
            break
        log(f"phase 8: the build rule left keys of {n} unplaced after 100 rounds; halving n")
        n //= 2
        require(n >= n_lookups, "the cuckoo build failed at every size")
        del d
    rates["n"] = n
    rates["rounds"] = d.state.rounds
    rates["build_M_elem_per_s"] = n / rates["build_s"] / 1e6
    size = int(d.size())
    require(size == n, f"cuckoo size {size} != {n}")
    log(f"phase 8 build: {n} keys into {d.state.slot_keys.numel()} slots (load 0.8) in {rates['rounds']} rounds, "
        f"{rates['build_s']:.3f} s, {rates['build_M_elem_per_s']:.3f} M elem/s")

    idx = torch.randint(0, n, (n_lookups,), generator=gen, device=device)
    present, present_vals = keys[idx], vals[idx]
    ordered = torch.sort(keys[:n]).values
    cand = torch.randint(0, MAX_USER_KEY + 1, (2 * n_lookups,), generator=gen, device=device, dtype=torch.int32)
    hit = ordered[torch.searchsorted(ordered, cand).clamp(max=n - 1)] == cand
    absent = cand[~hit][:n_lookups]
    require(absent.numel() == n_lookups, "too few absent keys")
    for name, q, exp_found, exp_vals in (("present", present, True, present_vals),
                                          ("absent", absent, False, torch.zeros_like(absent))):
        found, got = d.lookup(q)
        require(bool((found == exp_found).all()) and torch.equal(got, exp_vals), f"cuckoo {name} lookups differ")
        sync()
        t0 = time.perf_counter()
        out = [d.lookup(q) for _ in range(reps)]
        sync()
        dt = time.perf_counter() - t0
        for found, got in out:
            require(bool((found == exp_found).all()) and torch.equal(got, exp_vals), f"cuckoo {name} lookups differ")
        rates[f"lookup_{name}_M_q_per_s"] = reps * n_lookups / dt / 1e6
        log(f"phase 8 lookup, {n_lookups} keys {name}: {reps} calls after a warm-up, {dt:.4f} s, "
            f"{rates[f'lookup_{name}_M_q_per_s']:.2f} M q/s; equal to the oracle")
    return rates


# ---------------------------------------------------------------------------
# phase 9: the dedup pipeline
# ---------------------------------------------------------------------------


def host_doc_hash(tokens):
    """The reference's rolling hash as it is written, h = h * 31 + token over
    the columns in uint32, on the host (numpy uint32 arithmetic wraps)."""
    h = np.zeros(tokens.shape[0], np.uint32)
    cols = tokens.astype(np.uint32)
    for j in range(tokens.shape[1]):
        h = h * np.uint32(31) + cols[:, j]
    return (h % np.uint32(MAX_USER_KEY)).astype(np.int32)


def host_batch(seed, shard, step, batch, seq_len, vocab):
    """The reference's make_batch tokens, generated here with numpy."""
    rng = np.random.default_rng((seed, shard, step))
    toks = (rng.zipf(1.3, size=(batch, seq_len + 1)) % vocab).astype(np.int32)
    return toks[:, :-1], toks[:, 1:]


def drive_dedup(torch, device, seed, *, vocab, seq_len, batch, levels, steps):
    """`steps` dedup steps of the pipeline, then step 0's batch replayed;
    duplicates, tokens and the index's contents held against a host set of
    the document hashes seen. Returns a rates dict."""
    from repro_torch.core import queries
    from repro_torch.data import pipeline

    def sync():
        if device.type == "cuda":
            torch.cuda.synchronize()

    cfg = pipeline.PipelineConfig(vocab_size=vocab, seq_len=seq_len, batch_per_shard=batch, dedup_levels=levels,
                                  seed=seed, device=device)
    state = pipeline.pipeline_init(cfg)
    seen = {}
    total = 0
    rates = {"make_s": 0.0, "dedup_s": 0.0}
    order = list(range(steps)) + [0]
    for i, step in enumerate(order):
        sync()
        t0 = time.perf_counter()
        b = pipeline.make_batch(cfg, 0, step)
        sync()
        t1 = time.perf_counter()
        if device.type == "cuda" and i == len(order) - 2:  # the last fresh step
            state, out, n_dup = profile(
                torch, f"dedup_batch of {batch} documents onto r = {i}", lambda: pipeline.dedup_batch(
                    cfg, state, b, 0, step), top=6, show=("fused_lookup_kernel", "block_sort_kernel",
                                                          "kway_merge_kernel"), phase=9)
        else:
            state, out, n_dup = pipeline.dedup_batch(cfg, state, b, 0, step)
        n_dup = int(n_dup)
        rates["make_s"] += t1 - t0
        rates["dedup_s"] += time.perf_counter() - t1
        # The batch's tokens equal the reference generator's (the CPU tests
        # pin make_batch); the oracle hashes them on the host.
        tokens, labels = b["tokens"].cpu().numpy(), b["labels"].cpu().numpy()
        exp_found = np.array([h in seen for h in host_doc_hash(tokens).tolist()])
        if exp_found.any():
            retry_t, retry_l = host_batch(seed, 0, step + (1 << 20), batch, seq_len, vocab)
            tokens = np.where(exp_found[:, None], retry_t, tokens)
            labels = np.where(exp_found[:, None], retry_l, labels)
        require(n_dup == int(exp_found.sum()), f"step {i}: {n_dup} duplicates, expected {int(exp_found.sum())}")
        require(np.array_equal(out["tokens"].cpu().numpy(), tokens) and
                np.array_equal(out["labels"].cpu().numpy(), labels), f"step {i}: tokens differ")
        for h in host_doc_hash(tokens).tolist():
            seen[h] = step % (1 << 30)
        total += n_dup
    require(n_dup == batch, f"the replayed batch reported {n_dup} of {batch} documents as duplicates")
    require(int(state.duplicates_seen) == total, f"duplicates_seen {int(state.duplicates_seen)} != {total}")
    hashes = np.fromiter(seen, np.int32, len(seen))
    q = torch.from_numpy(hashes).to(device)
    found, vals = queries.lsm_lookup(pipeline._dedup_cfg(cfg), state.dedup_index, q)
    require(bool(found.all()) and np.array_equal(vals.cpu().numpy(), np.array([seen[h] for h in hashes.tolist()])),
            "the index differs from the hashes seen")
    rng = np.random.default_rng(seed)
    other = rng.integers(0, MAX_USER_KEY, 4 * batch).astype(np.int32)
    other = other[~np.isin(other, hashes)]
    found, _ = queries.lsm_lookup(pipeline._dedup_cfg(cfg), state.dedup_index, torch.from_numpy(other).to(device))
    require(not bool(found.any()), "the index holds a hash never seen")
    n_docs = len(order) * batch
    step_s = rates["make_s"] + rates["dedup_s"]
    rates["docs_per_s"] = n_docs / step_s
    rates["tokens_per_s"] = n_docs * seq_len / step_s
    log(f"phase 9 dedup: {len(order)} steps of {batch} documents of {seq_len} tokens (the last replays step 0: "
        f"{n_dup} duplicates), {total} duplicates in all, index r = {state.dedup_index.r} of b = {batch}, "
        f"L = {levels}; make_batch {rates['make_s']:.3f} s, dedup_batch {rates['dedup_s']:.3f} s: "
        f"{rates['docs_per_s']:.1f} docs/s, {rates['tokens_per_s'] / 1e6:.3f} M tokens/s; equal to the host set of "
        f"{len(seen)} hashes")
    return rates


def log_rows(rows):
    def fmt(x):
        return "none" if x is None else f"{x:.4f}"

    for r in rows:
        log(f"phase 5 {r['name']}: {r['ms']:.4f} ms (bound {r['bound_ms']:.4f}, plain {r['plain_ms']:.4f}, "
            f"torch {fmt(r['library_ms'])}); " + "; ".join(
                f"{a['what']}: {fmt(a['ms'])} ms (device only {fmt(a.get('device_ms'))}, bound "
                f"{fmt(a.get('bound_ms'))}, plain {fmt(a.get('plain_ms'))}, torch {fmt(a.get('library_ms'))})"
                for a in r["also"]))


# ---------------------------------------------------------------------------


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args()

    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; the port's main path runs on the card", file=sys.stderr)
        return 1
    if not (ROOT / "src" / "repro_torch").is_dir():
        print("chip_smoke: src/repro_torch not found beside this script", file=sys.stderr)
        return 1
    sys.path.insert(0, str(ROOT / "src"))
    from repro_torch.kernels import _build, bitonic_sort, lsm_lookup, merge_path

    t_all = time.perf_counter()
    device = torch.device("cuda")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60).stdout.strip().splitlines()[0]
    card = f"{torch.cuda.get_device_name(0)}, power limit {smi.split(',')[-1].strip()}"
    log(smi)
    log(f"phase 1 device: {torch.cuda.get_device_name(0)}; torch {torch.__version__}, CUDA {torch.version.cuda}")

    kernels = {"merge_cascade": merge_path.CASCADE_KERNEL, "bound": lsm_lookup.BOUND_KERNEL,
               "fused_lookup": lsm_lookup.LOOKUP_KERNEL, "bitonic_sort": bitonic_sort.KERNEL,
               "merge_path": merge_path.PATH_KERNEL}
    t0 = time.perf_counter()
    _build.build_all(list(kernels.values()))
    log(f"phase 2 build: {len(kernels)} kernels, {time.perf_counter() - t0:.2f} s")
    for name, k in kernels.items():
        regs = [ln.strip() for ln in k.build_log.splitlines() if "registers" in ln or "spill" in ln]
        log(f"  {name}: {k.library.name} {regs}")
    occupancy = ctypes.CDLL(str(merge_path.CASCADE_KERNEL.library)).repro_merge_occupancy
    occupancy.argtypes, occupancy.restype = [ctypes.POINTER(ctypes.c_int)], ctypes.c_int
    per_sm = ctypes.c_int(0)
    require(occupancy(ctypes.byref(per_sm)) == 0, "occupancy query failed")
    log(f"  merge_cascade: {per_sm.value} blocks of the K-way merge per SM")

    rng = np.random.default_rng(args.seed)
    t0 = time.perf_counter()
    errs, cases = check_kernels(torch, device, rng)
    require(all(e == 0 for e in errs.values()), f"kernel differs from its plain version: {errs}")
    log(f"phase 3 kernels vs plain: {cases} cases, exact (max_abs_err {errs}), {time.perf_counter() - t0:.2f} s")

    def drive(phase, fn):
        """Run one path with every launch count set to 0 just before it;
        return its result and the counts read just after."""
        for k in kernels.values():
            k.launches = 0
        t0 = time.perf_counter()
        res = fn()
        counts = {name: k.launches for name, k in kernels.items()}
        log(f"phase {phase} main path: {time.perf_counter() - t0:.2f} s, launches {counts}")
        return res, counts

    (d, rates, q_lookup), launches4 = drive(4, lambda: drive_main_path(
        torch, device, args.seed, log2_n=27, b=1 << 16, lanes=1 << 20, n_lookups=1 << 20, n_windows=1 << 14, reps=5))
    staged_path = ("merge_cascade", "bound", "fused_lookup")
    require(all(launches4[k] > 0 for k in staged_path), f"a kernel did not run on phase 4's path: {launches4}")

    t0 = time.perf_counter()
    k1 = dev_tensor(torch, rng.integers(0, MAX_USER_KEY - 1022, 1 << 14).astype(np.int32), device)
    rows = kernel_rows(torch, d, q_lookup, k1, errs, launches4)
    from repro_torch.api import QueryPlan
    profile(torch, f"count of {k1.shape[0]} windows of 1024 keys",
            lambda: d.count(k1, k1 + 1023, QueryPlan(max_candidates=1024, max_results=512)), top=10,
            show=("bounds_runs_kernel", "radixSort"))
    profile(torch, f"lookup of {q_lookup.shape[0]} queries", lambda: d.lookup(q_lookup), top=10,
            show=("fused_lookup_kernel", "bucket_count_kernel", "bucket_scatter_kernel"))
    keys = dev_tensor(torch, rng.integers(0, MAX_USER_KEY + 1, 1 << 20).astype(np.int32), device)
    d = profile(torch, f"insert of {keys.shape[0]} lanes", lambda: d.insert(keys, keys % 1009))
    log(f"phase 5 kernel timing: {time.perf_counter() - t0:.2f} s")
    del d, q_lookup, keys
    torch.cuda.empty_cache()

    b, capacity = 1 << 16, 1 << 27
    (slice_rates, bulk_keys, bulk_vals, lsm_d, sa_d), launches6 = drive(6, lambda: drive_slice(
        torch, device, args.seed, log2_bulk=26, b=b, capacity=capacity, lsm_batches=1024, sa_calls=64,
        sa_batches=64, n_lookups=1 << 20, n_windows=1 << 14))
    require(launches6["bitonic_sort"] > 0 and launches6["merge_path"] > 0,
            f"the batch sort or the pairwise merge did not run on phase 6's path: {launches6}")
    launches = {name: launches4[name] + launches6[name] for name in kernels}
    require(all(v > 0 for v in launches.values()), f"a kernel did not run on the main paths: {launches}")
    for r in rows:
        r["launches"] = launches[r["name"]]
    t0 = time.perf_counter()
    profile_direct(torch, device, lsm_d, sa_d, b, 16, args.seed)
    sa_lookup_line(torch, device, sa_d, rows, errs, args.seed)
    del lsm_d, sa_d
    torch.cuda.empty_cache()
    rows += slice_kernel_rows(torch, device, bulk_keys, bulk_vals, b, capacity, errs, launches)
    log(f"phase 5 kernel timing of the batch sort and the pairwise merge: {time.perf_counter() - t0:.2f} s")

    torch.cuda.empty_cache()
    srv_rates, launches7 = drive(7, lambda: drive_server(
        torch, device, args.seed, b=b, capacity=capacity, log2_resident=26, fill_calls=64, tenants=4096,
        key_space=1 << 16, events=1 << 16, step_every=4096, n_sample=1 << 20, max_candidates=1024))
    require(all(launches7[k] > 0 for k in staged_path), f"a kernel did not run on phase 7's path: {launches7}")
    torch.cuda.empty_cache()
    ck_rates, _ = drive(8, lambda: drive_cuckoo(torch, device, args.seed, bulk_keys, bulk_vals, n_lookups=1 << 20,
                                                reps=5))
    del bulk_keys, bulk_vals
    torch.cuda.empty_cache()
    dedup_rates, launches9 = drive(9, lambda: drive_dedup(
        torch, device, args.seed, vocab=32000, seq_len=2048, batch=4096, levels=16, steps=16))
    require(all(launches9[k] > 0 for k in ("bitonic_sort", "merge_cascade", "fused_lookup")),
            f"a kernel did not run on phase 9's path: {launches9}")

    log(f"rates ({card}): insert {rates['insert_M_elem_per_s']:.3f} M elem/s, "
        f"lookup {rates['lookup_M_q_per_s']:.3f} M q/s, count {rates['count_M_q_per_s']:.4f} M q/s, "
        f"range {rates['range_M_q_per_s']:.4f} M q/s, cleanup {rates['cleanup_s'] * 1e3:.1f} ms, "
        f"maintain(7b) {rates['maintain_s'] * 1e3:.1f} ms, size {rates['size_s'] * 1e3:.1f} ms")
    r = slice_rates
    log(f"phase 6 rates ({card}): bulk build LSM {r['lsm_bulk_build_M_elem_per_s']:.3f} / SA "
        f"{r['sa_bulk_build_M_elem_per_s']:.3f} M elem/s; direct update LSM {r['lsm_update_M_elem_per_s']:.3f} / "
        f"SA {r['sa_update_M_elem_per_s']:.3f} M elem/s, ratio "
        f"{r['lsm_update_M_elem_per_s'] / r['sa_update_M_elem_per_s']:.3f} (paper, K40c: 13.5 at 2^27); "
        f"SA facade calls {r['sa_facade_M_elem_per_s']:.3f} M elem/s")
    log(f"phase 7-9 rates ({card}): server replay {srv_rates['replay_ops_per_s']:.1f} ops/s, "
        f"{srv_rates['replay_lanes_per_s']:.1f} lanes/s, fill {srv_rates['fill_M_elem_per_s']:.3f} M elem/s; "
        f"cuckoo build {ck_rates['build_M_elem_per_s']:.3f} M elem/s in {ck_rates['rounds']} rounds (n = "
        f"{ck_rates['n']}), lookup present {ck_rates['lookup_present_M_q_per_s']:.2f} / absent "
        f"{ck_rates['lookup_absent_M_q_per_s']:.2f} M q/s; dedup {dedup_rates['docs_per_s']:.1f} docs/s, "
        f"{dedup_rates['tokens_per_s'] / 1e6:.3f} M tokens/s")
    log(f"peak device memory {torch.cuda.max_memory_allocated() / 2**30:.2f} GiB; total {time.perf_counter() - t_all:.1f} s")
    log(smi)
    log(json.dumps({"kernels": rows}))
    log(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                           "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
