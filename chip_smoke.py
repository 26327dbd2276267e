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
     threshold and with tombstone hits; for count/range stages 2-5: 13
     LSM-shaped runs, windows cut inside a run, rows that overflow, and
     buffers in shared memory and in the scratch array);
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
     slots, on phase 6's data; count/range stages 2-5 in one launch at the
     scan cell's shape, 13 runs of the b = 2^16 arena at r = 2046 and 2^14
     windows, COUNT and RANGE, beside the plain tile pipeline; the
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
     host set of the hashes seen;
 10. the range-partitioned sharded LSM (`lsm_sharded`), four shards all on
     this one card, run one after another: (a) b = 2^16 and capacity 2^27
     per shard (L = 12), bulk-built from phase 6's 2^26 keys, then 256
     facade updates of 2^18 lanes in phase 6's mix and a flush, 2^20
     lookups, 2^14 count and range windows of 2^10 keys (1024 straddling
     each shard boundary), maintain, cleanup and size, every result held
     against an oracle on the card; (b) phase 7's server protocol over the
     sharded dictionary, its resident keys spread over three shards and its
     tenants over the last two. The launch counts of the four LSM kernels
     on this path must be positive;
 11. the LM stack's serving entry point, `python -m repro_torch.launch.serve
     --arch qwen2-7b` at full width (28 layers, d_model 3584, vocab 152064;
     random bf16 parameters from a seeded generator on the card): 16
     requests in waves of 8, prompts of 512 tokens, 32 greedy decode steps,
     pages of 16 tokens admitted, counted and evicted through the
     DictionaryServer's LSM (the launch counts of `merge_cascade`, `bound`
     and `fused_lookup` must be positive); pages/seq, free slots and the
     emptied index held exactly; wave 0 again as prefill(S-1) + one decode
     step against the parallel forward, in the served bf16 (printed) and in
     fp32 with the same parameters (relative L2 <= 1e-4); one decode step
     profiled; every family's smoke config on the card against the CPU
     (fp32, TF32 off). Prints prefill and decode rates beside the decode's
     bandwidth bound (the parameter bytes read once a step);
 12. the LM stack's training entry point, `python -m repro_torch.launch.train
     --arch stablelm-1.6b --batch 8 --seq 2048 --steps 20` at full width (24
     layers, d_model 2048, vocab 100352; random bf16 parameters from a
     seeded generator on the card, fp32 AdamW moments, remat "full", the
     dedup pipeline's LSM on the card, no checkpoint written): every loss and
     grad norm finite, the last loss below the first, the launch counts of
     `fused_lookup`, `bitonic_sort` and `merge_cascade` positive; one more
     step profiled (idle share, top kernels, the AdamW range's share) and the
     AdamW pass alone beside its bound; every family's smoke config, one
     train step on the card against the CPU (fp32, TF32 off); the
     supervisor on the card under deterministic algorithms (in a child
     process, which sets CUBLAS_WORKSPACE_CONFIG), a failure
     before the first save and one after a save each ending bit for bit
     equal to an unbroken run. Prints the step time beside its FLOP bound
     (`model_flops` over 989 TFLOP/s), tokens/s, MFU and peak memory;
 13. the LM stack's multi-device layer: (a) `python -m
     repro_torch.launch.dryrun --all` in-process, the sharding plan of every
     (arch x shape) cell on both production meshes (16x16, 2x16x16) on the
     meta device, 0 failures, each arch's train_4k per-device bytes of
     parameters, gradients and moments (a CPU computation); (b) int8
     gradient compression with error feedback (`compressed_tree_psum`) of 4
     ranks of StableLM-2-1.6B's gradients at full width (bf16, random from a
     seeded generator), all on this card one after another: one call timed
     beside its byte bound, held bit for bit against the CPU on a sample of
     leaves (the largest among them), one call profiled (idle share), peak
     memory, and 64 calls on a constant fp32 gradient averaging to it; (c)
     in phase 12's child process, the training driver's --resume through
     restore(shardings=plan) onto the card, bit for bit equal to an
     unbroken run;
 14. the four examples as a user runs them, each in this process with its
     standard output captured, at the reference examples' own sizes:
     `examples/torch_quickstart.py`, `torch_streaming_updates.py`,
     `torch_dictionary_serving.py` (the paged decode, `--server`, and
     `--sharded --shards 4 --device cuda:0`), each on the card and then with
     `--device cpu`, every line on the card equal to its line on the CPU
     (but the repr's device field and the streaming rate line);
     `torch_train_lm.py` as written (the smoke config, 200 steps) and
     `--no-smoke --arch stablelm-1.6b --batch 8 --seq 2048 --steps 12
     --log-every 1` (full width), both passing the example's own assert that
     the loss fell. The launch counts, set to 0 before each card run, must
     be positive for the kernels on its path, and for all five over the
     phase; each run's wall, the full-width step time and peak memory are
     printed.
The last line is {"ok": true, "device": {...}}. Any failure exits non-zero
before it. Without a CUDA device, or without the repository's src/ beside
it, the script exits non-zero and prints no result.
"""

from __future__ import annotations

import argparse
import contextlib
import ctypes
import gc
import io
import json
import math
import os
import re
import runpy
import shutil
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

    errs = {"merge_cascade": 0, "bound": 0, "fused_lookup": 0, "bitonic_sort": 0, "merge_path": 0,
            "window_select": 0}
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

    cases += check_window_select(torch, device, gen, errs)
    return errs, cases


def check_window_select(torch, device, gen, errs, base=1 << 10, nq=1 << 14):
    """Count/range stages 2-5 against the plain version: 13 LSM-shaped runs
    (a buffer of `base` slots and 12 levels) over few keys (duplicates within
    and across runs, every fourth level all placebos) and over the whole key
    range, `nq` windows with k1 > k2 and the edge keys; plans that cut
    windows inside a run and overflow rows, the main path's, and ones whose
    buffers take the scratch array. Returns the cases run."""
    from repro_torch.kernels import lsm_lookup, window_select

    cases = 0
    for key_hi in (1 << 12, MAX_USER_KEY + 1):
        runs = [device_run(torch, gen, n, key_hi, device, placebo_frac=1.0 if s % 4 == 3 else 0.25)
                for s, n in enumerate([base] + [base << i for i in range(12)])]
        k1 = lookup_queries(torch, gen, [kv for kv, _ in runs], key_hi, nq, device)
        k2 = (k1.long() + torch.randint(-8, 1 << 12, k1.shape, generator=gen, device=device)).clamp(
            -INT32_MAX - 1, INT32_MAX).to(torch.int32)
        lows, highs = lsm_lookup.bounds_runs([kv for kv, _ in runs], k1, k2)
        for m, r in ((1024, 512), (100, 16), (777, 1000), (5000, 300)):
            got = window_select.range_windows(runs, lows, highs, m, r)
            exp = window_select.range_plain(runs, lows, highs, m, r)
            got_c = window_select.count_windows(runs, lows, highs, m)
            exp_c = window_select.count_plain(runs, lows, highs, m)
            torch.cuda.synchronize()
            errs["window_select"] = max(errs["window_select"], max_err(torch, got + got_c, exp + exp_c))
            cases += 2
    return cases


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


def window_select_row(torch, device, rng, errs, launches, b=1 << 16, nq=1 << 14):
    """The count/range kernel at the scan cell's shape: the b = 2^16 arena at
    r = 2046 (a full write buffer and levels 1-10 of uniform keys, 30%
    tombstones; levels 0 and 11 all placebos: 13 runs, 2^28 slots, ~2^27
    resident), 2^14 windows of 1024 keys, M = 1024, R = 512. COUNT and RANGE
    from stage 1's bounds, each held against its plain version, then timed
    back to back and device only, beside the plain version and its bound:
    the bounds (8 bytes a run and window) and each candidate's key read, the
    counts and ok flags written; for RANGE also each row written and the
    value of each survivor in it read."""
    from repro_torch.kernels import lsm_lookup, window_select

    r_batches, m, r = 2046, 1024, 512
    gen = torch.Generator(device=device)
    gen.manual_seed(int(rng.integers(1 << 31)))
    runs = [device_run(torch, gen, b, MAX_USER_KEY + 1, device, placebo_frac=0)]
    runs += [device_run(torch, gen, b << i, MAX_USER_KEY + 1, device, placebo_frac=0 if r_batches >> i & 1 else 1.0)
             for i in range(12)]
    flat = (torch.cat([kv for kv, _ in runs]), torch.cat([v for _, v in runs]))
    k1 = torch.randint(0, MAX_USER_KEY - 1022, (nq,), generator=gen, device=device, dtype=torch.int32)
    lows, highs = lsm_lookup.bounds_runs([kv for kv, _ in runs], k1, k1 + 1023)
    cands = int((highs - lows).clamp(min=0).sum(0).clamp(max=m).sum())
    calls = {"count": (lambda: window_select.count_windows(runs, lows, highs, m),
                       lambda: window_select.count_plain(runs, lows, highs, m, flat)),
             "range": (lambda: window_select.range_windows(runs, lows, highs, m, r),
                       lambda: window_select.range_plain(runs, lows, highs, m, r, flat))}
    out = {}
    for name, (kernel, plain) in calls.items():
        got, exp = kernel(), plain()
        errs["window_select"] = max(errs["window_select"], max_err(torch, got, exp))
        require(errs["window_select"] == 0, f"window_select {name} differs from its plain version")
        nbytes = 8 * len(runs) * nq + 4 * cands + 5 * nq
        if name == "range":
            nbytes += 8 * r * nq + 4 * int(exp[2].clamp(max=r).sum())
        out[name] = dict(what=f"{name}, {len(runs)} runs, {nq} windows, M = {m}" + (f", R = {r}" if name == "range"
                                                                                    else ""),
                         ms=time_ms(torch, kernel, iters=20), device_ms=graph_ms(torch, kernel),
                         plain_ms=time_ms(torch, plain, iters=3), bound_ms=bound(nbytes, 0)[0], bytes=nbytes,
                         survivors=int(exp[0 if name == "count" else 2].sum()), ok=bool(exp[-1].all()))
    log(f"  window_select: {cands} candidates in {nq} windows ({cands / nq:.2f} a window), "
        f"{out['count']['survivors']} survivors")
    c = out["count"]
    row = dict(name="window_select", route="cuda", source="src/repro_torch/csrc/window_select.cu",
               replaces="none (src/repro/core/queries.py:80-143, jnp and lax.sort)",
               launches=launches.get("window_select", 0), max_abs_err=errs["window_select"], ms=c["ms"],
               plain_ms=c["plain_ms"], bound_ms=c["bound_ms"], bound_by="bytes", library_ms=None,
               also=[dict(what=c["what"] + ": device only", ms=None, device_ms=c["device_ms"]), out["range"]])
    log_rows([row])
    return row


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


def profile(torch, what, fn, top=5, show=(), ranges=(), phase=5, out=None):
    """`fn()` under torch.profiler: wall time, device busy time (the sum of
    kernel times on the one stream), the `top` kernels, the time and busy
    share of the kernels named in `show` and of the kernels launched inside
    each `record_function` range named in `ranges`. Returns fn's result; the
    idle share, wall and busy ms and each range's ms go into `out` when it is
    given."""
    from torch.profiler import ProfilerActivity, profile as torch_profile

    with torch_profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        res = fn()
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6
    kernels = [e for e in prof.key_averages()
               if e.device_type.name == "CUDA" and not getattr(e, "is_user_annotation", False)]
    busy_us = sum(e.self_device_time_total for e in kernels)
    ranked = sorted(kernels, key=lambda e: -e.self_device_time_total)[:top]
    log(f"phase {phase} profile: {what}, wall {wall_us / 1e3:.2f} ms, device busy "
        f"{busy_us / 1e3:.2f} ms, idle share {1 - busy_us / wall_us:.3f}; top kernels: "
        + "; ".join(f"{e.key[:60]} {e.self_device_time_total / 1e3:.3f} ms x{e.count}" for e in ranked))
    for name in show:
        us = sum(e.self_device_time_total for e in kernels if name in e.key)
        log(f"  {name}: {us / 1e3:.4f} ms, {us / busy_us:.4f} of device busy")
    for name in ranges:
        host = [e for e in prof.key_averages() if e.key == name and e.device_type.name == "CPU"]
        us = host[0].device_time_total if host else float("nan")
        log(f"  range {name}: {us / 1e3:.4f} ms of kernels, {us / busy_us:.4f} of device busy")
        if out is not None:
            out[f"{name}_ms"] = us / 1e3
    if out is not None:
        out.update(idle_share=1 - busy_us / wall_us, wall_ms=wall_us / 1e3, busy_ms=busy_us / 1e3)
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


def mixed_batches(torch, gen, bulk_keys, count, width, first_value):
    """`count` batches of `width` lanes: 30% new keys, 30% re-writes and 15%
    deletes of bulk keys, and 25% in-batch duplicates of a key up to 16 lanes
    earlier (half of them deletes). Values are distinct and positive.
    Returns (keys, vals, dels) as [count, width] and the duplicate count."""
    device = bulk_keys.device

    def randint(hi, size):
        return torch.randint(0, hi, (size,), generator=gen, device=device, dtype=torch.int32)

    total = count * width
    kind = torch.rand(total, generator=gen, device=device)
    keys = torch.where(kind < 0.3, randint(MAX_USER_KEY + 1, total), bulk_keys[randint(bulk_keys.numel(), total).long()])
    dels = (kind >= 0.6) & (kind < 0.75)
    back = 1 + randint(16, total).long()
    lanes = torch.arange(total, device=device)
    dup = (kind >= 0.75) & (lanes % width >= back)
    src = torch.where(dup, lanes - back, lanes)
    keys = keys[src]
    dels = torch.where(dup, torch.rand(total, generator=gen, device=device) < 0.5, dels)
    vals = first_value + lanes.to(torch.int32)
    return keys.view(count, width), vals.view(count, width), dels.view(count, width), int(dup.sum())


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
    keys, vals, dels, n_dup = mixed_batches(torch, gen, bulk_keys, lsm_batches, b, 1)
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
    f_keys, f_vals, f_dels, f_dup = mixed_batches(torch, gen, bulk_keys, sa_calls, b, 1 << 28)
    kind = torch.arange(sa_calls, device=device) % 3  # insert, delete, mixed update
    f_dels = torch.where((kind == 1)[:, None], True, torch.where((kind == 0)[:, None], False, f_dels))
    e_keys, e_vals, e_dels, e_dup = mixed_batches(torch, gen, bulk_keys, sa_batches, b, 1 << 29)
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


def describe(d):
    """r and L of a handle's LSM state, per shard for a sharded one."""
    st = d.state
    if isinstance(st, tuple):
        return f"r = {[s.r for s in st]} on {len(st)} shards, L = {st[0].num_levels}"
    return f"r = {st.r}, L = {st.num_levels}"


def drive_server(torch, device, seed, *, b, capacity, log2_resident, fill_calls, tenants, key_space, events,
                 step_every, n_sample, max_candidates, backend="lsm", num_shards=None, resident_stride=1, phase=7):
    """The DictionaryServer on the card: a `resident` tenant filled with
    2^log2_resident unique keys (`resident_stride` apart) in `fill_calls`
    updates (a step after each), then `tenants` tenants replaying a `mixed`
    trace of `events` events through `replay_server`, one more profiled step
    of a second trace, and a cleanup; every ticket and the end state before
    and after the cleanup held against per-tenant oracles. Returns a rates
    dict."""
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
    srv = DictionaryServer(ServerConfig(backend=backend, num_shards=num_shards, batch_size=b, capacity=capacity,
                                        device=device, default_plan=QueryPlan(max_candidates=max_candidates)))
    n_res = 1 << log2_resident
    srv.register_tenant("resident", key_space=2 * n_res * resident_stride)
    res_keys = (torch.randperm(2 * n_res, generator=gen, device=device)[:n_res] * resident_stride).to(
        torch.int32).cpu().numpy()
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
    if num_shards is None:  # the host model is exact for one shard
        require(srv.pending_estimate() == srv.dictionary.pending(), "pending model differs from the buffer")
    log(f"phase {phase} fill: {n_res} unique keys of tenant 'resident' in {fill_calls} updates of {lanes} lanes, "
        f"{rates['fill_s']:.3f} s, {rates['fill_M_elem_per_s']:.3f} M elem/s; {describe(srv.dictionary)}, "
        f"flushes {srv.stats.flushes}")

    t0 = time.perf_counter()
    names, trace = make_trace("mixed", num_tenants=tenants, key_space=key_space, events=events, seed=seed,
                              window=32)
    _, more = make_trace("mixed", num_tenants=tenants, key_space=key_space, events=step_every, seed=seed + 1,
                         window=32)
    more = more[:step_every]
    for name in names:
        srv.register_tenant(name, key_space=key_space)
    log(f"phase {phase} traffic: {len(trace)} ops of {tenants} tenants ({events} events), made in "
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
    log(f"phase {phase} replay: {len(trace)} ops, {n_lanes} lanes, step every {step_every} ops, {rates['replay_s']:.3f} s: "
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
                                                    "radixSort"), phase=phase, out=rates)
    else:
        srv.step()
    results_more = [t.result() for t in tickets]
    log(f"phase {phase} stats: {json.dumps(srv.stats.as_dict())}")

    t0 = time.perf_counter()
    oracles = {}
    touched = check_tickets(trace + more, results + results_more, oracles)
    sample = res_keys[torch.randint(0, n_res, (n_sample,), generator=gen, device=device).cpu().numpy()]
    check_end_state(srv, oracles, touched, sample, "before cleanup")
    log(f"phase {phase} check: {len(trace) + len(more)} tickets and the end state of {len(touched)} tenants and "
        f"{n_sample} resident keys equal to the oracles, {time.perf_counter() - t0:.2f} s")
    sync()
    t0 = time.perf_counter()
    srv.cleanup()
    sync()
    rates["cleanup_s"] = time.perf_counter() - t0
    check_end_state(srv, oracles, touched, sample, "after cleanup")
    require(not srv.dictionary.overflowed(), "overflow latched")
    log(f"phase {phase} cleanup: {rates['cleanup_s']:.4f} s, {describe(srv.dictionary)}; the end state still "
        f"equals the oracles")
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


# ---------------------------------------------------------------------------
# phase 10: the sharded LSM, its shards one after another on one card
# ---------------------------------------------------------------------------


def drive_sharded(torch, device, seed, bulk_keys, bulk_vals, *, shards, b, capacity, calls, lanes, n_lookups,
                  n_windows, reps):
    """The `lsm_sharded` facade with every shard on `device`: a bulk build
    from `bulk_keys`, `calls` facade updates of `lanes` lanes in phase 6's
    mix, a flush, lookups (half of them live keys), count and range windows
    of 1024 keys (1024 straddling each shard boundary, the rest anywhere),
    maintain, cleanup and size; every answer held against an oracle built on
    the device. Returns a rates dict."""
    from repro_torch.api import Dictionary, QueryPlan
    from repro_torch.core import distributed as dist

    def sync():
        if device.type == "cuda":
            torch.cuda.synchronize()

    gen = torch.Generator(device=device)
    gen.manual_seed(seed + 5)

    def randint(hi, size):
        return torch.randint(0, hi, (size,), generator=gen, device=device, dtype=torch.int32)

    rates = {}
    t0 = time.perf_counter()
    n = bulk_keys.numel()
    keys, vals, dels, n_dup = mixed_batches(torch, gen, bulk_keys, calls, lanes, 1)
    prio, status, bits = recency_prio(torch, dels)  # the bulk build is older than every call
    live, live_vals = oracle_live(
        torch, torch.cat([keys.reshape(-1), bulk_keys]), torch.cat([prio, torch.full((n,), 1 << bits, device=device)]),
        torch.cat([status, torch.ones(n, dtype=torch.long, device=device)]), torch.cat([vals.reshape(-1), bulk_vals]),
        bits + 1)
    d = Dictionary.create("lsm_sharded", num_shards=shards, batch_size=b, capacity=capacity, device=device)
    cfg = d._backend.cfg
    require(d.num_shards == shards and d.devices == (device,) and cfg.local.num_levels == (capacity // b).bit_length()
            and all(st.arena_kv.numel() == b << cfg.local.num_levels for st in d.state), "unexpected sharded shape")
    sync()
    log(f"phase 10 set-up: {shards} shards of b = {b}, L = {cfg.local.num_levels} ({cfg.local.capacity} slots each), "
        f"all on {device}; {n} bulk keys, {calls} update calls of {lanes} lanes ({n_dup} in-call duplicates), "
        f"oracle of {live.numel()} live keys, {time.perf_counter() - t0:.2f} s")

    sync()
    t1 = time.perf_counter()
    d = d.bulk_build(bulk_keys, bulk_vals)
    sync()
    rates["bulk_build_M_elem_per_s"] = n / (time.perf_counter() - t1) / 1e6
    owned = torch.bincount(dist.owner_of(cfg, bulk_keys).long(), minlength=shards).tolist()
    r = [st.r for st in d.state]
    require(r == [-(-o // b) for o in owned], f"bulk build left r = {r} for {owned} owned keys")
    log(f"phase 10 bulk build: {rates['bulk_build_M_elem_per_s']:.3f} M elem/s; owned {owned}, r = {r}")

    t1 = time.perf_counter()
    for c in range(calls - 1):
        d = d.update(keys[c], vals[c], is_delete=dels[c])
    sync()
    dt = time.perf_counter() - t1
    rates["update_M_elem_per_s"] = (calls - 1) * lanes / dt / 1e6
    last = (keys[-1], vals[-1], dels[-1])
    what = f"one facade update of {lanes} lanes over {shards} shards"
    if device.type == "cuda":
        d = profile(torch, what, lambda: d.update(last[0], last[1], is_delete=last[2]), top=6,
                    show=("kway_merge_kernel", "radixSort"), phase=10, out=rates)
        rates["update_idle_share"] = rates.pop("idle_share")
    else:
        d = d.update(last[0], last[1], is_delete=last[2])
    d = d.flush()
    sync()
    require(d.pending() == 0 and not d.overflowed(), "pending or overflow after the flush")
    log(f"phase 10 update: {calls - 1} facade calls of {lanes} lanes {dt:.3f} s, "
        f"{rates['update_M_elem_per_s']:.3f} M elem/s (the last call profiled apart), flush; {describe(d)}")
    del keys, vals, dels, prio, status, last

    rs = cfg.range_size
    q = torch.cat([live[randint(live.numel(), n_lookups // 2).long()], randint(MAX_USER_KEY + 1, n_lookups - n_lookups // 2)])
    straddle = torch.cat([s * rs - 1 - randint(1023, 1024) for s in range(1, shards)])
    k1 = torch.cat([straddle, randint(MAX_USER_KEY - 1022, n_windows - straddle.numel())])
    k2 = k1 + 1023
    plan = QueryPlan(max_candidates=1024, max_results=512)
    lookup, count, range_ = query_checks(torch, live, live_vals, q, k1, k2, plan.max_results)
    for name, call, check, nq in (("lookup", lambda: d.lookup(q), lookup, n_lookups),
                                  ("count", lambda: d.count(k1, k2, plan), count, n_windows),
                                  ("range", lambda: d.range(k1, k2, plan), range_, n_windows)):
        check(call(), f"sharded {name}")
        sync()
        t1 = time.perf_counter()
        results = [call() for _ in range(reps)]
        sync()
        dt = time.perf_counter() - t1
        for res in results:
            check(res, f"sharded {name}")
        rates[f"{name}_M_q_per_s"] = reps * nq / dt / 1e6
        log(f"phase 10 {name}: {reps} calls of {nq} {'queries' if name == 'lookup' else 'windows of 1024 keys'} "
            f"after a warm-up, {dt:.4f} s, {rates[f'{name}_M_q_per_s']:.3f} M q/s; equal to the oracle")
        del results
    if device.type == "cuda":
        lookup(profile(torch, f"one lookup of {n_lookups} queries over {shards} shards", lambda: d.lookup(q), top=6,
                       show=("fused_lookup_kernel",), phase=10, out=rates), "profiled sharded lookup")
        rates["lookup_idle_share"] = rates.pop("idle_share")

    for name, step in (("maintain", lambda h: h.maintain(7 * b)), ("cleanup", lambda h: h.cleanup())):
        sync()
        t1 = time.perf_counter()
        d = step(d)
        sync()
        rates[f"{name}_s"] = time.perf_counter() - t1
        lookup(d.lookup(q), f"sharded lookup after {name}")
        count(d.count(k1, k2, plan), f"sharded count after {name}")
        log(f"phase 10 {name}{' (budget 7b per shard)' if name == 'maintain' else ''}: {rates[f'{name}_s']:.4f} s, "
            f"{describe(d)}; lookup and count still equal the oracle")
    range_(d.range(k1, k2, plan), "sharded range after cleanup")
    t1 = time.perf_counter()
    size = int(d.size())
    rates["size_s"] = time.perf_counter() - t1
    require(size == live.numel(), f"sharded size {size} != oracle {live.numel()}")
    require(not d.overflowed(), "sharded overflow latched")
    log(f"phase 10 size: {size} live, {rates['size_s']:.4f} s; every result equals the oracle")
    return rates


# ---------------------------------------------------------------------------
# phase 11: LM serving at full width over the LSM page index
# ---------------------------------------------------------------------------


def rel_l2(torch, got, exp) -> float:
    got, exp = got.float(), exp.float()
    return (torch.linalg.vector_norm(got - exp) / torch.linalg.vector_norm(exp)).item()


def drive_lm(torch, device, *, arch, requests, batch, prompt_len, gen_tokens, page_size, smoke=False):
    """`python -m repro_torch.launch.serve` as a user runs it, on the card:
    random bf16 parameters from a seeded generator on the card, prompts from
    numpy's generator seeded 0, the page table as a tenant of the
    DictionaryServer. Holds the page table's results exactly."""
    from repro_torch.launch import serve

    argv = ["--arch", arch, "--requests", str(requests), "--batch", str(batch), "--prompt-len", str(prompt_len),
            "--gen-tokens", str(gen_tokens), "--page-size", str(page_size), "--device", str(device)] + (
                ["--smoke"] if smoke else [])
    log(f"phase 11 serve: python -m repro_torch.launch.serve {' '.join(argv)}")
    t0 = time.perf_counter()
    out = serve.main(argv)
    out["main_s"] = time.perf_counter() - t0
    n_pages = max(1, prompt_len // page_size)
    require(len(out["waves"]) == -(-requests // batch), f"{len(out['waves'])} waves served")
    for i, w in enumerate(out["waves"]):
        require(w["pages_per_seq"] == [n_pages] * batch, f"wave {i}: pages/seq {w['pages_per_seq']}, not {n_pages}")
        require(w["free"] == 1024 - n_pages * batch, f"wave {i}: {w['free']} free, not {1024 - n_pages * batch}")
    require(out["live_pages"] == 0 and out["r"] == 0,
            f"after evict, drain and cleanup the index holds {out['live_pages']} live pages (r = {out['r']})")
    require(out["tokens"] == requests * gen_tokens, f"{out['tokens']} tokens decoded")
    return out


def decode_vs_parallel(torch, cfg, model, tok):
    """prefill(S-1) + one decode step against the parallel forward at
    positions S-2 and S-1 (tests/test_models_smoke.py's check at full
    width): relative L2 of each, every logit finite."""
    from repro_torch.models import model_zoo as zoo

    s = tok.shape[1]
    with torch.inference_mode():
        logits_all, _ = zoo.apply_train(cfg, model, {"tokens": tok})
        pre, caches = zoo.apply_prefill(cfg, model, {"tokens": tok[:, :s - 1]}, cache_pad_to=s + 1)
        dec, caches = zoo.apply_decode(cfg, model, tok[:, s - 1:], caches, s - 1)
        for name, x in (("train", logits_all), ("prefill", pre), ("decode", dec)):
            require(bool(torch.isfinite(x).all()), f"non-finite {name} logits")
        errs = rel_l2(torch, pre, logits_all[:, s - 2]), rel_l2(torch, dec, logits_all[:, s - 1])
    return errs, dec, caches


def check_lm(torch, out, rates):
    """Wave 0 again through the served bf16 model: decode against the
    parallel forward (printed: bf16 rounding through 28 random layers sets
    its size), one more decode step under the profiler; then the same check
    on the same parameters in fp32 with TF32 off, held to relative L2 <= 1e-4
    (the model's arithmetic, without bf16's rounding)."""
    from repro_torch.models import model_zoo as zoo

    cfg, model = out["cfg"], out.pop("model")
    tok = torch.as_tensor(out["prompts"][0], device=model.embed.device)
    s = tok.shape[1]
    errs, dec, caches = decode_vs_parallel(torch, cfg, model, tok)
    rates["bf16_rel_l2"] = errs
    nxt = torch.argmax(dec, dim=-1)[:, None]
    with torch.inference_mode():
        profile(torch, f"one decode step of {tok.shape[0]} sequences at position {s}",
                lambda: zoo.apply_decode(cfg, model, nxt, caches, s), top=6, phase=11, out=rates)
    del model, dec, caches
    torch.cuda.empty_cache()
    saved = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        fp32 = zoo.init_params(cfg, device=tok.device, dtype=torch.float32)  # the served model's seed
        rates["fp32_rel_l2"], _, _ = decode_vs_parallel(torch, cfg, fp32, tok)
        del fp32
    finally:
        torch.backends.cuda.matmul.allow_tf32 = saved
    torch.cuda.empty_cache()
    (b_pre, b_dec), (f_pre, f_dec) = rates["bf16_rel_l2"], rates["fp32_rel_l2"]
    log(f"phase 11 decode vs parallel forward (wave 0, {tok.shape[0]} sequences of {s}), relative L2 of "
        f"prefill(S-1) / decode at S-1: bf16 (the served model) {b_pre:.4e} / {b_dec:.4e}; fp32, TF32 off "
        f"{f_pre:.4e} / {f_dec:.4e} (<= 1e-4)")
    require(f_pre <= 1e-4 and f_dec <= 1e-4, f"fp32 prefill / decode against the parallel forward: relative L2 "
            f"{f_pre:.3e} / {f_dec:.3e} > 1e-4")


def check_families(torch, device, seed):
    """Every family's smoke config on the card against the same parameters
    on the CPU, in fp32 with TF32 off: train forward, prefill (logits and
    caches) and one decode step, the reference smoke test's protocol.
    Tolerance |card - cpu| <= 1e-4 + 1e-3 |cpu|: the two devices sum matrix
    products in other orders and their exp/tanh differ in the last bits.
    seamless' audio encoder runs in bf16 whatever the weights (frames enter
    in bf16), so it is held at the bf16 tolerance 2e-2 + 2e-2 |cpu|."""
    import copy

    from repro_torch.configs.base import ARCH_IDS, get_smoke_config
    from repro_torch.models import model_zoo as zoo

    def leaves(tree):
        if isinstance(tree, dict):
            for v in tree.values():
                yield from leaves(v)
        elif isinstance(tree, list):
            for v in tree:
                yield from leaves(v)
        else:
            yield tree

    saved = torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = False
    errs = {}
    try:
        for arch in ARCH_IDS:
            cfg = get_smoke_config(arch)
            cpu_model = zoo.init_params(cfg, seed=seed, device="cpu", dtype=torch.float32)
            models = {"cpu": cpu_model, "card": copy.deepcopy(cpu_model).to(device)}
            rng = np.random.default_rng(seed)
            n_prefix = cfg.num_patches if cfg.has_vision_stub else 0
            st = 32 - n_prefix
            batch = {"tokens": rng.integers(0, cfg.vocab_size, (2, st))}
            if cfg.has_vision_stub:
                batch["patch_embeds"] = rng.normal(size=(2, cfg.num_patches, cfg.d_model)).astype(np.float32)
            if cfg.is_encoder_decoder:
                batch["frames"] = rng.normal(size=(2, 16, cfg.d_model)).astype(np.float32)
            res = {}
            for where, model in models.items():
                dev = model.embed.device
                b = {k: torch.as_tensor(v, device=dev) for k, v in batch.items()}
                with torch.inference_mode():
                    logits, aux = zoo.apply_train(cfg, model, b)
                    pre, caches = zoo.apply_prefill(cfg, model, dict(b, tokens=b["tokens"][:, :st - 1]),
                                                    cache_pad_to=st + n_prefix)
                    dec, _ = zoo.apply_decode(cfg, model, b["tokens"][:, st - 1:], caches, st - 1 + n_prefix)
                res[where] = [logits, aux, pre, dec, *leaves(caches)]
            rtol, atol = (2e-2, 2e-2) if cfg.is_encoder_decoder else (1e-3, 1e-4)
            err = 0.0
            for got, exp in zip(res["card"], res["cpu"]):
                got = got.cpu().float()
                require(bool(torch.isfinite(got).all()), f"{arch}: non-finite output on the card")
                require(torch.allclose(got, exp.float(), rtol=rtol, atol=atol), f"{arch}: card differs from the CPU")
                err = max(err, (got - exp.float()).abs().max().item())
            errs[arch] = err
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = saved
    log(f"phase 11 families: {len(errs)} smoke configs on the card against the CPU (fp32, TF32 off; train, "
        f"prefill with every cache leaf, decode), max abs err {json.dumps({k: float(f'{v:.3e}') for k, v in errs.items()})}")
    return errs


# ---------------------------------------------------------------------------
# phase 12: LM training at full width with the LSM dedup pipeline
# ---------------------------------------------------------------------------

# H100 SXM dense bf16 tensor-core peak (NVIDIA's datasheet, without sparsity).
BF16_FLOPS_PER_S = 989e12


def drive_train(torch, device, *, arch, steps, batch, seq, ckpt_dir, smoke=False):
    """`python -m repro_torch.launch.train` as a user runs it, on the card:
    random bf16 parameters from a generator seeded 0 on the card, the dedup
    index on the card, remat "full", no checkpoint written (--save-every
    above --steps). Every logged loss and grad norm finite, the last loss
    below the first (examples/train_lm.py's check)."""
    from repro_torch.launch import train

    argv = ["--arch", arch, "--steps", str(steps), "--batch", str(batch), "--seq", str(seq), "--log-every", "1",
            "--save-every", str(steps + 1), "--ckpt-dir", str(ckpt_dir), "--device", str(device)] + (
                ["--smoke"] if smoke else [])
    log(f"phase 12 train: python -m repro_torch.launch.train {' '.join(argv)}")
    t0 = time.perf_counter()
    out = train.run(argv)
    out["main_s"] = time.perf_counter() - t0
    rec = out["log"]
    require([r["step"] for r in rec] == list(range(steps)), f"logged steps {[r['step'] for r in rec]}")
    require(all(math.isfinite(r["loss"]) and math.isfinite(r["grad_norm"]) for r in rec),
            f"a non-finite loss or grad norm: {[(r['loss'], r['grad_norm']) for r in rec]}")
    require(rec[-1]["loss"] < rec[0]["loss"], f"the loss did not decrease: {rec[0]['loss']} -> {rec[-1]['loss']}")
    return out


def check_train(torch, out, rates):
    """One more step of the run (batch, dedup, train step) under the
    profiler, its AdamW range's share of the device time; the AdamW pass
    alone timed with CUDA events on the run's state."""
    from repro_torch.data.pipeline import dedup_batch, make_batch
    from repro_torch.optim.adam import AdamConfig, adam_update

    model, state, pcfg = out["model"], out["state"], out["pipe_cfg"]
    step = out["done"]

    def one_step():
        b = make_batch(pcfg, 0, step)
        pipe, b, _ = dedup_batch(pcfg, state["pipe"], b, 0, step)
        return out["train_step"](model, state["opt"], b)[2]

    metrics = profile(torch, f"one train step of {pcfg.batch_per_shard} x {pcfg.seq_len} tokens (dedup, forward, "
                             f"backward with remat, AdamW)", one_step, top=8,
                      show=("fused_lookup_kernel", "block_sort_kernel", "kway_merge_kernel"), ranges=("adam_update",),
                      phase=12, out=rates)
    require(math.isfinite(float(metrics["loss"])), "non-finite loss in the profiled step")
    grads = {n: torch.full_like(p, 1e-3) for n, p in model.named_parameters()}
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    times = []
    for _ in range(3):
        torch.cuda.synchronize()
        start.record()
        adam_update(AdamConfig(), model, grads, state["opt"])
        end.record()
        torch.cuda.synchronize()
        times.append(start.elapsed_time(end))
    rates["adam_ms"] = min(times)
    del grads


def check_train_families(torch, device, seed):
    """Every family's smoke config: one train step (remat "full", AdamW with
    eps 1e-6, so that no gradient at fp32 noise picks an update's sign) on
    the card against the same step on the CPU, fp32 with TF32 off. Loss,
    aux, grad_norm and lr at rtol 1e-4; every updated parameter and both
    moments within 1e-3 of the tensor's largest magnitude on the CPU; the
    audio encoder (bf16 whatever the weights) at 2e-2 elementwise."""
    import copy

    from repro_torch.configs.base import ARCH_IDS, get_smoke_config
    from repro_torch.models import model_zoo as zoo
    from repro_torch.optim.adam import AdamConfig, adam_init
    from repro_torch.train.steps import make_train_step

    ocfg = AdamConfig(lr=1e-3, eps=1e-6, warmup_steps=2, total_steps=10)
    saved = torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = False
    errs = {}
    try:
        for arch in ARCH_IDS:
            cfg = get_smoke_config(arch)
            cpu_model = zoo.init_params(cfg, seed=seed, device="cpu", dtype=torch.float32)
            rng = np.random.default_rng(seed)
            st = 32 - (cfg.num_patches if cfg.has_vision_stub else 0)
            batch = {"tokens": rng.integers(0, cfg.vocab_size, (2, st)),
                     "labels": rng.integers(0, cfg.vocab_size, (2, st))}
            if cfg.has_vision_stub:
                batch["patch_embeds"] = rng.normal(size=(2, cfg.num_patches, cfg.d_model)).astype(np.float32)
            if cfg.is_encoder_decoder:
                batch["frames"] = rng.normal(size=(2, 16, cfg.d_model)).astype(np.float32)
            card_model = copy.deepcopy(cpu_model).to(device)  # before the CPU step updates cpu_model
            res = {}
            for where, model in (("cpu", cpu_model), ("card", card_model)):
                dev = model.embed.device
                b = {k: torch.as_tensor(v, device=dev) for k, v in batch.items()}
                model, opt, metrics = make_train_step(cfg, ocfg)(model, adam_init(ocfg, model), b)
                res[where] = (metrics, dict(model.named_parameters()), opt.m, opt.v)
            (gm, *got), (em, *exp) = res["card"], res["cpu"]
            for k in ("loss", "aux_loss", "grad_norm", "lr"):
                require(math.isclose(gm[k].item(), em[k].item(), rel_tol=1e-4, abs_tol=1e-7),
                        f"{arch}: {k} {gm[k].item()} on the card, {em[k].item()} on the CPU")
            err = 0.0
            for g_tree, e_tree in zip(got, exp):
                for name, e in e_tree.items():
                    g, e = g_tree[name].detach().cpu().float(), e.detach().float()
                    require(bool(torch.isfinite(g).all()), f"{arch} {name}: non-finite on the card")
                    if name.startswith("enc_"):
                        require(torch.allclose(g, e, rtol=2e-2, atol=2e-2), f"{arch} {name}: card differs from the CPU")
                    else:
                        d = (g - e).abs().max().item()
                        require(d <= 1e-3 * e.abs().max().item(), f"{arch} {name}: max err {d} on the card")
                        err = max(err, d / max(e.abs().max().item(), 1e-30))
            errs[arch] = err
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = saved
    log(f"phase 12 families: {len(errs)} smoke configs, one train step on the card against the CPU (fp32, TF32 "
        f"off; metrics, parameters, m, v), max error over the tensor's largest magnitude "
        f"{json.dumps({k: float(f'{v:.3e}') for k, v in errs.items()})}")
    return errs


def check_supervisor(torch, device, ckpt_root):
    """The training driver's fault tolerance on the card, StableLM's smoke
    config under torch.use_deterministic_algorithms(True): a failure before
    the first save (restart from the initial state) and one after a save
    (restore from the checkpoint) each end bit for bit equal to an unbroken
    run: parameters, moments, the dedup index with its host fields, losses."""
    from repro_torch.checkpoint.checkpoint import tree_flatten_with_path
    from repro_torch.launch import train

    argv = ["--arch", "stablelm-1.6b", "--smoke", "--steps", "6", "--batch", "8", "--seq", "16", "--log-every", "1",
            "--device", str(device)]
    torch.use_deterministic_algorithms(True)
    try:
        runs = {name: train.run(argv + ["--ckpt-dir", str(ckpt_root / name), *extra]) for name, extra in (
            ("unbroken", []), ("early", ["--fail-at", "2", "--save-every", "50"]),
            ("late", ["--fail-at", "4", "--save-every", "2"]), ("saved", ["--save-every", "3"]))}
        # Phase 13c: --resume restores through the driver's sharding plan
        # (restore(shardings=plan), every leaf onto this card).
        shutil.rmtree(ckpt_root / "saved" / "step_00000006")
        runs["resumed"] = train.run(argv + ["--ckpt-dir", str(ckpt_root / "saved"), "--resume", "--save-every", "3"])
    finally:
        torch.use_deterministic_algorithms(False)
        shutil.rmtree(ckpt_root, ignore_errors=True)
    require("RESTART from initial state (no checkpoint)" in runs["early"]["supervisor_log"],
            f"early failure: {runs['early']['supervisor_log']}")
    require("RESTART from checkpoint step 4" in runs["late"]["supervisor_log"],
            f"late failure: {runs['late']['supervisor_log']}")
    exp = tree_flatten_with_path(runs["unbroken"]["state"])[0]
    require(exp[0][1].device.type == device.type, f"the state is not on {device}")
    require([r["step"] for r in runs["resumed"]["log"]] == [3, 4, 5], f"resumed steps {runs['resumed']['log']}")
    for name in ("early", "late", "resumed"):
        got = tree_flatten_with_path(runs[name]["state"])[0]
        require([p for p, _ in got] == [p for p, _ in exp], f"{name}: the state's structure differs")
        for (path, a), (_, b) in zip(got, exp):
            same = torch.equal(a, b) and a.device == b.device if isinstance(b, torch.Tensor) else a == b
            require(same, f"{name}: {path} differs from the unbroken run")
        n = len(runs[name]["losses"])
        require(runs[name]["losses"][-min(n, 6):] == runs["unbroken"]["losses"][-min(n, 6):], f"{name}: losses differ")
    log(f"phase 12 supervisor: restart from the initial state (failure at step 2, no save) and from the checkpoint "
        f"of step 4 (failure at step 4, saves every 2) each equal to the unbroken run bit for bit ({len(exp)} "
        f"leaves: parameters, moments, dedup index); losses {[round(v, 4) for v in runs['unbroken']['losses']]}")
    log(f"phase 13c restore with a plan: --resume from the checkpoint of step 3 through restore(shardings=plan) onto "
        f"{device} (the driver's plan over best_fit_mesh of its one device) equals the unbroken run bit for bit "
        f"({len(exp)} leaves; losses of steps 3-5 {[round(v, 4) for v in runs['resumed']['losses']]})")


def check_supervisor_on_card(ckpt_root):
    """`check_supervisor` on the card in a child process: deterministic
    algorithms need CUBLAS_WORKSPACE_CONFIG set before CUDA starts, and the
    other phases keep cuBLAS's default workspace."""
    code = ("import sys, torch; from pathlib import Path; sys.path[:0] = [{!r}, {!r}]; import chip_smoke as c; "
            "c.check_supervisor(torch, torch.device('cuda'), Path({!r}))").format(str(ROOT / "src"), str(ROOT),
                                                                                str(ckpt_root))
    res = subprocess.run([sys.executable, "-c", code], env=dict(os.environ, CUBLAS_WORKSPACE_CONFIG=":4096:8"),
                         timeout=900)
    require(res.returncode == 0, f"the supervisor check on the card failed (exit {res.returncode})")


# ---------------------------------------------------------------------------
# phase 13: the LM stack's multi-device layer
# ---------------------------------------------------------------------------


def check_plan(out_dir):
    """13a: `python -m repro_torch.launch.dryrun --all` in-process: every
    (arch x shape) cell on both production meshes, on the meta device (a CPU
    computation). Returns its wall seconds."""
    from repro_torch.configs.base import ARCH_IDS, get_config
    from repro_torch.configs.shapes import shapes_for
    from repro_torch.launch import dryrun

    t0 = time.perf_counter()
    records = dryrun.run(["--all", "--force", "--out", str(out_dir)])
    wall = time.perf_counter() - t0
    cells = 2 * sum(len(shapes_for(get_config(a))) for a in ARCH_IDS)
    failed = [f"{r['arch']}__{r['shape']}__{r['mesh']}: {r['error']}" for r in records if r["status"] != "ok"]
    require(not failed and len(records) == cells, f"plan check: {len(records)} of {cells} cells, failures {failed}")
    train = {(r["arch"], r["mesh"]): r["per_device_bytes"] for r in records if r["shape"] == "train_4k"}
    log(f"phase 13a plan check: python -m repro_torch.launch.dryrun --all, {len(records)} cells, 0 failures, "
        f"{wall:.2f} s wall (a CPU computation on the meta device; no card work); train_4k per-device bytes of "
        f"parameters + gradients + AdamW moments, 16x16 / 2x16x16: " + "; ".join(
            f"{a} {sum(train[a, '16x16'][k] for k in ('params', 'grads', 'moments'))} / "
            f"{sum(train[a, '2x16x16'][k] for k in ('params', 'grads', 'moments'))}" for a in ARCH_IDS))
    return wall


def bf16_ulps(torch, got, exp) -> int:
    """The largest distance in bf16 units in the last place between two bf16 tensors."""
    def ordered(t):
        i = t.view(torch.int16).to(torch.int32)
        return torch.where(i < 0, -32768 - i, i)

    return int((ordered(got) - ordered(exp)).abs().max()) if got.numel() else 0


def check_compression(torch, device, seed, *, arch, ranks, out):
    """13b: `compressed_tree_psum` over `ranks` gradient trees of `arch` at
    full width (bf16, from a generator seeded `seed` on the card), every rank
    on this one card, run one after another. A warm-up call, then one call
    timed with CUDA events and held against the same function on the CPU on
    a sample of leaves (the largest among them), then one call profiled;
    64 calls on a constant fp32 gradient must average to it (atol 1e-3)."""
    from repro_torch.configs.base import get_config
    from repro_torch.dist.compression import compressed_tree_psum, init_error_state
    from repro_torch.models import model_zoo as zoo

    shapes = {n: tuple(p.shape) for n, p in zoo.init_params(get_config(arch), device="meta").named_parameters()}
    n_params = sum(math.prod(s) for s in shapes.values())
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    gen = torch.Generator(device=device).manual_seed(seed)
    trees = [{n: torch.randn(s, generator=gen, device=device, dtype=torch.bfloat16).mul_(1e-2)
              for n, s in shapes.items()} for _ in range(ranks)]
    _, errs = compressed_tree_psum(trees, [init_error_state(t) for t in trees])  # the residuals are no longer 0
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    mean, new_errs = compressed_tree_psum(trees, errs)
    end.record()
    torch.cuda.synchronize()
    out["ms"] = start.elapsed_time(end)
    by_size = sorted(shapes, key=lambda n: math.prod(shapes[n]))
    sample = [by_size[-1], by_size[len(by_size) // 2], by_size[0]]
    t0 = time.perf_counter()
    host = [{n: t[n].cpu() for n in sample} for t in trees]
    cpu_mean, cpu_errs = compressed_tree_psum(host, [{n: e[n].cpu() for n in sample} for e in errs])
    worst = 0
    for n in sample:
        got = [mean[n].cpu()] + [e[n].cpu() for e in new_errs]
        exp = [cpu_mean[n]] + [e[n] for e in cpu_errs]
        worst = max(worst, max(bf16_ulps(torch, g, e) for g, e in zip(got, exp)))
        require(all(torch.equal(g, e) for g, e in zip(got, exp)),
                f"compression of {n}: the card differs from the CPU by {worst} bf16 ulps")
    out["cpu_check_s"] = time.perf_counter() - t0
    del errs, mean, host, cpu_mean, cpu_errs
    metrics = {}
    profile(torch, f"one compressed_tree_psum of {ranks} ranks x {n_params} bf16 parameters",
            lambda: compressed_tree_psum(trees, new_errs), top=5, phase="13b", out=metrics)
    out["peak_gib"] = torch.cuda.max_memory_allocated() / 2**30
    del trees, new_errs
    torch.cuda.empty_cache()

    g = torch.tensor([0.001, -1.0, 0.5, 0.3333], device=device)
    trees = [{"g": g.clone()} for _ in range(ranks)]
    errs = [init_error_state(t) for t in trees]
    acc = torch.zeros_like(g)
    for _ in range(64):
        m, errs = compressed_tree_psum(trees, errs)
        acc += m["g"]
    conv = (acc / 64 - g).abs().max().item()
    require(conv <= 1e-3, f"64 compressed means of a constant gradient miss it by {conv}")
    bound_ms = n_params * (ranks * 6 + 2) / HBM_BYTES_PER_S * 1e3
    out.update(n_params=n_params, bound_ms=bound_ms, idle_share=metrics["idle_share"], busy_ms=metrics["busy_ms"],
               sample=sample, convergence_err=conv)
    log(f"phase 13b compression: {ranks} ranks of {arch} ({n_params} bf16 parameters, {len(shapes)} leaves each) on "
        f"this one card, one after another; one call {out['ms']:.2f} ms by CUDA events, byte bound "
        f"{bound_ms:.2f} ms ({ranks * 6 + 2} bytes a parameter over 3.35 TB/s); profiled call idle share "
        f"{metrics['idle_share']:.4f}, device busy {metrics['busy_ms']:.2f} ms; peak memory {out['peak_gib']:.2f} "
        f"GiB; card vs CPU on {sample}: bit for bit (max {worst} bf16 ulps, {out['cpu_check_s']:.2f} s); 64 calls on "
        f"a constant fp32 gradient average to it within {conv:.3e}")


# ---------------------------------------------------------------------------
# phase 14: the four examples on the card
# ---------------------------------------------------------------------------

RATE = " streamed updates in "

# Each dictionary example: (file, arguments on both devices, arguments on the
# card, the kernels its path launches).
STAGED_PATH = ("merge_cascade", "bound", "fused_lookup")
DICT_EXAMPLES = {
    "quickstart": ("torch_quickstart.py", [], [], STAGED_PATH + ("merge_path",)),
    "streaming": ("torch_streaming_updates.py", [], [], ("merge_cascade", "bound")),
    "serving": ("torch_dictionary_serving.py", [], [], STAGED_PATH),
    "serving --server": ("torch_dictionary_serving.py", ["--server"], [], STAGED_PATH),
    "serving --sharded": ("torch_dictionary_serving.py", ["--sharded", "--shards", "4"], ["--device", "cuda:0"],
                          STAGED_PATH),
}
DEDUP_PATH = ("bitonic_sort", "fused_lookup", "merge_cascade")


def run_example(name, argv):
    """`python examples/<name> *argv` in this process: its stdout lines and
    wall seconds. A failing example raises."""
    path = str(ROOT / "examples" / name)
    out, saved = io.StringIO(), sys.argv
    sys.argv = [path, *argv]
    t0 = time.perf_counter()
    try:
        with contextlib.redirect_stdout(out):
            runpy.run_path(path, run_name="__main__")
    finally:
        sys.argv = saved
    return out.getvalue().splitlines(), time.perf_counter() - t0


def comparable(lines):
    """Lines as compared across devices: the repr's `device='...'` field
    dropped, and of the streaming rate line only the update count."""
    return [ln.split(RATE)[0] if RATE in ln else re.sub(r"^(Dictionary\(.*), device='[^']*'\)$", r"\1)", ln)
            for ln in lines]


def drive_examples(torch, drive):
    """Phase 14. Returns {label: {"wall_s", "launches", ...}}; `drive` zeroes
    the launch counts before a card run and reads them after it."""
    ckpt = ROOT / "build" / "examples_ckpt"
    shutil.rmtree(ckpt, ignore_errors=True)
    res = {}
    for label, (name, argv, card_argv, path) in DICT_EXAMPLES.items():
        (lines, wall), counts = drive(f"14 {label}", lambda: run_example(name, argv + card_argv))
        for ln in lines:
            log(f"    {ln}")
        cpu_lines, cpu_wall = run_example(name, argv + ["--device", "cpu"])
        require(comparable(lines) == comparable(cpu_lines),
                f"{label}: the card's lines differ from the CPU's:\n" + "\n".join(lines) + "\n--- cpu\n"
                + "\n".join(cpu_lines))
        require(all(counts[k] > 0 for k in path), f"a kernel of {label}'s path did not run: {counts}")
        log(f"phase 14 {label}: {wall:.2f} s on the card, {cpu_wall:.2f} s with --device cpu; {len(lines)} lines, "
            f"equal to the CPU's")
        res[label] = dict(wall_s=wall, cpu_wall_s=cpu_wall, launches=counts)
        if label == "streaming":
            res[label]["rate_line"] = next(ln for ln in lines if RATE in ln)
    runs = {"train_lm": ["--ckpt-dir", str(ckpt / "smoke")],
            "train_lm full width": ["--no-smoke", "--arch", "stablelm-1.6b", "--batch", "8", "--seq", "2048",
                                    "--steps", "12", "--log-every", "1", "--ckpt-dir", str(ckpt / "full")]}
    for label, argv in runs.items():
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        log(f"phase 14 {label}: python examples/torch_train_lm.py {' '.join(argv)}")
        (lines, wall), counts = drive(f"14 {label}", lambda: run_example("torch_train_lm.py", argv))
        for ln in lines:
            log(f"    {ln}")
        require("[train] loss decreased ✓" in lines, f"{label}: the loss did not decrease")
        require(all(counts[k] > 0 for k in DEDUP_PATH), f"a kernel of {label}'s dedup did not run: {counts}")
        steps_ms = [float(ln.rsplit("step_ms ", 1)[1]) for ln in lines if ln.startswith("  step ")]
        res[label] = dict(wall_s=wall, launches=counts, steps_ms=steps_ms,
                          peak_gib=torch.cuda.max_memory_allocated() / 2**30)
        gc_collect(torch)
    shutil.rmtree(ckpt, ignore_errors=True)
    return res


def gc_collect(torch):
    gc.collect()
    torch.cuda.empty_cache()


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
    from repro_torch.kernels import _build, bitonic_sort, lsm_lookup, merge_path, window_select

    t_all = time.perf_counter()
    device = torch.device("cuda")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60).stdout.strip().splitlines()[0]
    card = f"{torch.cuda.get_device_name(0)}, power limit {smi.split(',')[-1].strip()}"
    log(smi)
    log(f"phase 1 device: {torch.cuda.get_device_name(0)}; torch {torch.__version__}, CUDA {torch.version.cuda}")

    kernels = {"merge_cascade": merge_path.CASCADE_KERNEL, "bound": lsm_lookup.BOUND_KERNEL,
               "fused_lookup": lsm_lookup.LOOKUP_KERNEL, "bitonic_sort": bitonic_sort.KERNEL,
               "merge_path": merge_path.PATH_KERNEL, "window_select": window_select.SELECT_KERNEL}
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
    staged_path = ("merge_cascade", "bound", "fused_lookup", "window_select")
    require(all(launches4[k] > 0 for k in staged_path), f"a kernel did not run on phase 4's path: {launches4}")

    t0 = time.perf_counter()
    k1 = dev_tensor(torch, rng.integers(0, MAX_USER_KEY - 1022, 1 << 14).astype(np.int32), device)
    rows = kernel_rows(torch, d, q_lookup, k1, errs, launches4)
    from repro_torch.api import QueryPlan
    profile(torch, f"count of {k1.shape[0]} windows of 1024 keys",
            lambda: d.count(k1, k1 + 1023, QueryPlan(max_candidates=1024, max_results=512)), top=10,
            show=("bounds_runs_kernel", "window_select_kernel"))
    profile(torch, f"lookup of {q_lookup.shape[0]} queries", lambda: d.lookup(q_lookup), top=10,
            show=("fused_lookup_kernel", "bucket_count_kernel", "bucket_scatter_kernel"))
    keys = dev_tensor(torch, rng.integers(0, MAX_USER_KEY + 1, 1 << 20).astype(np.int32), device)
    d = profile(torch, f"insert of {keys.shape[0]} lanes", lambda: d.insert(keys, keys % 1009))
    log(f"phase 5 kernel timing: {time.perf_counter() - t0:.2f} s")
    del d, q_lookup, keys
    torch.cuda.empty_cache()
    rows.append(window_select_row(torch, device, rng, errs, launches4))

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
    torch.cuda.empty_cache()
    dedup_rates, launches9 = drive(9, lambda: drive_dedup(
        torch, device, args.seed, vocab=32000, seq_len=2048, batch=4096, levels=16, steps=16))
    require(all(launches9[k] > 0 for k in ("bitonic_sort", "merge_cascade", "fused_lookup")),
            f"a kernel did not run on phase 9's path: {launches9}")

    # Phase 10: four shards of the sharded LSM, all on this one card (run one
    # after another), at phase 6's and phase 7's scale.
    torch.cuda.empty_cache()
    peak_1_9 = torch.cuda.max_memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    card0 = torch.device("cuda", torch.cuda.current_device())
    sh_rates, launches10a = drive("10a", lambda: drive_sharded(
        torch, card0, args.seed, bulk_keys, bulk_vals, shards=4, b=b, capacity=capacity, calls=256, lanes=1 << 18,
        n_lookups=1 << 20, n_windows=1 << 14, reps=3))
    require(all(launches10a[k] > 0 for k in ("merge_cascade", "bitonic_sort", "fused_lookup", "bound")),
            f"a kernel of the LSM path did not run on phase 10's sharded path: {launches10a}")
    del bulk_keys, bulk_vals
    torch.cuda.empty_cache()
    sh_srv_rates, launches10b = drive("10b", lambda: drive_server(
        torch, card0, args.seed, b=b, capacity=capacity, log2_resident=26, fill_calls=64, tenants=4096,
        key_space=1 << 16, events=1 << 16, step_every=4096, n_sample=1 << 20, max_candidates=1024,
        backend="lsm_sharded", num_shards=4, resident_stride=5, phase=10))
    require(all(launches10b[k] > 0 for k in staged_path), f"a kernel did not run on phase 10's server: {launches10b}")
    sh_peak = torch.cuda.max_memory_allocated() / 2**30

    # Phase 11: LM serving, Qwen2-7B at full width, its KV page
    # index in the LSM through the DictionaryServer (earlier state freed).
    torch.cuda.empty_cache()
    peak_1_10 = max(peak_1_9, torch.cuda.max_memory_allocated())
    torch.cuda.reset_peak_memory_stats()
    lm_args = dict(arch="qwen2-7b", requests=16, batch=8, prompt_len=512, gen_tokens=32, page_size=16)
    lm_out, launches11 = drive(11, lambda: drive_lm(torch, device, **lm_args))
    require(all(launches11[k] > 0 for k in staged_path), f"a kernel did not run on phase 11's path: {launches11}")
    lm_peak = torch.cuda.max_memory_allocated() / 2**30
    t0 = time.perf_counter()
    lm = {}
    param_bytes = sum(p.numel() * p.element_size() for p in lm_out["model"].parameters())
    lm_params = lm_out["params_count"]
    check_lm(torch, lm_out, lm)
    check_families(torch, device, args.seed)
    log(f"phase 11 checks: {time.perf_counter() - t0:.2f} s")

    # Phase 12: LM training, StableLM-2-1.6B at full width with the LSM
    # dedup pipeline on the card (phase 11's model freed first).
    del lm_out["cfg"], lm_out["prompts"]
    torch.cuda.empty_cache()
    peak_1_11 = max(peak_1_10, torch.cuda.max_memory_allocated())
    torch.cuda.reset_peak_memory_stats()
    tr_args = dict(arch="stablelm-1.6b", steps=20, batch=8, seq=2048)
    tr_out, launches12 = drive(12, lambda: drive_train(torch, device, **tr_args,
                                                       ckpt_dir=ROOT / "build" / "train_ckpt"))
    require(all(launches12[k] > 0 for k in ("fused_lookup", "bitonic_sort", "merge_cascade")),
            f"a kernel of the dedup pipeline did not run on phase 12's path: {launches12}")
    tr = {}
    t0 = time.perf_counter()
    check_train(torch, tr_out, tr)
    tr_peak = torch.cuda.max_memory_allocated() / 2**30
    from repro_torch.configs.base import get_config
    from repro_torch.configs.shapes import InputShape
    from repro_torch.models import model_zoo as zoo

    flops = zoo.model_flops(get_config(tr_args["arch"]), InputShape("train", "train", tr_args["seq"], tr_args["batch"]))
    tr_params = sum(p.numel() for p in tr_out["model"].parameters())
    del tr_out["model"], tr_out["state"], tr_out["train_step"]
    torch.cuda.empty_cache()
    check_train_families(torch, device, args.seed)
    check_supervisor_on_card(ROOT / "build" / "train_ckpt")
    log(f"phase 12 checks (with 13c): {time.perf_counter() - t0:.2f} s")

    # Phase 13: the multi-device layer: the plan check of every dry-run cell
    # (meta device), and int8 gradient compression of 4 ranks of StableLM's
    # gradients at full width, all on this card (phase 12's state freed).
    t13 = time.perf_counter()
    peak_1_12 = max(peak_1_11, tr_peak * 2**30, torch.cuda.max_memory_allocated())
    plan_s = check_plan(ROOT / "build" / "dryrun")
    comp = {}
    check_compression(torch, device, args.seed, arch="stablelm-1.6b", ranks=4, out=comp)
    t13 = time.perf_counter() - t13

    # Phase 14: the four examples on the card, as a user runs them (phase
    # 13's state freed first).
    gc_collect(torch)
    peak_1_13 = max(peak_1_12, torch.cuda.max_memory_allocated())
    t14 = time.perf_counter()
    ex = drive_examples(torch, drive)
    t14 = time.perf_counter() - t14
    launches14 = {name: sum(r["launches"][name] for r in ex.values()) for name in kernels}
    require(all(v > 0 for v in launches14.values()), f"a kernel did not run in phase 14: {launches14}")

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
    r = sh_rates
    log(f"phase 10 rates ({card}; 4 shards run one after another on this one card, not a multi-card rate): "
        f"bulk build {r['bulk_build_M_elem_per_s']:.3f} M elem/s, update {r['update_M_elem_per_s']:.3f} M elem/s, "
        f"lookup {r['lookup_M_q_per_s']:.3f} M q/s, count {r['count_M_q_per_s']:.4f} M q/s, range "
        f"{r['range_M_q_per_s']:.4f} M q/s, maintain(7b) {r['maintain_s'] * 1e3:.1f} ms, cleanup "
        f"{r['cleanup_s'] * 1e3:.1f} ms, size {r['size_s'] * 1e3:.1f} ms; idle share of one update call "
        f"{r['update_idle_share']:.3f}, of one lookup call {r['lookup_idle_share']:.3f}; server replay "
        f"{sh_srv_rates['replay_ops_per_s']:.1f} ops/s, {sh_srv_rates['replay_lanes_per_s']:.1f} lanes/s, fill "
        f"{sh_srv_rates['fill_M_elem_per_s']:.3f} M elem/s, step idle share {sh_srv_rates['idle_share']:.3f}, "
        f"cleanup {sh_srv_rates['cleanup_s'] * 1e3:.1f} ms; peak device memory of phase 10 {sh_peak:.2f} GiB")
    log(f"phase 10 launches: sharded dictionary {launches10a}; server {launches10b}")
    a, o = lm_args, lm_out
    step_bound_s = param_bytes / HBM_BYTES_PER_S
    log(f"phase 11 rates ({card}): {a['arch']} at full width, {lm_params} parameters ({param_bytes} bytes in "
        f"bf16); {a['requests']} requests in waves of {a['batch']}, prompts of {a['prompt_len']}, {a['gen_tokens']} "
        f"tokens each; prefill {o['prefill_s']:.4f} s ({a['requests'] * a['prompt_len'] / o['prefill_s']:.1f} "
        f"tok/s); decode {o['tokens'] / o['decode_s']:.1f} tok/s ({o['decode_s'] / (o['tokens'] / a['batch']) * 1e3:.3f} "
        f"ms a step of {a['batch']}), bound {a['batch'] / step_bound_s:.1f} tok/s (the parameter bytes read once a "
        f"step over 3.35 TB/s: {step_bound_s * 1e3:.3f} ms a step); served {o['tokens']} tokens in "
        f"{o['seconds']:.3f} s ({o['tokens_per_s']:.1f} tok/s), main() {o['main_s']:.2f} s with the parameters' "
        f"init; idle share of one decode step {lm['idle_share']:.3f}; peak device memory of the serving run "
        f"{lm_peak:.2f} GiB; server {json.dumps(o['stats'])}")
    log(f"phase 11 launches: {launches11}")
    steps_s = [r["step_s"] for r in tr_out["log"]]
    tokens = tr_args["batch"] * tr_args["seq"]
    step_s = sorted(steps_s[1:])[len(steps_s[1:]) // 2]  # median, the first step's warm-up left out
    adam_bound_ms = tr_params * 22 / HBM_BYTES_PER_S * 1e3
    log(f"phase 12 rates ({card}): {tr_args['arch']} at full width, {tr_params} parameters; {tr_args['steps']} "
        f"steps of {tr_args['batch']} x {tr_args['seq']} tokens with dedup and remat 'full'; step time median "
        f"{step_s * 1e3:.1f} ms (first {steps_s[0] * 1e3:.1f}, min {min(steps_s) * 1e3:.1f}, max "
        f"{max(steps_s) * 1e3:.1f}), {tokens / step_s:.1f} tok/s; FLOP bound {flops / BF16_FLOPS_PER_S * 1e3:.1f} ms "
        f"({flops:.4e} FLOP at 989 TFLOP/s), MFU {flops / step_s / BF16_FLOPS_PER_S:.4f}; profiled step wall "
        f"{tr['wall_ms']:.1f} ms, device busy {tr['busy_ms']:.1f} ms, idle share {tr['idle_share']:.4f}; "
        f"AdamW range {tr['adam_update_ms']:.2f} ms in the profile ({tr['adam_update_ms'] / tr['busy_ms']:.4f} of "
        f"device busy), "
        f"alone {tr['adam_ms']:.2f} ms (bound {adam_bound_ms:.2f} ms: 22 bytes a parameter over 3.35 TB/s); peak "
        f"device memory of the training run {tr_peak:.2f} GiB (driver's own reading "
        f"{(tr_out['peak_mem_bytes'] or 0) / 2**30:.2f} GiB); dups per step {[r['dups'] for r in tr_out['log']]}; "
        f"losses {[round(r['loss'], 4) for r in tr_out['log']]}; main() {tr_out['main_s']:.2f} s")
    log(f"phase 12 launches: {launches12}")
    log(f"phase 13 rates ({card}): plan check of every dry-run cell {plan_s:.2f} s (CPU); compression of 4 ranks x "
        f"{comp['n_params']} bf16 parameters {comp['ms']:.2f} ms a call, {comp['ms'] / comp['bound_ms']:.2f}x its "
        f"{comp['bound_ms']:.2f} ms byte bound, idle share {comp['idle_share']:.4f}, peak memory "
        f"{comp['peak_gib']:.2f} GiB; phase 13 {t13:.2f} s (13c ran in phase 12's child process)")
    full = ex["train_lm full width"]
    full_ms = sorted(full["steps_ms"][1:])[len(full["steps_ms"][1:]) // 2]  # median, the first step left out
    log(f"phase 14 rates ({card}): " + "; ".join(
        f"{label} {r['wall_s']:.2f} s" + (f" (cpu {r['cpu_wall_s']:.2f} s)" if "cpu_wall_s" in r else "")
        for label, r in ex.items()) + f"; streaming: {ex['streaming']['rate_line'].strip()}; train_lm full width "
        f"(stablelm-1.6b, 8 x 2048 tokens, 12 steps): step median {full_ms:.1f} ms (first "
        f"{full['steps_ms'][0]:.1f}, min {min(full['steps_ms']):.1f}, max {max(full['steps_ms']):.1f}), peak device "
        f"memory {full['peak_gib']:.2f} GiB; train_lm smoke peak {ex['train_lm']['peak_gib']:.2f} GiB; phase 14 "
        f"{t14:.2f} s")
    log(f"phase 14 launches: " + "; ".join(f"{label} {r['launches']}" for label, r in ex.items())
        + f"; over the phase {launches14}")
    log(f"peak device memory {max(peak_1_13, torch.cuda.max_memory_allocated()) / 2**30:.2f} GiB; "
        f"total {time.perf_counter() - t_all:.1f} s")
    log(smi)
    log(json.dumps({"kernels": rows}))
    log(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                           "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
