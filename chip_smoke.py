#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port of the GPU LSM (src/repro_torch) on one NVIDIA card.

    python3 chip_smoke.py [--seed 0]

Phases, one line each with its seconds:
  1. the card: `nvidia-smi` name and power limit, and torch's device name;
  2. build: every CUDA kernel from src/repro_torch/csrc, one nvcc per source,
     all started together;
  3. each kernel against its plain PyTorch version on the card, by exact
     equality, at the main path's sizes and at edge cases;
  4. the main path through the `Dictionary` facade at the paper's Table 2
     scale (n = 2^27 resident elements, b = 2^16, L = 12): fill by inserts,
     delete, re-insert, flush, lookup, count, range, maintain, cleanup, size,
     every result held exactly against a numpy oracle of last-write-wins,
     and every kernel's launch count moved;
  5. each kernel's time at the main path's shapes beside its bound, its plain
     version's time and a PyTorch library call's, as one `kernels` JSON line.
The last line is {"ok": true, "device": {...}}. Any failure exits non-zero
before it. Without a CUDA device, or without the repository's src/ beside
it, the script exits non-zero and prints no result.
"""

from __future__ import annotations

import argparse
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
    from repro_torch.kernels import lsm_lookup, merge_path

    errs = {"merge_cascade": 0, "bound": 0, "fused_lookup": 0}
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

    kv, _ = sorted_run(rng, 1 << 26, MAX_USER_KEY + 1)
    q = np.concatenate([rng.integers(0, MAX_USER_KEY + 1, (1 << 20) - 4),
                        [0, MAX_USER_KEY, PLACEBO_KEY, INT32_MAX]]).astype(np.int32)
    kv_d, q_d = dev_tensor(torch, kv, device), dev_tensor(torch, q, device)
    for upper in (False, True):
        got = lsm_lookup.bound(kv_d, q_d, shift=1, upper=upper)
        exp = lsm_lookup.search_plain(kv_d, q_d, shift=1, upper=upper).to(torch.int32)
        torch.cuda.synchronize()
        errs["bound"] = max(errs["bound"], max_err(torch, [got], [exp]))
        cases += 1
    del kv_d

    b = 1 << 12  # 13 runs (buffer + 12 levels), 2^24 elements
    runs = [sorted_run(rng, n, 1 << 22) for n in [b] + [b << i for i in range(12)]]
    flat = np.concatenate([kv for kv, _ in runs]) >> 1
    q = np.concatenate([rng.choice(flat, 1 << 19), rng.integers(0, 1 << 23, (1 << 19) - 4),
                        [0, MAX_USER_KEY, PLACEBO_KEY, INT32_MAX]]).astype(np.int32)
    kvs = [dev_tensor(torch, kv, device) for kv, _ in runs]
    vals = [dev_tensor(torch, v, device) for _, v in runs]
    q_d = dev_tensor(torch, q, device)
    got = lsm_lookup.fused_lookup_runs(kvs, vals, q_d)
    exp = lsm_lookup.fused_lookup_plain(kvs, vals, q_d)
    torch.cuda.synchronize()
    errs["fused_lookup"] = max_err(torch, got, exp)
    tomb_hits = int(((got[0] >> 1 == q_d) & (got[0] & 1 == 0)).sum())
    require(tomb_hits > 0, "lookup check has no tombstone hits")
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


def depth(n: int) -> int:
    """Probes of one binary search over n keys."""
    return n.bit_length()


def search_footprint(torch, kv, q, active):
    """Replay the kernels' lower-bound search on original keys (csrc/common.cuh
    repro_search, shift 1) for the `active` queries. Returns the bounds, a mask
    of the keys the searches read, and the number of probes."""
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
        right = (kv[mid.clamp(max=n - 1)] >> 1) < q
        lo = torch.where(live & right, mid + 1, lo)
        hi = torch.where(live & ~right, mid, hi)
    return lo, seen, int(probes)


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

    def check(name, kernel_fn, plain_fn):
        errs[name] = max(errs[name], max_err(torch, kernel_fn(), plain_fn()))
        require(errs[name] == 0, f"{name} differs from its plain version at the main path's shape")

    def row(name, source, replaces, ms, plain_ms, library_ms, nbytes, ops):
        t_bytes, t_ops = nbytes / HBM_BYTES_PER_S * 1e3, ops / OPS_PER_S * 1e3
        rows.append(dict(name=name, route="cuda", source=source, replaces=replaces,
                         launches=launches[name], max_abs_err=errs[name], ms=ms, plain_ms=plain_ms,
                         bound_ms=max(t_bytes, t_ops), bound_by="bytes" if t_bytes >= t_ops else "operations",
                         library_ms=library_ms))

    # Merge: every run of the structure, as size() merges them.
    check("merge_cascade", lambda: merge_path.merge_cascade_path(kvs, vals),
          lambda: merge_path.merge_cascade_plain(kvs, vals))
    orig = d.state.arena_kv >> 1
    ms = time_ms(torch, lambda: merge_path.merge_cascade_path(kvs, vals), iters=3)
    plain = time_ms(torch, lambda: merge_path.merge_cascade_plain(kvs, vals), iters=2)
    lib = time_ms(torch, lambda: torch.sort(orig, stable=True), iters=2)
    del orig
    searches = sum(n_s * sum(depth(n_t) for t, n_t in enumerate(lens) if t != s) for s, n_s in enumerate(lens))
    row("merge_cascade", "src/repro_torch/csrc/merge_cascade.cu", "src/repro/kernels/merge_path.py:263",
        ms, plain, lib, 16 * total, searches)

    # Bound: one count/range stage-1 search, the deepest full level against
    # the windows. Bytes: queries and outputs once, and each key the searches
    # read once (the levels of the search tree that all queries share count once).
    require(st.r > 0, "no full level to search")
    level, nq = st.key_vars[st.r.bit_length() - 1], k1.shape[0]
    level_orig = level >> 1
    check("bound", lambda: [lsm_lookup.bound(level, k1)],
          lambda: [lsm_lookup.search_plain(level, k1, shift=1, upper=False)])
    ms = time_ms(torch, lambda: lsm_lookup.bound(level, k1), iters=20)
    plain = time_ms(torch, lambda: lsm_lookup.search_plain(level, k1, shift=1, upper=False), iters=5)
    lib = time_ms(torch, lambda: torch.searchsorted(level_orig, k1), iters=20)
    idx, seen, probes = search_footprint(torch, level, k1, torch.ones_like(k1, dtype=torch.bool))
    require(torch.equal(idx.to(torch.int32), lsm_lookup.bound(level, k1)), "bound footprint replay differs")
    keys_read = int(seen.sum())
    log(f"  bound footprint: {probes} probes, {keys_read} distinct keys read of {level.shape[0]}")
    row("bound", "src/repro_torch/csrc/bounds.cu", "src/repro/kernels/lsm_lookup.py:88",
        ms, plain, lib, 8 * nq + 4 * keys_read, probes)

    # Lookup: the lookup queries against every run, newest first; a query
    # stops at the first run holding its key. Bytes: queries and both outputs
    # once, each key the searches and match checks read once, and each value
    # a hit reads once. Operations: one compare per probe and per match check.
    check("fused_lookup", lambda: lsm_lookup.fused_lookup_runs(kvs, vals, q_lookup),
          lambda: lsm_lookup.fused_lookup_plain(kvs, vals, q_lookup))
    ms = time_ms(torch, lambda: lsm_lookup.fused_lookup_runs(kvs, vals, q_lookup), iters=20)
    plain = time_ms(torch, lambda: lsm_lookup.fused_lookup_plain(kvs, vals, q_lookup), iters=3)
    nq = q_lookup.shape[0]
    active = torch.ones(nq, dtype=torch.bool, device=q_lookup.device)
    read = probes = 0
    for kv in kvs:
        n = kv.shape[0]
        if n == 0:
            continue
        idx, seen, p = search_footprint(torch, kv, q_lookup, active)
        ends = active & (idx < n)
        seen[idx[ends]] = True
        hit = ends & ((kv[idx.clamp(max=n - 1)] >> 1) == q_lookup)
        read += int(seen.sum()) + torch.unique(idx[hit]).numel()
        probes += p + int(ends.sum())
        active &= ~hit
    got_kv, _ = lsm_lookup.fused_lookup_runs(kvs, vals, q_lookup)
    require(torch.equal(~active, (got_kv >> 1) == q_lookup), "lookup footprint replay differs")
    log(f"  lookup footprint: {probes} probes and checks, {read} distinct elements read of {total}")
    row("fused_lookup", "src/repro_torch/csrc/fused_lookup.cu", "src/repro/kernels/lsm_lookup.py:179",
        ms, plain, None, 12 * nq + 4 * read, probes)
    return rows


def profile_insert(torch, d, keys, vals):
    """One more insert call under torch.profiler: wall time, device busy
    time (the sum of kernel times on the one stream) and the top kernels."""
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        d = d.insert(keys, vals)
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6
    kernels = [e for e in prof.key_averages() if e.device_type.name == "CUDA"]
    busy_us = sum(e.self_device_time_total for e in kernels)
    top = sorted(kernels, key=lambda e: -e.self_device_time_total)[:5]
    log(f"phase 5 profile: insert of {keys.shape[0]} lanes, wall {wall_us / 1e3:.2f} ms, device busy "
        f"{busy_us / 1e3:.2f} ms, idle share {1 - busy_us / wall_us:.3f}; top kernels: "
        + "; ".join(f"{e.key[:60]} {e.self_device_time_total / 1e3:.2f} ms x{e.count}" for e in top))
    return d


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
    from repro_torch.kernels import _build, lsm_lookup, merge_path

    t_all = time.perf_counter()
    device = torch.device("cuda")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60).stdout.strip().splitlines()[0]
    card = f"{torch.cuda.get_device_name(0)}, power limit {smi.split(',')[-1].strip()}"
    log(smi)
    log(f"phase 1 device: {torch.cuda.get_device_name(0)}; torch {torch.__version__}, CUDA {torch.version.cuda}")

    kernels = {"merge_cascade": merge_path.KERNEL, "bound": lsm_lookup.BOUND_KERNEL,
               "fused_lookup": lsm_lookup.LOOKUP_KERNEL}
    t0 = time.perf_counter()
    _build.build_all(list(kernels.values()))
    log(f"phase 2 build: {len(kernels)} kernels, {time.perf_counter() - t0:.2f} s")
    for name, k in kernels.items():
        regs = [ln.strip() for ln in k.build_log.splitlines() if "registers" in ln]
        log(f"  {name}: {k.library.name} {regs}")

    rng = np.random.default_rng(args.seed)
    t0 = time.perf_counter()
    errs, cases = check_kernels(torch, device, rng)
    require(all(e == 0 for e in errs.values()), f"kernel differs from its plain version: {errs}")
    log(f"phase 3 kernels vs plain: {cases} cases, exact (max_abs_err {errs}), {time.perf_counter() - t0:.2f} s")

    for k in kernels.values():
        k.launches = 0
    t0 = time.perf_counter()
    d, rates, q_lookup = drive_main_path(
        torch, device, args.seed, log2_n=27, b=1 << 16, lanes=1 << 20, n_lookups=1 << 20, n_windows=1 << 14, reps=5)
    launches = {name: k.launches for name, k in kernels.items()}
    require(all(v > 0 for v in launches.values()), f"a kernel did not run on the main path: {launches}")
    log(f"phase 4 main path: {time.perf_counter() - t0:.2f} s, launches {launches}")

    t0 = time.perf_counter()
    k1 = dev_tensor(torch, rng.integers(0, MAX_USER_KEY - 1022, 1 << 14).astype(np.int32), device)
    rows = kernel_rows(torch, d, q_lookup, k1, errs, launches)
    keys = dev_tensor(torch, rng.integers(0, MAX_USER_KEY + 1, 1 << 20).astype(np.int32), device)
    d = profile_insert(torch, d, keys, keys % 1009)
    log(f"phase 5 kernel timing: {time.perf_counter() - t0:.2f} s")
    log(f"rates ({card}): insert {rates['insert_M_elem_per_s']:.3f} M elem/s, "
        f"lookup {rates['lookup_M_q_per_s']:.3f} M q/s, count {rates['count_M_q_per_s']:.4f} M q/s, "
        f"range {rates['range_M_q_per_s']:.4f} M q/s, cleanup {rates['cleanup_s'] * 1e3:.1f} ms, "
        f"maintain(7b) {rates['maintain_s'] * 1e3:.1f} ms, size {rates['size_s'] * 1e3:.1f} ms")
    log(f"peak device memory {torch.cuda.max_memory_allocated() / 2**30:.2f} GiB; total {time.perf_counter() - t_all:.1f} s")
    log(smi)
    log(json.dumps({"kernels": rows}))
    log(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                           "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
