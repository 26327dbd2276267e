"""Design sweep of the lookup kernel (`csrc/fused_lookup.cu`) on one card.

    PYTHONPATH=src python3 -m repro_torch.kernels.lookup_sweep [--out FILE]

Compiles the kernel's source once per variant, with -D overrides of its
design constants (runs searched at once by a thread, threads a block, and the
query order: the bucket threshold set to 0 or above any query count), into
`build/lookup_sweep/`, and times each variant through its C entry on
LSM-shaped and sorted-array-shaped states, at several query counts and at
1024 or 2048 resident threads an SM (the persistent grid the C entry is
given). Each time is the mean of a replayed CUDA graph of 20 launches, beside
an exact check against `lsm_lookup.fused_lookup_plain`. Prints one line per
time and, with --out, writes them all as JSON. The main path never imports
this module.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import subprocess
import time

import torch

from repro_torch.core import semantics as sem
from repro_torch.kernels import _build, lsm_lookup

MAX_USER_KEY = sem.MAX_USER_KEY
# Variant -> -D overrides; each is built twice, its queries always in bucket
# order ("b") and always in their own order ("o").
VARIANTS = {
    "g1_t1024": {"LOOKUP_GROUP": 1, "LOOKUP_THREADS": 1024},  # one run at a time, PR 15's first design
    "g1_t512": {"LOOKUP_GROUP": 1},
    "g2_t512": {},  # the kernel as built
    "g3_t512": {"LOOKUP_GROUP": 3},
    "g4_t512": {"LOOKUP_GROUP": 4},
    "g2_t256": {"LOOKUP_THREADS": 256},
    "g2_t1024": {"LOOKUP_THREADS": 1024},
}
ORDERS = {"b": 0, "o": 1 << 30}  # LOOKUP_BUCKET_MIN
STATES = ("post", "pre", "rand", "sa", "tie")
QUERY_COUNTS = (1 << 17, 1 << 18, 1 << 19, 1 << 20)
THREADS_PER_SM = (1024, 2048)


def _sorted_kv(keys, live):
    keys, order = torch.sort(keys)
    return (keys << 1) | live[order].to(torch.int32)


def make_state(kind, device, gen, *, log2_b=16, levels=12, log2_sa=27):
    """Runs newest first (kv, val) and a pool of present keys.

    post: an LSM of 2^log2_b-slot batches after cleanup, every level a slice
      of one key range (a query reaches one run);
    pre: the deepest level full of random live keys, a level of deletes of
      some of them and a level re-inserting half of those (overlapping runs);
    rand: every level and the buffer full of random keys, 30% tombstones;
    sa: one run of 2^log2_sa slots, half of them unique live keys;
    tie: 13 runs of 0 to 2^20 elements over 40 keys, 40% tombstones.
    """
    def randint(hi, n):
        return torch.randint(0, hi, (n,), generator=gen, device=device, dtype=torch.int32)

    def values(n):
        return torch.randint(-(1 << 20), 1 << 20, (n,), generator=gen, device=device, dtype=torch.int32)

    if kind == "sa":
        n = 1 << log2_sa
        keys = torch.unique(randint(MAX_USER_KEY + 1, n // 2 + n // 32))[: n // 2]
        kv = torch.full((n,), sem.PLACEBO_KV, dtype=torch.int32, device=device)
        kv[: keys.numel()] = (keys << 1) | 1
        return [kv], [values(n)], keys
    if kind == "tie":
        lengths = [0, 1, 3, 4097, 5000, 1 << 16, 3 << 16, 1 << 20] + [1000] * 5
        kvs = [_sorted_kv(randint(40, n), torch.rand(n, generator=gen, device=device) > 0.4) for n in lengths]
        return kvs, [values(n) for n in lengths], torch.arange(-2, 45, dtype=torch.int32, device=device)
    b = 1 << log2_b
    arena = torch.full((b << levels,), sem.PLACEBO_KV, dtype=torch.int32, device=device)
    kvs = [arena[:b]] + [arena[b << i: b << (i + 1)] for i in range(levels)]
    if kind == "post":
        live = torch.unique(randint(MAX_USER_KEY + 1, (b << levels) // 2))
        r = -(-live.numel() // b)
        for i in range(levels):
            if (r >> i) & 1:
                start = b * (r & ((1 << i) - 1))
                part = live[start: start + (b << i)]
                kvs[i + 1][: part.numel()] = (part << 1) | 1
        pool = live
    elif kind == "pre":
        keys = randint(MAX_USER_KEY + 1, b << (levels - 1))
        kvs[levels].copy_(_sorted_kv(keys, torch.ones_like(keys, dtype=torch.bool)))
        dels = torch.unique(keys[: b << 5])[: b << 4]
        dels = dels[torch.randperm(dels.numel(), generator=gen, device=device)]
        kvs[5][: dels.numel()] = _sorted_kv(dels, torch.zeros_like(dels, dtype=torch.bool))
        again = dels[: b << 3]
        kvs[4][: again.numel()] = _sorted_kv(again, torch.ones_like(again, dtype=torch.bool))
        pool = keys
    elif kind == "rand":
        for kv in kvs:
            kv.copy_(_sorted_kv(randint(MAX_USER_KEY + 1, kv.numel()),
                                torch.rand(kv.numel(), generator=gen, device=device) > 0.3))
        pool = arena >> 1
    else:
        raise ValueError(f"unknown state {kind!r}")
    return kvs, [values(kv.numel()) for kv in kvs], pool


def make_queries(pool, nq, gen):
    """nq queries in random order: half drawn from `pool`, half uniform keys,
    and the edge keys."""
    device = pool.device
    edges = torch.tensor([0, MAX_USER_KEY, MAX_USER_KEY + 1, 2**31 - 1], dtype=torch.int32, device=device)
    half = nq // 2
    q = torch.cat([pool[torch.randint(0, pool.numel(), (half,), generator=gen, device=device)],
                   torch.randint(0, MAX_USER_KEY + 1, (nq - half - edges.numel(),), generator=gen, device=device,
                                 dtype=torch.int32), edges])
    return q[torch.randperm(nq, generator=gen, device=device)].contiguous()


def build_variants(variants=VARIANTS, orders=ORDERS):
    """One nvcc per variant and order, all started together -> {name: C entry}."""
    out_dir = _build.BUILD_DIR.parent / "lookup_sweep"
    out_dir.mkdir(parents=True, exist_ok=True)
    procs = []
    for name, defines in variants.items():
        for order, bucket_min in orders.items():
            flags = [f"-D{k}={v}" for k, v in {**defines, "LOOKUP_BUCKET_MIN": bucket_min}.items()]
            lib = out_dir / f"{name}_{order}.so"
            cmd = [_build._nvcc(), *_build.NVCC_FLAGS, *flags, "-o", str(lib), str(lsm_lookup.LOOKUP_KERNEL.source)]
            procs.append((f"{name}_{order}", lib, subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                                                  stderr=subprocess.STDOUT, text=True)))
    entries = {}
    for name, lib, proc in procs:
        log, _ = proc.communicate()
        if proc.returncode:
            raise RuntimeError(f"nvcc failed on variant {name}:\n{log}")
        handle = ctypes.CDLL(str(lib))
        fn = handle.repro_fused_lookup
        fn.argtypes, fn.restype = lsm_lookup.LOOKUP_KERNEL.entries["repro_fused_lookup"], ctypes.c_int
        threads = handle.repro_lookup_threads
        threads.restype = ctypes.c_int
        entries[name] = (fn, threads())
    return entries


def graph_ms(fn, launches=20, reps=5):
    """Mean device time of fn() from a replayed CUDA graph of `launches` calls."""
    stream = torch.cuda.Stream()
    stream.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(stream):
        fn()
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


def sweep(entries, device, seed=0):
    """Every variant at every state, query count and resident threads an SM."""
    sms = torch.cuda.get_device_properties(device).multi_processor_count
    buckets = lsm_lookup.LOOKUP_KERNEL.constant("repro_lookup_buckets")
    rows = []
    for kind in STATES:
        gen = torch.Generator(device=device)
        gen.manual_seed(seed)
        kvs, vals, pool = make_state(kind, device, gen)
        kvp, valp, n = _build.run_pointers(kvs, vals)
        layout, total = lsm_lookup._layout_arg(tuple(n), lsm_lookup.SAMPLE_INTS)
        for nq in QUERY_COUNTS:
            q = make_queries(pool, nq, gen)
            exp = lsm_lookup.fused_lookup_plain(kvs, vals, q)
            out = torch.empty((2, nq), dtype=torch.int32, device=device)
            scratch = torch.empty(2 * nq + total + 2 * buckets, dtype=torch.int32, device=device)
            for (name, (fn, threads)), per_sm in ((e, p) for e in entries.items() for p in THREADS_PER_SM):
                blocks = max(1, min(-(-nq // threads), per_sm // threads * sms))

                def call():
                    err = fn(kvp, valp, n, len(kvs), layout, total, q.data_ptr(), nq, blocks, scratch.data_ptr(),
                             out[0].data_ptr(), out[1].data_ptr(), torch.cuda.current_stream().cuda_stream)
                    if err:
                        raise RuntimeError(f"variant {name} failed with CUDA error {err}")

                out.fill_(-1)
                call()
                exact = torch.equal(out[0], exp[0]) and torch.equal(out[1], exp[1])
                row = dict(state=kind, runs=len(kvs), nq=nq, variant=name, threads_per_sm=per_sm,
                           ms=graph_ms(call), exact=exact)
                rows.append(row)
                print(f"{kind:4s} nq 2^{nq.bit_length() - 1} {name:11s} {per_sm} threads/SM: "
                      f"{row['ms']} ms exact={exact}", flush=True)
        del kvs, vals, pool
        torch.cuda.empty_cache()
    return rows


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--out", help="write the times as JSON to this file")
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("the sweep needs a CUDA device")
    device = torch.device("cuda", 0)
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True).stdout.strip()
    print(card, flush=True)
    t0 = time.time()
    entries = build_variants()
    print(f"built {len(entries)} variants in {time.time() - t0:.1f} s", flush=True)
    rows = sweep(entries, device, args.seed)
    bad = [r for r in rows if not r["exact"]]
    if args.out:
        with open(args.out, "w") as f:
            json.dump(dict(card=card, rows=rows), f)
    if bad:
        raise SystemExit(f"{len(bad)} variant runs differ from the plain version, first {bad[0]}")


if __name__ == "__main__":
    main()
