"""LSM-backed paged-KV serving demo on an NVIDIA card with PyTorch: the
paper's dictionary doing real work inside a decode loop.

A tiny LM serves a stream of requests. The KV pool is paged; the logical->
physical page index is the GPU-LSM dictionary behind the unified
`repro_torch.api.Dictionary` facade:
  * prefill admits pages (batch insert),
  * decode allocates a page every PAGE_SIZE tokens,
  * finished sequences are evicted (tombstone batch),
  * COUNT/RANGE audit live pages per sequence (ordered queries — the thing a
    hash-table index cannot do),
  * periodic CLEANUP compacts the index after churn.

It prints what examples/dictionary_serving.py prints. The model's
parameters are random, from a generator seeded 0 on the device, so its
tokens are not the JAX example's; no printed line depends on a token.

  python examples/torch_dictionary_serving.py                                # on the card
  PYTHONPATH=src python examples/torch_dictionary_serving.py --device cpu    # plain PyTorch versions

Multi-device variant (`--sharded`): the same facade calls, but the page
index is the range-partitioned LSM over `--shards N` shards
(`Dictionary.create("lsm_sharded", ...)` is the only line that changes).
By default every visible card holds one shard; a device with an index (or
the CPU) holds all N of them, run one after another:

  python examples/torch_dictionary_serving.py --sharded                      # a shard per card
  python examples/torch_dictionary_serving.py --sharded --shards 4 --device cuda:0

Continuous-batching variant (`--server`): many tenants' op streams
multiplexed onto ONE shared dictionary by `repro_torch.serve.DictionaryServer`
— mixed decode-trickle / prefill-burst / eviction-storm traffic coalesces
into per-kind device steps, with live write-buffer occupancy, flush-cost,
and coalescing stats reported as the trace drains:

  python examples/torch_dictionary_serving.py --server
"""

import argparse
import functools

import numpy as np
import torch

from repro_torch.configs.base import get_smoke_config
from repro_torch.models import model_zoo as zoo
from repro_torch.serve.kvcache import (
    PageTableConfig,
    pt_allocate,
    pt_compact,
    pt_evict,
    pt_init,
    pt_lookup,
    pt_seq_page_count,
)

PAGE_SIZE = 8
BATCH = 4


@torch.no_grad()
def decode_variant(dev):
    """Prefill, decode and page churn of three waves over the standalone
    `pt_*` page table."""
    cfg = get_smoke_config("qwen2-7b")
    params = zoo.init_params(cfg, seed=0, device=dev)
    pt_cfg = PageTableConfig(num_pages=256, update_batch=16, num_levels=8, device=dev)
    table = pt_init(pt_cfg)
    rng = np.random.default_rng(0)

    decode = functools.partial(zoo.apply_decode, cfg)

    print(f"serving {cfg.name}: page_size={PAGE_SIZE} pool={pt_cfg.num_pages} pages")
    for wave in range(3):
        seq_ids = np.arange(BATCH) + wave * BATCH
        prompt_len = 16
        prompt = torch.as_tensor(rng.integers(0, cfg.vocab_size, (BATCH, prompt_len)), device=dev)

        # --- prefill: admit prompt pages into the LSM page index ------------
        n_pages = prompt_len // PAGE_SIZE
        seqs, pages = [], []
        for s in seq_ids:
            for p in range(n_pages):
                seqs.append(s)
                pages.append(p)
        b = pt_cfg.update_batch
        valid = np.arange(b) < len(seqs)
        table, slots = pt_allocate(
            pt_cfg, table,
            np.resize(np.array(seqs, np.int32), b),
            np.resize(np.array(pages, np.int32), b),
            valid,
        )
        logits_pre, caches = zoo.apply_prefill(
            cfg, params, {"tokens": prompt}, cache_pad_to=prompt_len + 32
        )

        # --- decode loop: new page every PAGE_SIZE tokens --------------------
        token = torch.argmax(logits_pre, dim=-1)[:, None]
        cache_len = prompt_len
        for t in range(16):
            logits, caches = decode(params, token, caches, cache_len)
            token = torch.argmax(logits, dim=-1)[:, None]
            cache_len = cache_len + 1
            if (prompt_len + t + 1) % PAGE_SIZE == 0:
                page_idx = (prompt_len + t + 1) // PAGE_SIZE - 1
                valid = np.arange(b) < BATCH
                table, _ = pt_allocate(
                    pt_cfg, table,
                    np.resize(seq_ids.astype(np.int32), b),
                    np.full((b,), page_idx, np.int32),
                    valid,
                )
        counts, ok = pt_seq_page_count(pt_cfg, table, seq_ids.astype(np.int32), max_candidates=256)
        f, s = pt_lookup(pt_cfg, table, [seq_ids[0]], [0])
        print(f"wave {wave}: live pages/seq={counts.tolist()} "
              f"(exact={bool(ok.all())}) seq{seq_ids[0]}/page0 -> slot {int(s[0])} "
              f"free={int(table.free_count)}")

        # --- retire the previous wave (tombstone its pages) ------------------
        if wave > 0:
            old = np.arange(BATCH) + (wave - 1) * BATCH
            seqs, pages = [], []
            for s_ in old:
                for p in range(4):
                    seqs.append(s_)
                    pages.append(p)
            valid = np.arange(b) < len(seqs)
            table = pt_evict(
                pt_cfg, table,
                np.resize(np.array(seqs, np.int32), b),
                np.resize(np.array(pages, np.int32), b),
                valid,
            )
            print(f"  evicted wave {wave-1}: free={int(table.free_count)} "
                  f"(LSM r={int(table.index.state.r)} batches incl. tombstones, "
                  f"{int(table.index.size())} live)")

    table = pt_compact(pt_cfg, table)
    print(f"after CLEANUP: LSM r={int(table.index.state.r)} (tombstones purged)")


def sharded_variant(dev, shards=None):
    """The page-index workload on the sharded backend: one Dictionary.create
    change, identical insert/lookup/count/evict/cleanup calls."""
    from repro_torch.api import Dictionary, QueryPlan

    d = Dictionary.create("lsm_sharded", batch_size=16, num_levels=8,
                          num_shards=shards, device=dev)
    print(f"sharded page index: {d.num_shards} shard(s), "
          f"batch={d.batch_size}, capacity={d.capacity}")
    rng = np.random.default_rng(0)

    # admit three waves of pages, evict the middle one
    keys = [rng.choice(1 << 20, 16, replace=False).astype(np.int32) for _ in range(3)]
    for wave, k in enumerate(keys):
        d = d.insert(k, k % 997)
        print(f"  wave {wave}: size={int(d.size())}")
    d = d.delete(keys[1])
    d = d.cleanup()
    found, _ = d.lookup(np.concatenate([keys[0], keys[1]]))
    counts, ok = d.count(np.asarray([0]), np.asarray([(1 << 20) - 1]),
                         QueryPlan(max_candidates=4096))
    print(f"  after evict+cleanup: size={int(d.size())} "
          f"wave0-hits={int(found[:16].sum())}/16 "
          f"wave1-hits={int(found[16:].sum())}/16 "
          f"count[0,2^20)={int(counts[0])} exact={bool(ok[0])}")


def server_variant(dev):
    """Mixed-tenant traffic through the continuous-batching server: live
    occupancy / flush-cost / coalescing reporting while the trace drains."""
    from repro_torch.serve import DictionaryServer, ServerConfig, make_trace
    from repro_torch.serve.kvcache import ServerPageTable

    srv = DictionaryServer(ServerConfig(
        backend="lsm", batch_size=64, num_levels=10,
        flush_at_fraction=0.75, maintenance_budget=128, device=dev))
    tenants, trace = make_trace(
        "mixed", num_tenants=6, key_space=512, events=48, seed=0)
    for t in tenants:
        srv.register_tenant(t, key_space=512)
    # The KV page table rides along as just another tenant of the same
    # shared dictionary.
    pt = ServerPageTable(srv, num_pages=64, num_seqs=8)
    pt.allocate([0, 0, 1], [0, 1, 0])

    print(f"server: {len(tenants)} traffic tenants + page table over one "
          f"'{srv.config.backend}' dictionary (b={srv.config.batch_size})")
    tickets, window = [], 12
    for i, op in enumerate(trace):
        if op.kind == "update":
            tickets.append(srv.submit_update(op.tenant, op.keys, op.values,
                                             op.is_delete))
        elif op.kind == "lookup":
            tickets.append(srv.submit_lookup(op.tenant, op.keys))
        elif op.kind == "count":
            tickets.append(srv.submit_count(op.tenant, op.k1, op.k2))
        else:
            tickets.append(srv.submit_range(op.tenant, op.k1, op.k2,
                                            op.max_results))
        if (i + 1) % window == 0 or i == len(trace) - 1:
            srv.step()
            occ = srv.occupancy()
            print(f"  after {i + 1:3d} ops: pending={srv.pending_estimate()} "
                  f"(device: {int(occ.pending)}) resident={int(occ.resident)} "
                  f"debt={int(occ.debt)} "
                  f"flush_cost={int(srv.dictionary.flush_cost_estimate())} "
                  f"flushes={srv.stats.flushes}")
    stats = srv.drain()
    n_found = sum(
        int(np.asarray(t.result()[0]).sum())
        for t in tickets if t.kind == "lookup")
    counts, _ = pt.seq_page_count([0, 1]).result()
    print(f"drained: {stats.submitted} ops -> {stats.device_steps} device "
          f"steps ({stats.ops_per_device_step:.1f} ops/step), "
          f"flushes={stats.flushes} maintains={stats.maintains}")
    print(f"lookup hits across tenants: {n_found}; page table intact: "
          f"pages/seq={np.asarray(counts).tolist()} free={pt.free_count}")


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    variant = ap.add_mutually_exclusive_group()
    variant.add_argument("--sharded", action="store_true", help="the page index on the sharded LSM")
    variant.add_argument("--server", action="store_true", help="mixed tenants through the DictionaryServer")
    ap.add_argument("--shards", type=int, default=None,
                    help="--sharded: shard count (default: every visible card, or 1 on a device with an index)")
    ap.add_argument("--device", default="cuda", help="where the model and the index live (default: the card)")
    args = ap.parse_args(argv)
    if args.sharded:
        sharded_variant(args.device, args.shards)
    elif args.server:
        server_variant(args.device)
    else:
        decode_variant(args.device)


if __name__ == "__main__":
    main()
