"""Quickstart: the GPU-LSM dictionary on an NVIDIA card with PyTorch.

One `Dictionary` facade covers all three of the paper's data structures;
every op runs on the card's tensors (the LSM's merges, lookups and bound
searches are hand-written CUDA kernels). It prints what
examples/quickstart.py prints, op for op.

  python examples/torch_quickstart.py                                # on the card
  PYTHONPATH=src python examples/torch_quickstart.py --device cpu    # plain PyTorch versions
"""

import argparse

import numpy as np
import torch

from repro_torch.api import CapabilityError, Dictionary, QueryPlan


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--device", default="cuda", help="where the dictionaries live (default: the card)")
    dev = ap.parse_args(argv).device

    # LSM with ~1M-element capacity. batch_size is the paper's b; updates of
    # ANY length are accepted (padded / split into b-sized encoded batches).
    d = Dictionary.create("lsm", batch_size=1024, capacity=1 << 20, device=dev)
    print(d)

    # 1) inserts — any length, not just multiples of b
    keys = torch.arange(5000, device=dev)
    d = d.insert(keys, keys * 10)
    print(f"inserted 5000; live size={int(d.size())} "
          f"(resident batches r={int(d.state.r)}, bits: {int(d.state.r):b})")

    # 2) point lookups — most-recent value wins
    found, vals = d.lookup(torch.tensor([0, 1500, 4095, 99999], device=dev))
    print("lookup [0, 1500, 4095, 99999]:", found.tolist(), vals.tolist())

    # 3) overwrite: re-insert keys 0..1023 with a new value
    d = d.insert(torch.arange(1024, device=dev), torch.full((1024,), 777, device=dev))
    _, vals = d.lookup(torch.tensor([0], device=dev))
    print("after overwrite, key 0 ->", int(vals[0]))

    # 4) delete (tombstones)
    d = d.delete(torch.arange(1024, device=dev) + 1024)
    found, _ = d.lookup(torch.tensor([1500], device=dev))
    print("key 1500 after delete:", bool(found[0]))

    # 5) ordered queries (hash tables can't do this). QueryPlan auto-sizes
    #    the candidate tile; pass an explicit plan to override.
    counts, ok = d.count(torch.tensor([0, 2048], device=dev), torch.tensor([4999, 3000], device=dev))
    print(f"COUNT[0,4999]={int(counts[0])}  COUNT[2048,3000]={int(counts[1])} "
          f"(exact={bool(ok.all())})")
    rkeys, rvals, cnt, ok = d.range(2040, 2050, QueryPlan(max_results=16))
    print("RANGE[2040,2050] ->", rkeys[0][: int(cnt[0])].tolist())

    # 6) cleanup: purge tombstones + duplicates, shrink levels
    before = int(d.size())
    d = d.cleanup()
    print(f"cleanup: {before} live elements packed into r={int(d.state.r)} batches")

    # 7) same API, different backend: the sorted-array baseline. The auto
    #    plan truncates this all-keys query (ok=False); an explicit QueryPlan
    #    restores exactness — no silent wrong answers.
    sa = Dictionary.create("sorted_array", capacity=1 << 13, device=dev)
    sa = sa.insert(torch.arange(5000, device=dev), torch.arange(5000, device=dev) * 10)
    counts, ok = sa.count(0, 4999)
    print(f"sorted_array COUNT[0,4999]={int(counts[0])} (auto plan, exact={bool(ok[0])})")
    counts, ok = sa.count(0, 4999, QueryPlan(max_candidates=1 << 13))
    print(f"sorted_array COUNT[0,4999]={int(counts[0])} (explicit plan, exact={bool(ok[0])})")

    # 8) cuckoo: O(1) lookups, but capability flags reject ordered queries
    ck = Dictionary.create("cuckoo", capacity=4096, device=dev)
    ck = ck.bulk_build(np.arange(4000), np.arange(4000) % 97)
    found, _ = ck.lookup(torch.tensor([17, 4001], device=dev))
    print("cuckoo lookup [17, 4001]:", found.tolist())
    try:
        ck.count(0, 100)
    except CapabilityError as e:
        print("cuckoo COUNT ->", e)


if __name__ == "__main__":
    main()
