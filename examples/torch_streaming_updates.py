"""Streaming dynamic-dictionary workload (paper §5 protocol, end to end), on
an NVIDIA card with PyTorch.

A moving-objects index (the paper's motivating use case): objects stream
position updates (insert = overwrite), expire (delete), and a dashboard runs
COUNT/RANGE window queries — all through the unified `Dictionary` facade.
Garbage collection is two-tier: every update piggybacks a *budgeted*
incremental compaction (`maintenance_budget=` -> `maintain`, DESIGN.md §11)
that runs only when the cheap levels have tracked compaction debt, and a
stop-the-world `cleanup()` remains as the fallback policy for when stale
elements still exceed a threshold (deep-level garbage the budget can't
reach). It prints what examples/streaming_updates.py prints; the rate line
names the device.

  python examples/torch_streaming_updates.py                                # on the card
  PYTHONPATH=src python examples/torch_streaming_updates.py --device cpu    # plain PyTorch versions
"""

import argparse
import time

import numpy as np
import torch

from repro_torch.api import Dictionary, QueryPlan

B = 4096
GRID = 1 << 20          # 1M cell ids (e.g. quantized 2D positions)


def device_name(dev: torch.device) -> str:
    return torch.cuda.get_device_name(dev) if dev.type == "cuda" else dev.type.upper()


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--device", default="cuda", help="where the dictionary lives (default: the card)")
    args = ap.parse_args(argv)

    # maintenance_budget: every update piggybacks maintain(3B) behind a
    # debt check — levels 0..1 (capacity 3B) stay compacted without ever
    # paying a stop-the-world cleanup on the update path.
    d = Dictionary.create("lsm", batch_size=B, num_levels=8,
                          maintenance_budget=3 * B, device=args.device)
    dev = d.device
    plan = QueryPlan(max_candidates=1 << 14)
    rng = np.random.default_rng(0)

    t0 = time.perf_counter()
    n_updates = 0
    for step in range(24):
        # 75% position updates, 25% expirations, in one mixed RAGGED batch —
        # objects report at their own cadence, so sizes are rarely b-aligned;
        # the facade's write buffer coalesces the trickle (no batch slot is
        # consumed until b elements are pending).
        n = int(rng.integers(B // 2, B + B // 2))
        keys = rng.integers(0, GRID, n).astype(np.int32)
        vals = rng.integers(0, 1 << 20, n).astype(np.int32)
        dels = rng.random(n) < 0.25
        d = d.update(torch.from_numpy(keys).to(dev), torch.from_numpy(vals).to(dev),
                     is_delete=torch.from_numpy(dels).to(dev))
        n_updates += n

        if step % 6 == 5:
            # dashboard: occupancy of 4 map windows
            k1 = torch.tensor([0, GRID // 4, GRID // 2, 3 * GRID // 4], dtype=torch.int32, device=dev)
            k2 = k1 + GRID // 4 - 1
            counts, ok = d.count(k1, k2, plan)
            staged = int(d.pending())
            resident = int(d.state.r) * B + staged
            live = int(d.size())
            stale_frac = 1 - live / max(resident, 1)
            debt = d.state.lvl_debt.tolist()
            print(f"step {step:2d}: windows={counts.tolist()} "
                  f"resident={resident} (staged={staged}) "
                  f"live={live} stale={stale_frac:.0%} debt={debt}")
            # incremental tier: one bounded maintain sweep of the deepest
            # affordable prefix (levels 0..2 at 7B) — latency O(budget), not
            # O(capacity), so it is safe to run on every dashboard tick.
            d = d.maintain(7 * B)
            # fallback tier: full cleanup only when deep-level garbage the
            # budget can't reach still dominates (>40% stale)
            live = int(d.size())
            resident = int(d.state.r) * B + int(d.pending())
            if 1 - live / max(resident, 1) > 0.4:
                d = d.cleanup()
                print(f"         cleanup -> r={int(d.state.r)} "
                      f"({int(d.state.r) * B} resident)")

    dt = time.perf_counter() - t0
    print(f"\n{n_updates} streamed updates in {dt:.1f}s "
          f"({n_updates / dt / 1e6:.2f} M updates/s on {device_name(dev)}; "
          f"K40c paper rate: 225 M/s)")
    keys, vals, cnt, ok = d.range(1000, 2000, QueryPlan(max_candidates=1 << 12, max_results=64))
    print(f"RANGE[1000,2000]: {int(cnt[0])} objects, first few keys "
          f"{keys[0][:min(5, int(cnt[0]))].tolist()}")


if __name__ == "__main__":
    main()
