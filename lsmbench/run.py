#!/usr/bin/env python3
"""The port's benchmark: one cell of BENCHMARK.json, run on one card.

    python3 lsmbench/run.py --workload lsm-n27-b22.update --seed 7 --seconds 10 --trace 0

It finds the cell's parts by the names in BENCHMARK.json (lsmbench/harness.py
says where): its configuration and the system adapter that it names, its
traffic mix and the driver and generator that it names, and each metric's
reader. It runs the cell on as many cards as the cell asks for and prints one
JSON object as the last line of standard output: `correct`, `attempted`, `failed`, `metrics` (with `--trace 0` the
cell's end-to-end metrics, with `--trace 1` its per-layer metrics), `device`,
with `--trace 1` a `breakdown`, and last `checks`, each number compared with
its limit. The same numbers end standard error; before them, in a traced
run that turned the program's spans on, a line per program span and the
idle gaps inside calls by span (lsmbench/progtrace.py). Without a CUDA device, or
with fewer than the cell asks for, it exits 3 and prints no result; if `jax`,
`jaxlib`, `flax` or the JAX package `repro` is loaded once the window has
closed, it exits 4 and prints no result.

Set-up is timed from the top of this file to the first timed call. The port's
kernels build into `build/repro_torch/` inside the checkout on the first run
and load from there afterwards.
"""

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
BENCH = ROOT / "lsmbench"
FORBIDDEN = ("jax", "jaxlib", "flax", "repro")


def forbidden_modules():
    """Loaded modules whose top-level name is one of FORBIDDEN, compared whole."""
    return sorted({name.split(".")[0] for name in sys.modules} & set(FORBIDDEN))


def _set_paths() -> None:
    # The script's own folder would shadow standard modules by its files' names.
    sys.path[:] = [p for p in sys.path if Path(p or ".").resolve() != BENCH]
    for p in (str(ROOT), str(ROOT / "src")):
        if p not in sys.path:
            sys.path.insert(0, p)


def log(msg: str) -> None:
    print(msg, file=sys.stderr, flush=True)


def power_limit() -> str:
    try:
        out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                             capture_output=True, text=True, timeout=20)
        return out.stdout.strip().splitlines()[0] if out.stdout.strip() else "not read"
    except (OSError, subprocess.TimeoutExpired):
        return "not read"


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    bench = json.loads((ROOT / "BENCHMARK.json").read_text())
    cells = {w["name"]: w for w in bench["workloads"]}
    if args.workload not in cells:
        log(f"no workload {args.workload!r} in BENCHMARK.json; cells: {sorted(cells)}")
        return 2
    spec = cells[args.workload]

    _set_paths()
    import torch

    if not torch.cuda.is_available() or torch.cuda.device_count() < spec["chips"]:
        count = torch.cuda.device_count() if torch.cuda.is_available() else 0
        log(f"{args.workload} needs {spec['chips']} CUDA device(s); {count} available")
        return 3
    torch.set_num_threads(2)

    from lsmbench import harness

    trace = bool(args.trace)
    entries = harness.cell_metrics(bench, args.workload, trace)
    readers = {m["name"]: harness.load_metric(m["name"]) for m in entries}
    cell = harness.load_cell(bench, args.workload)
    driver = harness.driver(cell)
    devices = [f"cuda:{i}" for i in range(spec["chips"])]
    run = driver.run_cell(cell, devices=devices, seed=args.seed, seconds=args.seconds, trace=trace,
                          t_start=T_START, log=log)
    found = forbidden_modules()
    if found:
        log(f"forbidden modules loaded in the benchmark's process: {found}")
        return 4

    metrics = {}
    for m in entries:
        value = readers[m["name"]](run)
        if value is not None:
            metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    device = {
        "platform": "gpu",
        "kind": torch.cuda.get_device_name(0),
        "count": spec["chips"],
        "memory_peak_bytes": run.memory_peak,
    }
    result = {"correct": None, "attempted": run.attempted, "failed": run.failed,
              "metrics": metrics, "device": device}
    if trace:
        device["busy_s"] = run.trace["busy_s"]
        device["window_s"] = run.trace["window_s"]
        result["breakdown"] = {"device_ops": run.trace["device_ops"], "idle_gaps": run.trace["idle_gaps"]}
    correct, checks = driver.verdict(run)
    result["correct"] = correct
    result["checks"] = checks

    log(f"{args.workload} seed {args.seed}: {run.summary()}; card {power_limit()}")
    if run.program is not None:
        from lsmbench import progtrace

        for line in progtrace.lines(run.program):
            log(line)
        log(f"program gaps in calls by span: {run.program['program_gaps']}")
    for m in harness.cell_metrics(bench, args.workload, False):
        log(f"  {m['name']} {harness.load_metric(m['name'])(run)} {m['unit']}")
    for name, c in checks.items():
        log(f"check {name} {c['value']} limit {c['limit']}")
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
