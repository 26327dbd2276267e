#!/usr/bin/env python3
"""The control and the planted faults, at a cell's own size, on the card.

    python3 lsmbench/control.py --workload lsm-n27-b16.scan --seeds 11 12 13 --seconds 3
    python3 lsmbench/control.py --workload lsm-n27-b22.update --seeds 11 --seconds 3 --fault half_batch
    python3 lsmbench/control.py --workload lsm-n27-b22.update --seeds 11 12 --seconds 3 --program

Without `--fault` or `--program` the system under test is the control: the
reference's dense table with one guarantee broken (`--control`, by default
"stale_overwrite": an overwrite of a present key is lost). With `--fault` it is
the port with that fault planted (lsmbench/faults.py); with `--program` the
port as it is. Each seed runs the whole cell (set-up, a window of
`--seconds`, read-back, the reference's check) and prints one JSON line with
the numbers compared; a control or a fault has to come out not correct. The
benchmark's own runs never run this.
"""

import argparse
import contextlib
import json
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path[:] = [p for p in sys.path if Path(p or ".").resolve() != ROOT / "lsmbench"]
sys.path[:0] = [str(ROOT), str(ROOT / "src")]

from lsmbench import harness  # noqa: E402
from lsmbench.faults import FAULTS, planted  # noqa: E402
from lsmbench.reference.dense import CONTROLS, DenseDictionary  # noqa: E402


class ControlDictionary(DenseDictionary):
    """The reference's table as the system under test, one guarantee broken.
    A table holds nothing stale, so every batch fits and no cleanup comes;
    it counts no bytes."""

    def __init__(self, config: dict, devices, control: str):
        super().__init__(config["key_bits"], devices[0], control=control)

    def fits(self, lanes: int) -> bool:
        return True

    def update(self, keys, values, is_delete) -> int:
        super().update(keys, values, is_delete)
        return 0


def run_one(cell: dict, seed: int, seconds: float, devices, *, control=None, fault=None, log=lambda m: None):
    """One run of `cell` with the system replaced -> (correct, checks, run).
    The control is built by the cell's system module's `control(config,
    devices, name)` where it has one, else it is a ControlDictionary."""
    factory = None
    if control is not None:
        system = harness.load_module("systems", cell["config"]["system"], cell.get("roots", (harness.BENCH,)))
        make = getattr(system, "control", ControlDictionary)
        factory = lambda cfg, devs: make(cfg, devs, control)  # noqa: E731
    driver = harness.driver(cell)
    with planted(fault) if fault else contextlib.nullcontext():
        run = driver.run_cell(cell, devices=devices, seed=seed, seconds=seconds, trace=False,
                              system_factory=factory, log=log)
    correct, checks = driver.verdict(run)
    return correct, checks, run


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    ap.add_argument("--seconds", type=float, default=3.0)
    ap.add_argument("--device", default="cuda:0")
    what = ap.add_mutually_exclusive_group()
    what.add_argument("--control", choices=CONTROLS, default=None)
    what.add_argument("--fault", choices=FAULTS, default=None)
    what.add_argument("--program", action="store_true")
    args = ap.parse_args(argv)
    control = None if (args.fault or args.program) else (args.control or CONTROLS[0])
    cell = harness.load_cell(json.loads((ROOT / "BENCHMARK.json").read_text()), args.workload)
    for seed in args.seeds:
        correct, checks, run = run_one(cell, seed, args.seconds, [args.device], control=control, fault=args.fault)
        print(json.dumps({"workload": args.workload, "seed": seed, "system": control or args.fault or "program",
                          "correct": correct, "rounds": run.rounds, "checked": run.checked,
                          "checks": {k: v["value"] for k, v in checks.items()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
