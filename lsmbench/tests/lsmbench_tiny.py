"""Shared by the benchmark's CPU tests: the cells of BENCHMARK.json at a size
the CPU runs in well under a second (a 16-bit key space, b = 64, 1024 live
keys; each driver cuts its own mix), and the path set-up that
`lsmbench/run.py` does."""

import json
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[2]
for p in (str(ROOT / "src"), str(ROOT)):
    if p not in sys.path:
        sys.path.insert(0, p)

from lsmbench import harness  # noqa: E402

BENCH = json.loads((ROOT / "BENCHMARK.json").read_text())
CELLS = [w["name"] for w in BENCH["workloads"]]


def tiny(name: str, roots=(harness.BENCH,), traffic: str | None = None) -> dict:
    """The cell at the tiny size, its parts found in `roots`; with `traffic`,
    under that mix instead of its own. The config is cut here; the mix by
    its driver's `tiny(cell)`."""
    cell = harness.load_cell(BENCH, name, roots)
    if traffic:
        cell["traffic"] = harness.load_json("traffic", traffic, roots)
    cell["config"].update(key_bits=16, batch_size=64, capacity=64 * 32, live_keys=1024)
    return harness.driver(cell).tiny(cell)


def run(cell: dict, seconds: float = 0.3, seed: int = 2**31 + 123, device: str = "cpu", **kw):
    """A whole run of a cell (tiny()) -> (run, correct, checks)."""
    driver = harness.driver(cell)
    r = driver.run_cell(cell, devices=[device], seed=seed, seconds=seconds, **{"trace": False, **kw})
    return (r, *driver.verdict(r))
