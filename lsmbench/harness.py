"""Find a cell's parts by name.

A cell of BENCHMARK.json names a configuration and a traffic mix. Each part
lives in a file of its own, found by name, so a later cell adds files and
edits none:

* `configs/<config>.json`: the deployment's sizes and settings; its
  `"system"` names the adapter that builds and drives the system under
  test, `systems/<system>.py` (a `make(config, devices)` function).
* `traffic/<traffic>.json`: the mix's parameters; its `"driver"` names the
  loop that runs the cell, `drivers/<driver>.py` (`run_cell` and
  `verdict`), and its `"generator"` names the module that makes every input
  from the seed, `generators/<generator>.py` (a `make(config, traffic,
  seed, device)` function).
* `metrics/<metric>.py`: one metric's reader, a `read(run)` function that
  returns a number, or None where the run has nothing for it to read.

A per-layer metric whose `source` is `program_span` or `program_counter`
reads the program's own spans or counters; a cell that reports one has
`program_trace` set, and only its traced runs turn them on
(progtrace.Tracer).

Every lookup searches the cell's `roots` in order (by default this folder
alone), so a test can add a part in a folder of its own.
"""

from __future__ import annotations

import hashlib
import importlib.util
import json
from pathlib import Path

BENCH = Path(__file__).resolve().parent
PROGRAM_SOURCES = ("program_span", "program_counter")


def mix(*parts) -> int:
    """A 63-bit seed from any tuple of ints and strings."""
    digest = hashlib.blake2b(repr(parts).encode(), digest_size=8).digest()
    return int.from_bytes(digest, "little") >> 1


def _find(kind: str, name: str, suffix: str, roots) -> Path:
    for root in roots:
        path = Path(root) / kind / f"{name}{suffix}"
        if path.is_file():
            return path
    raise FileNotFoundError(f"nothing named {name!r} in {kind}/ of {[str(r) for r in roots]}")


def load_json(kind: str, name: str, roots=(BENCH,)) -> dict:
    return json.loads(_find(kind, name, ".json", roots).read_text())


_LOADED = {}


def load_module(kind: str, name: str, roots=(BENCH,)):
    """`<kind>/<name>.py` of the first root that has it, loaded once per process."""
    path = _find(kind, name, ".py", roots)
    if path not in _LOADED:
        spec = importlib.util.spec_from_file_location(f"lsmbench_{kind}_{name.replace('.', '_').replace('-', '_')}",
                                                      path)
        module = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(module)
        _LOADED[path] = module
    return _LOADED[path]


def load_metric(name: str, roots=(BENCH,)):
    """The `read(run)` function of `metrics/<name>.py`."""
    return load_module("metrics", name, roots).read


def load_cell(bench: dict, name: str, roots=(BENCH,)) -> dict:
    """{"name", "chips", "config", "traffic", "roots", "program_trace"} of a
    cell of BENCHMARK.json."""
    spec = {w["name"]: w for w in bench["workloads"]}[name]
    return {"name": name, "chips": spec["chips"], "roots": tuple(roots),
            "config": load_json("configs", spec["config"], roots),
            "traffic": load_json("traffic", spec["traffic"], roots),
            "program_trace": any(m["source"] in PROGRAM_SOURCES for m in cell_metrics(bench, name, True))}


def driver(cell: dict):
    """The module that runs this cell: `drivers/<traffic's driver>.py`."""
    return load_module("drivers", cell["traffic"]["driver"], cell.get("roots", (BENCH,)))


def cell_metrics(bench: dict, cell: str, trace: bool):
    """The BENCHMARK.json entries this cell reports in a run of this kind."""
    entries = bench["per_layer"] if trace else bench["end_to_end"]
    return [m for m in entries if cell in m.get("workloads", [cell])]
