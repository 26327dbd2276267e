"""BENCHMARK.json against the benchmark's contract, the harness finding a
mix and a metric by name alone, and the import guard."""

import ast
import json
import re
import subprocess
import sys
import textwrap

import pytest
from lsmbench_tiny import BENCH, ROOT, run, tiny

from lsmbench import harness

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")


def test_top_level_keys_and_paths():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs", "workloads", "end_to_end", "per_layer"}
    assert BENCH["paths"] == ["lsmbench"] and BENCH["command"] == ["python3", "lsmbench/run.py"]
    assert 1 <= BENCH["run_seconds"] <= 51 and isinstance(BENCH["run_seconds"], int)
    assert len((ROOT / "BENCHMARK.json").read_bytes()) <= 64 * 1024


def test_names_units_and_keys():
    names = []
    for c in BENCH["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert (ROOT / c["file"]).is_file() and c["file"] == f"lsmbench/configs/{c['name']}.json"
        assert all(NAME.match(k) for k in c["reduced"])
        names.append(c["name"])
    for w in BENCH["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert w["chips"] == 1 and w["config"] in names
        assert (ROOT / "lsmbench" / "traffic" / f"{w['traffic']}.json").is_file()
        cell = harness.load_cell(BENCH, w["name"])
        for kind, name in (("drivers", cell["traffic"]["driver"]), ("generators", cell["traffic"]["generator"]),
                           ("systems", cell["config"]["system"])):
            assert (ROOT / "lsmbench" / kind / f"{name}.py").is_file()
        for key in ("name", "config", "traffic"):
            assert NAME.match(w[key]), w[key]
    for m in BENCH["end_to_end"] + BENCH["per_layer"]:
        assert NAME.match(m["name"]) and UNIT.match(m["unit"]), m
        assert m["better"] in ("lower", "higher")
        assert (ROOT / "lsmbench" / "metrics" / f"{m['name']}.py").is_file()
    for m in BENCH["end_to_end"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "bound", "source"}
        assert m["source"] in ("host_clock", "device_trace") and 0.01 <= m["bound"] <= 0.25
    assert {m["name"]: m["bound"] for m in BENCH["end_to_end"]}["setup_s"] == 0.25
    for m in BENCH["per_layer"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "source", "layer", "moves"}
        assert m["source"] in ("device_trace", "program_span", "program_counter", "host_clock")
        if m["name"].endswith("_roofline"):
            assert m["unit"] == "%"
    for entry in BENCH["configs"] + BENCH["workloads"]:
        assert 1 <= len(entry["why"]) <= 200 and "\n" not in entry["why"] and "\t" not in entry["why"]
    every = [x["name"] for x in BENCH["configs"]] + [x["name"] for x in BENCH["workloads"]] \
        + [x["name"] for x in BENCH["end_to_end"] + BENCH["per_layer"]]
    assert len(every) == len(set(every))


def test_every_cell_reports_what_its_layers_move():
    for w in BENCH["workloads"]:
        e2e = {m["name"] for m in harness.cell_metrics(BENCH, w["name"], False)}
        per_layer = harness.cell_metrics(BENCH, w["name"], True)
        assert "setup_s" in e2e and len(e2e) >= 2 and per_layer
        for m in per_layer:
            assert m["moves"] in e2e, (w["name"], m["name"])


def test_a_new_mix_generator_system_and_metric_are_found_by_name(tmp_path):
    """Parts dropped into a folder of their own: a mix that names a new
    generator (the sliding window with every lookup key live), a config that
    names a new system adapter (the port's, counting its calls), and a metric."""
    for kind in ("traffic", "generators", "systems", "configs", "metrics"):
        (tmp_path / kind).mkdir()
    mix = harness.load_json("traffic", "read-write")
    mix["generator"] = "all_live"
    mix["round"] = [{"op": "update"}, {"op": "lookup", "keys": 256, "shares": {"live": 1.0, "deleted": 0.0}}]
    (tmp_path / "traffic" / "update-then-read.json").write_text(json.dumps(mix))
    (tmp_path / "generators" / "all_live.py").write_text(textwrap.dedent("""
        from lsmbench import harness
        base = harness.load_module("generators", "sliding_window")

        class AllLive(base.Stream):
            def lookup_keys(self, n, shares, tag):
                return super().lookup_keys(n, {"live": 1.0, "deleted": 0.0}, tag)

        def make(config, traffic, seed, device):
            return AllLive(base.Keyspace(config["key_bits"], seed, device), config["live_keys"],
                           traffic["update_mix"], seed, config["batch_size"] * traffic["update_batches"])
    """))
    (tmp_path / "systems" / "counted.py").write_text(textwrap.dedent("""
        from lsmbench import harness
        base = harness.load_module("systems", "lsm_facade")
        CALLS = []

        class Counted(base.LSMFacade):
            def update(self, keys, values, is_delete):
                CALLS.append(keys.shape[0])
                return super().update(keys, values, is_delete)

        def make(config, devices):
            return Counted(config, devices)
    """))
    config = harness.load_json("configs", "lsm-n27-b22")
    config["system"] = "counted"
    (tmp_path / "configs" / "lsm-n27-b22.json").write_text(json.dumps(config))
    (tmp_path / "metrics" / "rounds_run.py").write_text("def read(run):\n    return run.rounds\n")
    roots = (tmp_path, harness.BENCH)
    r, correct, checks = run(tiny("lsm-n27-b22.read-write", roots=roots, traffic="update-then-read"),
                             seconds=0.2, seed=77)
    assert correct, checks
    assert harness.load_metric("rounds_run", roots)(r) == r.rounds > 0
    assert len(harness.load_module("systems", "counted", roots).CALLS) >= r.rounds
    with pytest.raises(FileNotFoundError):
        harness.load_metric("no_such_metric", roots)


def test_forbidden_modules_compare_whole_top_level_names(monkeypatch):
    sys.path.insert(0, str(ROOT / "lsmbench"))
    try:
        import run as bench_run
    finally:
        sys.path.remove(str(ROOT / "lsmbench"))
    monkeypatch.setitem(sys.modules, "repro_torch_lookalike", sys)
    assert "repro" not in bench_run.forbidden_modules()
    monkeypatch.setitem(sys.modules, "repro.core", sys)
    assert bench_run.forbidden_modules() == ["repro"]


def test_a_run_loads_no_jax_and_no_reference_package():
    """A whole tiny run (port, reference, trace summary, metric readers) in a
    fresh process, then the guard that run.py applies."""
    code = textwrap.dedent(f"""
        import json, sys
        sys.path[:0] = [{str(ROOT / 'lsmbench' / 'tests')!r}, {str(ROOT / 'lsmbench')!r}]
        from lsmbench_tiny import tiny, run, BENCH
        from lsmbench import harness
        import run as bench_run
        for cell in ("lsm-n27-b16.scan", "lsm-n27-b22.read-write"):
            r = run(tiny(cell), seconds=0.2, seed=5, trace=True)[0]
            for m in harness.cell_metrics(BENCH, cell, False) + harness.cell_metrics(BENCH, cell, True):
                harness.load_metric(m["name"])(r)
        tops = sorted({{m.split(".")[0] for m in sys.modules}})
        print(json.dumps([bench_run.forbidden_modules(), "repro_torch" in tops]))
    """)
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr[-3000:]
    assert json.loads(out.stdout.strip().splitlines()[-1]) == [[], True]


def test_reference_imports_nothing_of_the_program():
    allowed = {"__future__", "torch"}
    for path in (ROOT / "lsmbench" / "reference").glob("*.py"):
        for node in ast.walk(ast.parse(path.read_text())):
            if isinstance(node, ast.Import):
                tops = {a.name.split(".")[0] for a in node.names}
            elif isinstance(node, ast.ImportFrom):
                tops = {(node.module or "").split(".")[0]}
            else:
                continue
            assert tops <= allowed, (path.name, tops)
