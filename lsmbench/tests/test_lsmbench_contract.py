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


TOY_DRIVER = '''
"""A toy driver: a bulk build, a fixed count (`calls`) of update calls,
then every live key read back and judged against the reference."""
import torch

from lsmbench import harness, progtrace
from lsmbench.reference.dense import DenseDictionary


class Run:
    def __init__(self):
        self.attempted = self.failed = self.memory_peak = self.wrong = 0
        self.setup_s = self.window_s = 0.0
        self.trace = self.program = self.counters = None

    def summary(self):
        return f"{self.attempted} lanes, {self.wrong} wrong"


def calls(traffic):
    return {"update", "lookup"}


def tiny(cell):
    cell["traffic"]["calls"] = 3
    return cell


def run_cell(cell, *, devices, seed, seconds, trace, system_factory=None, t_start=None, log=lambda m: None):
    devices = [torch.device(d) for d in devices]
    cfg, tr = cell["config"], cell["traffic"]
    gen = harness.load_module("generators", tr["generator"], cell["roots"])
    system = (system_factory or harness.load_module("systems", cfg["system"], cell["roots"]).make)(cfg, devices)
    stream, run = gen.make(cfg, tr, seed, devices[0]), Run()
    system.bulk_build(*stream.bulk())
    tracer = progtrace.Tracer(system, devices, cell["program_trace"]) if trace else None
    if tracer:
        tracer.start()
    with torch.profiler.record_function("lsmbench.window"):
        for _ in range(tr["calls"]):
            batch = stream.update()
            with torch.profiler.record_function("lsmbench.update"):
                if not system.fits(batch.keys.shape[0]):
                    system.cleanup(stream.live)
                stream.commit(batch)
                system.update(batch.keys, batch.values, batch.is_delete)
            run.attempted += batch.keys.shape[0]
    if tracer:
        tracer.stop()
        tracer.keep(run)
    found, values = system.lookup(stream.live_keys())
    ref, replay = DenseDictionary(cfg["key_bits"], devices[0]), gen.make(cfg, tr, seed, devices[0])
    ref.bulk_build(*replay.bulk())
    for _ in range(tr["calls"]):
        batch = replay.update()
        replay.commit(batch)
        ref.update(batch.keys, batch.values, batch.is_delete)
    exp_found, exp_values = ref.lookup(replay.live_keys())
    run.wrong = int((found != exp_found).sum()) + int((values != exp_values).sum())
    return run


def verdict(run):
    return run.wrong == 0, {"readback_wrong": {"value": run.wrong, "limit": 0}}
'''


def test_a_new_driver_is_found_cut_run_traced_and_judged(tmp_path):
    """A second driver and a mix that names it, in a folder of their own:
    the cell is found, cut by the driver's own `tiny`, run traced through
    progtrace.Tracer with the program's spans on (the cell reports metrics
    of them), and judged by the driver's `verdict`; with a fault planted, and
    with the control its own system module builds, it comes out not
    correct."""
    from lsmbench import control
    from lsmbench.faults import planted

    for kind in ("drivers", "traffic", "systems", "configs"):
        (tmp_path / kind).mkdir()
    (tmp_path / "drivers" / "toy.py").write_text(TOY_DRIVER)
    mix = harness.load_json("traffic", "update")
    mix["driver"] = "toy"
    (tmp_path / "traffic" / "toy-updates.json").write_text(json.dumps(mix))
    # A system module of its own, with its own control.
    (tmp_path / "systems" / "toy_system.py").write_text(textwrap.dedent("""
        from lsmbench import harness
        from lsmbench.control import ControlDictionary
        base = harness.load_module("systems", "lsm_facade")
        FAULTS, make, BUILT = base.FAULTS, base.make, []

        def control(config, devices, name):
            BUILT.append(name)
            return ControlDictionary(config, devices, name)
    """))
    config = harness.load_json("configs", "lsm-n27-b22")
    config["system"] = "toy_system"
    (tmp_path / "configs" / "lsm-n27-b22.json").write_text(json.dumps(config))
    roots = (tmp_path, harness.BENCH)
    cell = tiny("lsm-n27-b22.update", roots=roots, traffic="toy-updates")
    assert cell["traffic"]["calls"] == 3 and cell["program_trace"]
    r, correct, checks = run(cell, seed=77, trace=True)
    assert correct and checks == {"readback_wrong": {"value": 0, "limit": 0}}
    assert r.attempted == 3 * 64 and r.trace["groups"]["update"]["calls"] == 3
    assert harness.load_metric("host_syncs_per_call.update")(r) == 0
    with planted("unchanged"):
        r, correct, checks = run(cell, seed=77)
    assert not correct and checks["readback_wrong"]["value"] > 0
    correct, checks, _ = control.run_one(cell, 77, 0.2, ["cpu"], control="stale_overwrite")
    assert not correct and harness.load_module("systems", "toy_system", roots).BUILT == ["stale_overwrite"]


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
