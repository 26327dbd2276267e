"""The program's spans read beside the device operations (progtrace.py), on
a hand-made timeline and on the profiler's own events; and the port's
cascade counters against the carries the LSM adapter derives."""

import collections

import pytest
import torch
from lsmbench_tiny import run, tiny

from lsmbench import devtrace, harness, progtrace, roofline
from repro_torch import obs

P = progtrace.PROGRAM
SPANS = [("lsmbench.window", 0, 200), ("lsmbench.update", 10, 100), (P + "api.update", 11, 99),
         (P + "lsm.stage", 20, 90), (P + "ops.sort_recency", 25, 40), (P + "cascade.push", 45, 80),
         (P + "cascade.merge", 50, 60), ("lsmbench.count", 110, 190), (P + "api.count", 112, 189),
         (P + "queries.tile", 120, 150)]
# (name, start, end, launched, device). The gap [30, 52] has its middle in
# lsm.stage's own time, but "c", which ends it, was launched in
# cascade.merge. "i" was launched in the count call outside every program
# span; "j" between calls.
OPS = [("a", 13, 16, 12, 0), ("b", 27, 30, 26, 0), ("c", 52, 58, 51, 0), ("d", 70, 75, 65, 0),
       ("e", 92, 96, 91, 0), ("f", 125, 140, 121, 0), ("g", 150, 160, 145, 0), ("h", 170, 175, 165, 0),
       ("i", 180, 185, 111, 0), ("j", 195, 198, 194, 0)]
NS = 1e-9


def test_summary_of_a_hand_made_timeline():
    s = progtrace.summarize(OPS, SPANS)
    spans = s["spans"]
    assert spans["api.update"]["calls"] == 1
    assert spans["api.update"]["wall_s"] == pytest.approx(88 * NS)
    # self time: less the child spans (lsm.stage 70; under it sort 15 and push 35; under push merge 10)
    assert [spans[n]["self_s"] for n in ("api.update", "lsm.stage", "cascade.push", "cascade.merge")] == \
        pytest.approx([18 * NS, 20 * NS, 25 * NS, 10 * NS])
    # device seconds by the innermost span at each op's launch
    assert {n: spans[n]["device_s"] for n in spans} == pytest.approx(
        {"api.update": 7 * NS, "lsm.stage": 0, "ops.sort_recency": 3 * NS, "cascade.push": 5 * NS,
         "cascade.merge": 6 * NS, "api.count": 5 * NS, "queries.tile": 25 * NS})
    up, count = s["calls"]["update"], s["calls"]["count"]
    assert (up["calls"], count["calls"], s["calls"]["range"]["calls"]) == (1, 1, 0)
    assert up["device"] == pytest.approx({"api.update": 7 * NS, "ops.sort_recency": 3 * NS,
                                          "cascade.merge": 6 * NS, "cascade.push": 5 * NS})
    # gaps by the launch of the op that ends them: [10,13] and [75,92] the
    # facade's, [16,27] the sort's, [30,52] the merge's (not lsm.stage's,
    # where its middle lies), [58,70] the push's own; [96,100] ends at the
    # call's end
    assert up["idle"] == pytest.approx({"api.update": 20 * NS, "ops.sort_recency": 11 * NS,
                                        "cascade.merge": 22 * NS, "cascade.push": 12 * NS, "other": 4 * NS})
    assert count["device"] == pytest.approx({"queries.tile": 25 * NS, "api.count": 5 * NS, "other": 5 * NS})
    # [175,180] ends at "i", launched outside every program span
    assert count["idle"] == pytest.approx({"queries.tile": 25 * NS, "api.count": 10 * NS, "other": 10 * NS})
    assert dict(s["program_gaps"]) == pytest.approx(
        {"queries.tile": 25 * NS, "cascade.merge": 22 * NS, "api.update": 20 * NS, "other": 14 * NS,
         "cascade.push": 12 * NS, "ops.sort_recency": 11 * NS, "api.count": 10 * NS})
    # launched inside the gap it ends: delays 1, 1, 1, 5, 1, 4, 5, 5 ns
    assert (s["launch_delays"], s["launch_delay_s"]) == (8, pytest.approx(2.5 * NS))


def test_metrics_add_up_to_the_device_trace_idle_share():
    s = progtrace.summarize(OPS, SPANS)
    m = progtrace.metrics(s, {"host_syncs": 3, "queries.tile_slots": 100, "queries.candidates": 12})
    assert m["idle_share.update.facade"] == pytest.approx(100 * 20 / 90)
    assert m["idle_share.update.core"] == pytest.approx(100 * 45 / 90)
    assert m["idle_share.update.other"] == pytest.approx(100 * 4 / 90)
    bench = devtrace.summarize(OPS, [(n[len(devtrace.PREFIX):], a, b) for n, a, b in SPANS
                                     if n.startswith(devtrace.PREFIX)])
    group = bench["groups"]["update"]
    idle_share = 100 * (1 - group["busy_s"] / group["wall_s"])
    assert sum(m[f"idle_share.update.{k}"] for k in ("facade", "core", "other")) == pytest.approx(idle_share)
    assert m["sort_share.update"] == pytest.approx(100 * 3 / 21)
    assert m["tile_share.scan"] == pytest.approx(100 * 25 / 35)
    assert (m["host_syncs_per_call.update"], m["tile_yield.scan"]) == (3.0, 12.0)


def test_a_program_without_spans_or_counters_gives_nothing():
    bench_only = [x for x in SPANS if x[0].startswith(devtrace.PREFIX)]
    s = progtrace.summarize(OPS, bench_only)
    assert s["spans"] == {} and set(s["calls"]["update"]["idle"]) == {"other"}
    assert set(progtrace.metrics(s, None).values()) == {None}
    assert progtrace.lines(s) == []


def test_the_profilers_events_hold_the_program_spans():
    """CPU calls in the benchmark's spans, profiled: `kineto_events` finds
    both kinds of span, nested; with no device the calls read idle."""
    d = harness.load_module("systems", "lsm_facade").make(
        {"backend": "lsm", "validate": True, "flush_threshold": None, "maintenance_budget": None,
         "capacity": 16 * 15, "batch_size": 16}, [torch.device("cpu")])
    keys = torch.arange(40, dtype=torch.int32)
    obs.enable(True)
    try:
        with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
            with torch.profiler.record_function("lsmbench.window"):
                with torch.profiler.record_function("lsmbench.update"):
                    d.update(keys, keys, torch.zeros(40, dtype=torch.bool))
    finally:
        obs.enable(False)
    ops, spans = progtrace.kineto_events(prof)
    names = collections.Counter(n for n, _, _ in spans)
    assert ops == []
    assert names == {"lsmbench.window": 1, "lsmbench.update": 1, P + "api.update": 1, P + "lsm.stage": 3,
                     P + "ops.sort_recency": 5, P + "cascade.push": 2, P + "cascade.merge": 2,
                     P + "cascade.debt": 2}
    s = progtrace.summarize(ops, spans)
    assert s["spans"]["lsm.stage"]["calls"] == 3
    assert 0 < s["spans"]["lsm.stage"]["self_s"] < s["spans"]["lsm.stage"]["wall_s"]
    assert s["calls"]["update"]["idle"] == pytest.approx({"other": s["calls"]["update"]["wall_s"]})
    assert len(progtrace.lines(s)) == 6


def test_the_adapters_carries_equal_the_programs_counters():
    """A tiny b22 update cell with the program's counters on: the levels the
    adapter derives from `r` and `pending()` for every update call equal
    `cascade.carries.L<j>`, and every cleanup waits three times."""
    base = harness.load_module("systems", "lsm_facade")
    levels, cleanups = [], []

    class Recording(base.LSMFacade):
        def update(self, keys, values, is_delete):
            r, carries = self.d.state.r, self._carries(keys.shape[0])
            levels.extend(roofline.placement_level(r + k) for k in range(carries))
            return super().update(keys, values, is_delete)

        def cleanup(self, survivors):
            cleanups.append(survivors)
            return super().cleanup(survivors)

    obs.reset()
    obs.enable(True)
    try:
        r, correct, checks = run(tiny("lsm-n27-b22.update"), seconds=0.3, system_factory=Recording)
    finally:
        obs.enable(False)
    counters = obs.counters()
    obs.reset()
    assert correct, checks
    assert r.cleanups >= 1 and len(levels) > 40
    carries = {k: v for k, v in counters.items() if k.startswith("cascade.carries.")}
    assert carries == {f"cascade.carries.L{j}": n for j, n in collections.Counter(levels).items()}
    assert counters["host_syncs"] == 3 * len(cleanups)


PROGRAM_METRICS = ("idle_share.update.facade", "idle_share.update.core", "sort_share.update",
                   "host_syncs_per_call.update")


def watched(calls):
    """The LSM adapter, noting at every call whether the program's tracing is on."""
    base = harness.load_module("systems", "lsm_facade")

    class Watched(base.LSMFacade):
        pass

    for name in ("update", "lookup", "count", "range"):
        def call(self, *args, _name=name):
            calls.append((_name, obs.enabled()))
            return getattr(base.LSMFacade, _name)(self, *args)
        setattr(Watched, name, call)
    return Watched


def test_a_traced_run_turns_the_program_on_for_the_window_alone():
    """A tiny b22 update cell, traced: the program's spans and counters are on
    in the window's calls and in no other; the run keeps progtrace's summary
    and the counters, and the readers give numbers. sort_share.update has no
    device time to read on the CPU."""
    calls = []
    cell = tiny("lsm-n27-b22.update")
    assert cell["program_trace"]
    r, correct, checks = run(cell, seconds=0.5, trace=True, system_factory=watched(calls))
    assert correct, checks
    updates = [on for name, on in calls if name == "update"]
    window = len(r.latency_s["update"])
    assert updates == [False] * (len(updates) - window) + [True] * window and window > 1
    assert not any(on for name, on in calls if name == "lookup") and not obs.enabled()
    assert r.program["calls"]["update"]["calls"] == window
    assert r.counters.get("host_syncs", 0) == 3 * r.cleanups
    got = {name: harness.load_metric(name)(r) for name in PROGRAM_METRICS}
    assert got["sort_share.update"] is None
    assert got["host_syncs_per_call.update"] == 3 * r.cleanups / window
    assert got["idle_share.update.facade"] >= 0 and got["idle_share.update.core"] >= 0
    idle = harness.load_metric("idle_share.update")(r)
    assert got["idle_share.update.facade"] + got["idle_share.update.core"] <= idle + 1e-9


@pytest.mark.parametrize("cell,trace", [("lsm-n27-b22.update", False), ("lsm-n27-b16.scan", True)])
def test_the_program_stays_off_untraced_and_where_no_metric_reads_it(cell, trace):
    """An untraced run, and a traced run of a cell that reports no metric of
    the program's spans or counters, never turn them on, keep no program
    summary, and their readers give nothing."""
    calls = []
    c = tiny(cell)
    r, correct, checks = run(c, seconds=0.2, trace=trace, system_factory=watched(calls))
    assert correct, checks
    assert calls and not any(on for _, on in calls)
    assert (r.trace is not None) == trace and r.program is None and r.counters is None
    assert c["program_trace"] == (cell == "lsm-n27-b22.update")
    assert all(harness.load_metric(name)(r) is None for name in PROGRAM_METRICS)


def test_the_control_has_no_program_to_trace():
    """The control (the reference's table) has no `program_trace`: a traced
    run of it keeps the device trace and no program summary."""
    from lsmbench.control import ControlDictionary

    cell = tiny("lsm-n27-b22.update")
    r = harness.driver(cell).run_cell(cell, devices=["cpu"], seed=5, seconds=0.2, trace=True,
                                      system_factory=lambda cfg, devs: ControlDictionary(cfg, devs, "stale_overwrite"))
    assert r.trace["groups"]["update"]["calls"] > 0 and r.program is None
    assert all(harness.load_metric(name)(r) is None for name in PROGRAM_METRICS)
