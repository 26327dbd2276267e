"""The program's own spans in a traced window, beside the device operations.

With `repro_torch.obs` on, the port wraps the stages of its dictionary path
in profiler spans named `repro_torch.<name>` (that module lists them), inside
the benchmark's `lsmbench.<op>` call spans. This reads both from the same
profiler events as `devtrace.py`, all on the host's clock:

* per program span name: its calls, wall time, self time (wall time less the
  time its child spans cover) and the device seconds of the operations whose
  host launch falls innermost in it;
* per benchmark call kind (`update`, `lookup`, `count`, `range`): the calls,
  their wall time, and their device seconds and idle seconds by program span;
* the idle gaps inside calls by program span (`program_gaps`), and the median
  delay from host launch to device start of the operations that end them.

An operation's launch time is the start of the CUDA runtime call that
launched it; the torch operation linked to it (`devtrace.py`'s launch time)
starts before the launches it makes. Where the profiler recorded no runtime
call, the linked operation's start stands in. An idle gap inside a call span
goes to the innermost program span that contains the launch time of the
operation that ends the gap, so only host times are compared with host
times. A gap that ends at the call's end (its synchronise), or whose next
operation was launched outside every program span, goes to `other`.

`Tracer` profiles a driver's measured window in a traced run (every driver
uses it): it keeps devtrace's summary on the run as `run.trace`, and in a
cell that reports a metric read from the program's spans or counters it
turns them on around the window and keeps this module's summary as
`run.program` and the counters as `run.counters`. Untraced runs never turn
them on.
"""

from __future__ import annotations

import bisect
import statistics
import time

from lsmbench import devtrace

PROGRAM = "repro_torch."
CALLS = ("update", "lookup", "count", "range")
OTHER = "other"
LAYERS = {"facade": ("api.",), "core": ("lsm.", "ops.", "cascade.", "cleanup")}


class Tracer:
    """The profiler around a measured window. With `program` (the cell's
    `program_trace`, harness.load_cell) the system's own spans and counters
    go on just before the profiler starts and off just after it stops,
    through the system's `program_trace(on)`; a system without that method
    has none, and its run keeps no program summary."""

    def __init__(self, system, devices, program: bool):
        from torch.profiler import ProfilerActivity, profile

        cuda = any(d.type == "cuda" for d in devices)
        self.prof = profile(activities=[ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if cuda else []))
        self.switch = getattr(system, "program_trace", None) if program else None
        self.counters = None

    def start(self) -> None:
        if self.switch:
            self.switch(True)
        self.prof.start()

    def stop(self) -> None:
        self.prof.stop()
        if self.switch:
            self.counters = self.switch(False)

    def keep(self, run, log=lambda msg: None) -> None:
        """Summarise the stopped window onto `run` (`trace`; `program` and
        `counters` where the program was traced), then drop the profiler."""
        t0 = time.perf_counter()
        run.trace = devtrace.summarize(*devtrace.kineto_events(self.prof))
        if self.switch:
            run.program = summarize(*kineto_events(self.prof))
            run.counters = self.counters
        self.prof = None
        log(f"trace summarised in {time.perf_counter() - t0:.3f} s: {run.trace['ops']} device operations")


def read(run, name: str):
    """The per-layer metric `name` of `metrics`, or None where the run kept
    no program summary."""
    return None if run.program is None else metrics(run.program, run.counters)[name]


def kineto_events(prof):
    """(device ops, spans) of a stopped `torch.profiler.profile`: ops as
    (name, start_ns, end_ns, launched_ns, device index), spans as (full
    name, start_ns, end_ns) for the benchmark's and the program's spans."""
    import torch

    cuda = torch.autograd.DeviceType.CUDA
    device, spans, op_start, runtime_start = [], [], {}, {}
    for e in prof.profiler.kineto_results.events():
        if e.device_type() == cuda:
            if not e.is_user_annotation():
                device.append((e.name(), e.start_ns(), e.start_ns() + e.duration_ns(), e.correlation_id(),
                               e.linked_correlation_id(), e.device_index()))
            continue
        name = e.name()
        if name.startswith("cu"):
            # CUDA runtime calls carry the device's correlation ids.
            runtime_start[e.correlation_id()] = e.start_ns()
        elif e.linked_correlation_id() == 0:
            op_start[e.correlation_id()] = e.start_ns()
        if e.is_user_annotation() and name.startswith((devtrace.PREFIX, PROGRAM)):
            spans.append((name, e.start_ns(), e.start_ns() + e.duration_ns()))
    ops = [(name, s, e, runtime_start.get(corr, op_start.get(link, s)), index)
           for name, s, e, corr, link, index in device]
    return ops, spans


def _innermost(intervals, times):
    """For each of `times`, the index in `intervals` ((start, end) pairs,
    nested or disjoint, sorted by start and then by end descending) of the
    innermost one that contains it, or -1."""
    order = sorted(range(len(times)), key=times.__getitem__)
    out = [-1] * len(times)
    stack, k = [], 0
    for i in order:
        t = times[i]
        while k < len(intervals) and intervals[k][0] <= t:
            while stack and intervals[stack[-1]][1] <= intervals[k][0]:
                stack.pop()
            stack.append(k)
            k += 1
        while stack and intervals[stack[-1]][1] <= t:
            stack.pop()
        if stack:
            out[i] = stack[-1]
    return out


def _nested(spans):
    """Spans sorted for `_innermost`, as (start, end, label)."""
    return sorted(((s, e, label) for label, s, e in spans), key=lambda x: (x[0], -x[1]))


def summarize(ops, spans, top: int = 10) -> dict:
    """See the module docstring. `ops` and `spans` as `kineto_events` gives."""
    windows = [(s, e) for name, s, e in spans if name == devtrace.PREFIX + "window"]
    if not windows:
        raise ValueError("no lsmbench.window span in the trace")
    w0, w1 = windows[0]
    ops = sorted((max(s, w0), min(e, w1), t) for _, s, e, t, _ in ops if e > w0 and s < w1)
    busy = devtrace._union([(s, e) for s, e, _ in ops])
    program = _nested((n[len(PROGRAM):], s, e) for n, s, e in spans if n.startswith(PROGRAM))
    call_names = {devtrace.PREFIX + kind: kind for kind in CALLS}
    calls = _nested((call_names[n], s, e) for n, s, e in spans if n in call_names)

    per_span = {}
    stack = []
    for s, e, label in program:
        while stack and stack[-1][1] <= s:
            stack.pop()
        row = per_span.setdefault(label, {"calls": 0, "wall_s": 0.0, "self_s": 0.0, "device_s": 0.0})
        row["calls"] += 1
        row["wall_s"] += (e - s) / 1e9
        row["self_s"] += (e - s) / 1e9
        if stack:
            per_span[stack[-1][2]]["self_s"] -= (e - s) / 1e9
        stack.append((s, e, label))

    by_call = {kind: {"calls": 0, "wall_s": 0.0, "device": {}, "idle": {}} for kind in CALLS}
    for s, e, kind in calls:
        by_call[kind]["calls"] += 1
        by_call[kind]["wall_s"] += (e - s) / 1e9

    def add(table, label, ns):
        table[label] = table.get(label, 0.0) + ns / 1e9

    launches = [t for _, _, t in ops]
    in_program = _innermost(program, launches)
    in_call = _innermost(calls, launches)
    for (s, e, _), p, c in zip(ops, in_program, in_call):
        label = program[p][2] if p >= 0 else OTHER
        if p >= 0:
            per_span[label]["device_s"] += (e - s) / 1e9
        if c >= 0:
            add(by_call[calls[c][2]]["device"], label, e - s)

    # Idle gaps inside each call: the call's time outside the busy union.
    starts = [s for s, _, _ in ops]
    busy_starts = [s for s, _ in busy]
    gaps = []   # (call kind, ns, launch time of the op that ends it or None, start, end)
    for cs, ce, kind in calls:
        k = max(bisect.bisect_right(busy_starts, cs) - 1, 0)
        cursor = cs
        while cursor < ce:
            while k < len(busy) and busy[k][1] <= cursor:
                k += 1
            if k < len(busy) and busy[k][0] <= cursor:
                cursor = busy[k][1]
                continue
            end = min(busy[k][0], ce) if k < len(busy) else ce
            ender = ops[bisect.bisect_left(starts, end)][2] if end < ce else None
            gaps.append((kind, end - cursor, ender, cursor, end))
            cursor = end
    inner = iter(_innermost(program, [g[2] for g in gaps if g[2] is not None]))
    program_gaps = {}
    delays = []
    for kind, ns, ender, g0, g1 in gaps:
        p = next(inner) if ender is not None else -1
        label = program[p][2] if p >= 0 else OTHER
        add(by_call[kind]["idle"], label, ns)
        add(program_gaps, label, ns)
        if ender is not None and g0 <= ender <= g1:
            delays.append(g1 - ender)
    return {
        "spans": per_span,
        "calls": by_call,
        "program_gaps": [[n, s] for n, s in sorted(program_gaps.items(), key=lambda x: -x[1])[:top]],
        "launch_delay_s": statistics.median(delays) / 1e9 if delays else None,
        "launch_delays": len(delays),
    }


def _layer(label: str):
    """The layer of a program span label ("facade" or "core"); None for `other`."""
    for layer, prefixes in LAYERS.items():
        if label.startswith(prefixes):
            return layer
    return None


def metrics(summary: dict, counters) -> dict:
    """The per-layer numbers that the program's spans and counters
    (`obs.counters()`, or None from a program without them) give: each None
    where the window has nothing for it to read.

    * `idle_share.update.facade`, `.core`, `.other` (%): idle seconds inside
      update calls put down to `api.*` spans; to `lsm.*`, `ops.*`,
      `cascade.*` and `cleanup*`; to the rest; each over the update calls'
      wall time. The three add up to devtrace's `idle_share.update`.
    * `sort_share.update` (%): device seconds launched in `ops.sort_recency`
      over those launched in update calls.
    * `host_syncs_per_call.update`: `host_syncs` over the update calls.
    * `tile_share.scan` (%): device seconds launched in `queries.tile` over
      those launched in count and range calls.
    * `tile_yield.scan` (%): `queries.candidates` over `queries.tile_slots`.
    """
    out = dict.fromkeys(("idle_share.update.facade", "idle_share.update.core", "idle_share.update.other",
                         "sort_share.update", "host_syncs_per_call.update", "tile_share.scan",
                         "tile_yield.scan"))
    counters = counters or {}
    has_program = bool(summary["spans"])
    up = summary["calls"]["update"]
    if up["calls"] and up["wall_s"] > 0 and has_program:
        shares = {"facade": 0.0, "core": 0.0, None: 0.0}
        for label, s in up["idle"].items():
            shares[_layer(label)] += s
        out["idle_share.update.facade"] = 100.0 * shares["facade"] / up["wall_s"]
        out["idle_share.update.core"] = 100.0 * shares["core"] / up["wall_s"]
        out["idle_share.update.other"] = 100.0 * shares[None] / up["wall_s"]
        device = sum(up["device"].values())
        if device > 0:
            out["sort_share.update"] = 100.0 * up["device"].get("ops.sort_recency", 0.0) / device
        if counters:
            out["host_syncs_per_call.update"] = counters.get("host_syncs", 0) / up["calls"]
    scan = [summary["calls"][k] for k in ("count", "range")]
    device = sum(sum(c["device"].values()) for c in scan)
    if device > 0 and has_program:
        out["tile_share.scan"] = 100.0 * sum(c["device"].get("queries.tile", 0.0) for c in scan) / device
    if counters.get("queries.tile_slots"):
        out["tile_yield.scan"] = 100.0 * counters.get("queries.candidates", 0) / counters["queries.tile_slots"]
    return out


def lines(summary: dict) -> list:
    """One line per program span, for standard error."""
    idle = {}
    for call in summary["calls"].values():
        for label, s in call["idle"].items():
            idle[label] = idle.get(label, 0.0) + s
    return [f"span {PROGRAM}{name}: {row['calls']} calls, wall {row['wall_s']:.6f} s, self {row['self_s']:.6f} s, "
            f"device {row['device_s']:.6f} s, idle in calls {idle.get(name, 0.0):.6f} s"
            for name, row in sorted(summary["spans"].items(), key=lambda x: -x[1]["wall_s"])]
