"""The closed loop: set-up, the measured window, its trace, and the check.

A traffic file names this driver with `"driver": "closed_loop"`. The mix says
how the set-up fills the dictionary and what one round of the loop sends: a
list of calls (`update`, `lookup`, `count`, `range`). One client sends a
call, waits until its outputs are ready on the device, and sends the next. A
call's latency runs from its sending to that synchronise; an update that
needs a stop-the-world cleanup first (the system says the batch would not
fit) carries it.

Rounds whose calls change nothing (no update) cycle through `ring`
pre-made inputs per call, so the window times the dictionary and not the
generator. Rounds with an update make each call's inputs between calls, in a
`client` span, and wait for them on the device before the call is sent, so
no call's latency holds the generator's work; the generator makes update
batches a chunk of calls at a time, so most calls take rows already made.

The check's sample of the window's answers is a reservoir of `check_rounds`
rounds drawn from the seed (uniform over the rounds the window ran), copied
into buffers made in set-up, plus the last round's.

A traced run profiles the window through progtrace.Tracer, which turns the
program's own spans and counters on around it in a cell that reads them.

After the window: the peak memory is read (above what the benchmark held
before the system was made: the generator's key table); every live key, the
most recently deleted keys and some never-inserted keys are read back
through the system; the system is freed; then the reference replays the
whole run from the seed and judges the read-back and the sampled answers,
every one exactly.
"""

from __future__ import annotations

import contextlib
import gc
import random
import time

import torch

from lsmbench import devtrace, harness, progtrace, roofline
from lsmbench.reference.dense import DenseDictionary

QUERY_OPS = ("lookup", "count", "range")
CHECKS = ("lookup_wrong", "count_wrong", "range_wrong", "ok_wrong", "readback_wrong")
READBACK_CHUNK = 1 << 24   # keys a read-back lookup call sends


class Run:
    """What a run measured; the metric readers read it. Every driver's run
    has `attempted`, `failed`, `memory_peak` (bytes), `setup_s`, `window_s`,
    `trace` (devtrace.summarize's, or None), `program` and `counters`
    (progtrace.Tracer's, or None) and `summary()`."""

    def __init__(self, traffic: dict, devices):
        self.traffic = traffic
        dev = devices[0]
        self.device_name = torch.cuda.get_device_name(dev) if dev.type == "cuda" else "cpu"
        self.setup_s = None
        self.window_s = None
        self.latency_s = {op: [] for op in ("update",) + QUERY_OPS}
        self.work = {op: 0 for op in ("update",) + QUERY_OPS}
        self.cleanups = 0
        self.cleanup_s = 0.0
        self.bytes = {"update": 0, "lookup": 0, "scan": 0}
        self.memory_peak = 0
        self.trace = None
        self.program = None
        self.counters = None
        self.failed = 0
        self.checks = {}
        self.checked = {}
        self.rounds = 0

    @property
    def attempted(self) -> int:
        return sum(self.work.values())

    def summary(self) -> str:
        return (f"{self.rounds} rounds in {self.window_s:.6f} s, set-up {self.setup_s:.6f} s, "
                f"{self.cleanups} cleanups, peak {self.memory_peak} bytes; compared {self.checked}")


def _rounds(traffic: dict):
    ops = traffic["round"]
    return ops, not any(op["op"] == "update" for op in ops)


def calls(traffic: dict) -> set:
    """The kinds of call a run of this mix sends the system: its rounds',
    the set-up's updates and the read-back's lookups."""
    return {"update", "lookup"} | {op["op"] for op in traffic["round"]}


def tiny(cell: dict) -> dict:
    """The cell's mix at the size of the CPU tests, in place (its config
    already cut to a 16-bit key space, b = 64 and 1024 live keys): 30 set-up
    update calls of at most 4 batches, so a cleanup comes on the way as at
    full size and a call of several batches still splits; lookups of 512
    keys; 64 windows of 256 keys under a plan small enough that some windows
    overflow, so `ok` is checked both ways."""
    tr = cell["traffic"]
    tr["update_batches"] = min(tr["update_batches"], 4)
    tr["setup"]["update_calls"] = 30
    tr["check_rounds"] = min(tr["check_rounds"], 4)
    for op in tr["round"]:
        if op["op"] == "lookup":
            op["keys"] = 512
        if op["op"] in ("count", "range"):
            op.update(windows=64, width=256)
    if "plan" in tr:
        tr["plan"] = {"max_candidates": 24, "max_results": 12}
    return cell


class Client:
    """Sends one cell's calls to a system; counts their time, work and bytes."""

    def __init__(self, cell: dict, system, stream, devices, run: Run, trace: bool):
        self.sys = system
        self.stream = stream
        self.devices = devices
        self.run = run
        self.plan = cell["traffic"].get("plan")
        self.span = ((lambda name: torch.profiler.record_function(devtrace.PREFIX + name))
                     if trace else (lambda name: contextlib.nullcontext()))

    def sync(self):
        for dev in self.devices:
            if dev.type == "cuda":
                torch.cuda.synchronize(dev)

    def prepare(self, make):
        """A call's inputs, made and ready on the device before it is sent."""
        with self.span("client"):
            inputs = make()
        self.sync()
        return inputs

    def update(self, batch, timed: bool) -> float:
        """One update call (and the cleanup it needs) -> its latency."""
        lanes = batch.keys.shape[0]
        t0 = time.perf_counter()
        with self.span("update"):
            if not self.sys.fits(lanes):
                with self.span("cleanup"):
                    nbytes = self.sys.cleanup(self.stream.live)
                    self.sync()
                    t_clean = time.perf_counter() - t0
                if not self.sys.fits(lanes):
                    raise RuntimeError(f"a batch of {lanes} lanes does not fit even after a cleanup")
                if timed:
                    self.run.cleanups += 1
                    self.run.cleanup_s += t_clean
                    self.run.bytes["update"] += nbytes
            self.stream.commit(batch)
            nbytes = self.sys.update(batch.keys, batch.values, batch.is_delete)
            self.sync()
        t1 = time.perf_counter()
        if timed:
            self.run.bytes["update"] += nbytes
        return t1 - t0

    def query(self, op: str, args):
        """One lookup, count or range call -> (outputs, latency)."""
        t0 = time.perf_counter()
        with self.span(op):
            if op == "lookup":
                out = self.sys.lookup(*args)
            else:
                out = getattr(self.sys, op)(*args, self.plan)
            self.sync()
        return out, time.perf_counter() - t0


def make_inputs(stream, op: dict, tag):
    """The inputs of one call: an update batch, lookup keys, or windows."""
    if op["op"] == "update":
        return stream.update()
    if op["op"] == "lookup":
        return (stream.lookup_keys(op["keys"], op["shares"], tag),)
    return stream.windows(op["windows"], op["width"], tag)


def readback_keys(stream):
    """Every live key, the most recently deleted keys, and never-inserted ones."""
    return stream.live_keys(), stream.dead_keys(), stream.absent_keys(max(1, stream.live // 16))


def run_cell(cell: dict, *, devices, seed: int, seconds: float, trace: bool,
             system_factory=None, t_start: float | None = None, log=lambda msg: None) -> Run:
    """Run a cell (harness.load_cell) and judge it; see the module docstring."""
    t_start = time.perf_counter() if t_start is None else t_start
    devices = [torch.device(d) for d in devices]
    dev = devices[0]
    cuda = dev.type == "cuda"
    roots = cell.get("roots", (harness.BENCH,))
    cfg, tr = cell["config"], cell["traffic"]
    run = Run(tr, devices)
    ops, read_only = _rounds(tr)
    gen = harness.load_module("generators", tr["generator"], roots)
    make_system = system_factory or harness.load_module("systems", cfg["system"], roots).make

    # -- set-up ------------------------------------------------------------
    drv = None

    def phase(what):
        if drv is not None:
            drv.sync()
        log(f"set-up: {what} done at {time.perf_counter() - t_start:.3f} s")

    phase("imports")
    stream = gen.make(cfg, tr, seed, dev)
    held = {}
    for d in devices:
        if d.type == "cuda":
            torch.cuda.synchronize(d)
            torch.cuda.reset_peak_memory_stats(d)
            held[d] = torch.cuda.memory_allocated(d)
    system = make_system(cfg, devices)
    drv = Client(cell, system, stream, devices, run, trace)
    phase("generator and empty dictionary")
    system.bulk_build(*stream.bulk())
    phase("bulk build")
    for _ in range(tr["setup"]["update_calls"]):
        drv.update(drv.prepare(stream.update), timed=False)
    phase(f"{tr['setup']['update_calls']} set-up update calls")
    ring = None
    warm = []
    if read_only:
        ring = [[make_inputs(stream, op, ("ring", i, k)) for k in range(tr["ring"])] for i, op in enumerate(ops)]
        for i, op in enumerate(ops):
            warm.append((i, drv.query(op["op"], ring[i][0])[0]))
    else:
        # The first round's queries, sent once: their inputs (a chunk of the
        # window's) are made here, and the window sends them again.
        for i, op in enumerate(ops):
            if op["op"] != "update":
                warm.append((i, drv.query(op["op"], drv.prepare(lambda: make_inputs(stream, op, ("round", 0, i))))[0]))
    # The check's sample: a reservoir of `check_rounds` rounds drawn from the
    # seed, copied into buffers made here, so the window allocates nothing.
    slots = tr["check_rounds"] if warm else 0
    reservoir = [[(i, tuple(torch.empty_like(t) for t in out)) for i, out in warm] for _ in range(slots)]
    slot_round = [-1] * slots
    del warm
    phase("warm-up calls")

    # -- the window ----------------------------------------------------------
    sampler = random.Random(harness.mix(seed, "sample"))
    oks = []           # (round, call index, ok) of every count and range call
    last = None
    tracer = progtrace.Tracer(system, devices, cell.get("program_trace", False)) if trace else None
    if tracer:
        tracer.start()
    rounds = 0
    run.setup_s = time.perf_counter() - t_start
    t_window = time.perf_counter()
    with drv.span("window"):
        while time.perf_counter() - t_window < seconds:
            outs = []
            for i, op in enumerate(ops):
                kind = op["op"]
                if read_only:
                    args = ring[i][rounds % tr["ring"]]
                else:
                    args = drv.prepare(lambda: make_inputs(stream, op, ("round", rounds, i)))
                if kind == "update":
                    run.latency_s["update"].append(drv.update(args, timed=True))
                    run.work["update"] += args.keys.shape[0]
                    continue
                out, lat = drv.query(kind, args)
                run.latency_s[kind].append(lat)
                run.work[kind] += args[0].shape[0]
                if kind == "lookup":
                    run.bytes["lookup"] += roofline.lookup_bytes(args[0].shape[0])
                else:
                    run.bytes["scan"] += roofline.count_bytes(args[0].shape[0])
                    oks.append((rounds, i, out[-1]))
                outs.append((i, out))
            j = rounds if rounds < slots else sampler.randrange(rounds + 1)
            if j < slots:
                for (_, buf), (_, out) in zip(reservoir[j], outs):
                    for b, t in zip(buf, out):
                        b.copy_(t)
                slot_round[j] = rounds
            last = (rounds, outs)
            rounds += 1
    run.window_s = time.perf_counter() - t_window
    if tracer:
        tracer.stop()
    kept = {r: reservoir[j] for j, r in enumerate(slot_round) if r >= 0}
    if slots:
        kept[last[0]] = last[1]
    del last
    run.memory_peak = max((torch.cuda.max_memory_allocated(d) - base for d, base in held.items()), default=0)
    if tracer:
        tracer.keep(run, log)
    run.rounds = rounds

    # -- read back every acknowledged update, then free the system -----------
    readback = []
    for keys in readback_keys(stream):
        for s in range(0, keys.shape[0], READBACK_CHUNK):
            readback.append(system.lookup(keys[s:s + READBACK_CHUNK]))
    drv.sync()
    del drv, system, ring, stream
    gc.collect()
    if cuda:
        torch.cuda.empty_cache()

    # -- the reference -------------------------------------------------------
    t0 = time.perf_counter()
    judge(cell, gen, dev, seed, rounds, kept, oks, readback, run)
    log(f"reference replay and comparison in {time.perf_counter() - t0:.3f} s")
    return run


def _mismatch(a, b) -> int:
    return int((a != b).sum())


def judge(cell: dict, gen, dev, seed: int, rounds: int, kept: dict, oks: list, readback: list, run: Run):
    """Replay the run on the reference from the seed and compare."""
    cfg, tr = cell["config"], cell["traffic"]
    ops, read_only = _rounds(tr)
    plan = tr.get("plan")
    scans = any(op["op"] in ("count", "range") for op in ops)
    ref = DenseDictionary(cfg["key_bits"], dev, track_writes=scans)
    stream = gen.make(cfg, tr, seed, dev)
    checks = {name: 0 for name in CHECKS}
    checked = {"lookup": 0, "count": 0, "range": 0, "ok": 0, "readback": 0}

    def apply(batch):
        stream.commit(batch)
        ref.update(batch.keys, batch.values, batch.is_delete)

    def compare(kind, got, inputs):
        if kind == "lookup":
            exp = ref.lookup(*inputs)
            checks["lookup_wrong"] += _mismatch(got[0], exp[0]) + _mismatch(got[1], exp[1])
        elif kind == "count":
            exp = ref.count(*inputs, plan)
            checks["count_wrong"] += int((got[1] & (got[0] != exp[0])).sum())
        else:
            exp = ref.range(*inputs, plan)
            row_wrong = (got[0] != exp[0]).any(1) | (got[1] != exp[1]).any(1) | (got[2] != exp[2])
            checks["range_wrong"] += int((got[3] & row_wrong).sum())
        checked[kind] += inputs[0].shape[0]

    def check_ok(ok, must_may):
        must, may = must_may
        checks["ok_wrong"] += int(((must & ~ok) | (~may & ok)).sum())
        checked["ok"] += ok.shape[0]

    def rows(inputs):
        return int(ref.range(*inputs, plan)[2].clamp(max=plan["max_results"]).sum())

    ref.bulk_build(*stream.bulk())
    for _ in range(tr["setup"]["update_calls"]):
        apply(stream.update())
    if read_only:
        slots = tr["ring"]
        ring = [[make_inputs(stream, op, ("ring", i, k)) for k in range(slots)] for i, op in enumerate(ops)]
        bounds = {}
        for i, op in enumerate(ops):
            if op["op"] in ("count", "range"):
                bounds[i] = [ref.expected_ok(op["op"], *inp, plan) for inp in ring[i]]
            if op["op"] == "range":
                per_slot = [rows(inp) for inp in ring[i]]
                run.bytes["scan"] += sum(per_slot[r % slots] for r in range(rounds)) * roofline.ELEMENT
        for r, i, ok in oks:
            check_ok(ok, bounds[i][r % slots])
        for r, outs in kept.items():
            for i, out in outs:
                compare(ops[i]["op"], out, ring[i][r % slots])
    else:
        ok_at = {(r, i): ok for r, i, ok in oks}
        for r in range(rounds):
            for i, op in enumerate(ops):
                if op["op"] == "update":
                    apply(stream.update())
                    continue
                if r not in kept and op["op"] == "lookup":
                    continue
                inputs = make_inputs(stream, op, ("round", r, i))
                if op["op"] == "range":
                    run.bytes["scan"] += rows(inputs) * roofline.ELEMENT
                if (r, i) in ok_at:
                    check_ok(ok_at[(r, i)], ref.expected_ok(op["op"], *inputs, plan))
                if r in kept:
                    compare(op["op"], dict(kept[r])[i], inputs)
    it = iter(readback)
    for keys in readback_keys(stream):
        for s in range(0, keys.shape[0], READBACK_CHUNK):
            got, exp = next(it), ref.lookup(keys[s:s + READBACK_CHUNK])
            checks["readback_wrong"] += _mismatch(got[0], exp[0]) + _mismatch(got[1], exp[1])
            checked["readback"] += exp[0].shape[0]
    run.failed = sum(int((~ok).sum()) for _, _, ok in oks)
    run.checks = checks
    run.checked = checked


def verdict(run: Run):
    """(correct, checks): each number compared, with its limit. Every count
    of wrong answers has the limit 0. A cell whose check compared nothing of
    a kind it ran is a fault of the benchmark, and raises."""
    kinds = {op["op"] for op in run.traffic["round"]} - {"update"}
    names = [f"{k}_wrong" for k in QUERY_OPS if k in kinds]
    if kinds & {"count", "range"}:
        names.append("ok_wrong")
    names.append("readback_wrong")
    empty = [k for k in sorted(kinds) + ["readback"] if run.checked[k] == 0]
    if empty:
        raise RuntimeError(f"the check compared no {empty} answers")
    checks = {n: {"value": run.checks[n], "limit": 0} for n in names}
    return all(c["value"] <= c["limit"] for c in checks.values()), checks
