"""`repro_torch.obs`: the dictionary path's spans and counters.

On tiny `lsm` dictionaries on the CPU: tracing off costs a shared no-op and
counts nothing; tracing on changes no answer and no state; each counter
equals a count made by hand. On the card (`cuda`-marked): the waits that
PyTorch's sync debug mode reports, call by call, equal `host_syncs`.
"""

import warnings

import numpy as np
import pytest
import torch

from repro_torch import obs
from repro_torch.api import Dictionary, QueryPlan
from repro_torch.core import semantics as sem

B = 16
LEVELS = 4
PLAN = QueryPlan(40, 24)


@pytest.fixture(autouse=True)
def tracing_off():
    obs.enable(False)
    obs.reset()
    yield
    obs.enable(False)
    obs.reset()


def _batch(gen, n, key_range=256, device="cpu"):
    keys = torch.randint(0, key_range, (n,), generator=gen, dtype=torch.int32).to(device)
    values = torch.randint(0, 1 << 20, (n,), generator=gen, dtype=torch.int32).to(device)
    is_delete = (torch.rand(n, generator=gen) < 0.3).to(device)
    return keys, values, is_delete


def _filled(seed: int, calls: int = 9, validate: bool = True, device="cpu"):
    """A dictionary after `calls` ragged update calls (a few carries, a
    half-full buffer, stale copies and tombstones), and the generator."""
    gen = torch.Generator().manual_seed(seed)
    d = Dictionary.create("lsm", capacity=B * ((1 << LEVELS) - 1), batch_size=B, validate=validate,
                          device=device)
    for k in range(calls):
        d = d.update(*_batch(gen, (B, 5, 2 * B + 3)[k % 3], device=device))
    return d, gen


def _windows(gen, n=12, key_range=256):
    k1 = torch.randint(0, key_range, (n,), generator=gen, dtype=torch.int32)
    return k1, k1 + torch.randint(0, 64, (n,), generator=gen, dtype=torch.int32)


def _state(d):
    s = d.state
    tensors = [s.arena_kv, s.arena_val, s.buf_kv, s.buf_val, s.buf_seq, s.lvl_debt]
    return [t.clone() for t in tensors], (s.r, s.buf_n, s.overflowed)


def _run_op(op, d, gen):
    """One call -> (its outputs, the handle after it)."""
    if op == "update":
        return (), d.update(*_batch(gen, 2 * B + 7))
    if op == "cleanup":
        return (), d.cleanup()
    if op == "lookup":
        return d.lookup(torch.randint(0, 300, (50,), generator=gen, dtype=torch.int32)), d
    return getattr(d, op)(*_windows(gen), PLAN), d


def test_off_span_is_one_shared_noop_and_nothing_is_counted():
    assert not obs.enabled()
    assert obs.span("api.update") is obs.span("queries.tile")
    with obs.span("api.update"):
        pass
    d, gen = _filled(1)
    d = d.cleanup()
    d.lookup(torch.arange(8, dtype=torch.int32))
    d.count(*_windows(gen), PLAN)
    d.range(*_windows(gen), PLAN)
    assert obs.counters() == {}
    obs.enable(True)
    assert obs.span("api.update") is not obs.span("api.update")


@pytest.mark.parametrize("op", ["update", "lookup", "count", "range", "cleanup"])
def test_tracing_on_changes_no_output_and_no_state(op):
    results = []
    for on in (False, True):
        d, gen = _filled(7)
        obs.enable(on)
        with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]):
            out, d = _run_op(op, d, gen)
        obs.enable(False)
        results.append(([t.clone() for t in out], _state(d)))
    (out_off, (st_off, host_off)), (out_on, (st_on, host_on)) = results
    assert host_off == host_on
    for a, b in zip(out_off + st_off, out_on + st_on):
        assert a.dtype == b.dtype and torch.equal(a, b)
    assert len(out_off) == {"update": 0, "cleanup": 0, "lookup": 2, "count": 2, "range": 4}[op]


def test_the_program_spans_reach_the_profiler():
    d, gen = _filled(2)
    obs.enable(True)
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        d = d.update(*_batch(gen, 2 * B))
        d = d.cleanup()
        d.lookup(torch.arange(8, dtype=torch.int32))
        d.count(*_windows(gen), PLAN)
        d.range(*_windows(gen), PLAN)
    names = {e.key for e in prof.key_averages() if e.key.startswith(obs.PREFIX)}
    expected = ["api.update", "api.cleanup", "api.lookup", "api.count", "api.range", "lsm.stage",
                "ops.sort_recency", "cascade.push", "cascade.merge", "cascade.debt", "cleanup",
                "cleanup.merge", "cleanup.compact", "cleanup.redistribute", "queries.lookup",
                "queries.bounds", "queries.tile", "queries.row_sort", "queries.select"]
    assert names == {obs.PREFIX + n for n in expected}


def test_carries_per_level_follow_the_bits_of_r():
    """Ragged calls from empty: the write buffer's arithmetic says which
    sub-batches push; push k (r = k before it) lands in level j where r is
    2^j - 1 modulo 2^(j+1)."""
    gen = torch.Generator().manual_seed(3)
    d = Dictionary.create("lsm", capacity=B * ((1 << 6) - 1), batch_size=B, device="cpu")
    obs.enable(True)
    pending = pushes = 0
    for n in (5, 16, 40, 3, 16, 16, 27, 1, 64, 9, 33, 16, 100, 2, 48):
        d = d.update(*_batch(gen, n))
        for s in range(0, n, B):
            pending += min(B, n - s)
            if pending > B:
                pushes, pending = pushes + 1, pending - B
    assert (d.state.r, d.pending()) == (pushes, pending)
    expected = {}
    for r in range(pushes):
        j = next(j for j in range(8) if r % (2 << j) == (1 << j) - 1)
        expected[f"cascade.carries.L{j}"] = expected.get(f"cascade.carries.L{j}", 0) + 1
    c = obs.counters()
    assert {k: v for k, v in c.items() if k.startswith("cascade.carries.")} == expected
    assert c["cascade.merged_elements"] == sum(n * (B << int(k[len("cascade.carries.L"):]))
                                               for k, n in expected.items())
    assert "host_syncs" not in c


def test_cleanup_counts_its_residents_survivors_and_three_waits():
    d, _ = _filled(4)
    resident = d.state.r * B + d.pending()
    live = int(d.size())
    obs.enable(True)
    d = d.cleanup()
    c = obs.counters()
    assert (c["cleanup.resident"], c["cleanup.survivors"], c["host_syncs"]) == (resident, live, 3)
    assert d.state.r * B >= live > (d.state.r - 1) * B
    d = d.cleanup()
    assert obs.counters()["host_syncs"] == 6


@pytest.mark.parametrize("op", ["count", "range"])
def test_tile_counters_equal_the_window_hits(op):
    """Slots: windows x max_candidates. Candidates: per window, the resident
    elements (stale copies and tombstones included, placebos not) whose key
    lies in it, at most max_candidates, summed."""
    d, gen = _filled(5, calls=14)
    k1, k2 = _windows(gen, n=20)
    s = d.state
    orig = sem.original_key(s.arena_kv).to(torch.int64)
    orig = orig[orig != sem.PLACEBO_KEY]
    hits = ((orig[None, :] >= k1[:, None]) & (orig[None, :] <= k2[:, None])).sum(1)
    assert int(hits.max()) > PLAN.max_candidates > int(hits.min())   # some windows overflow
    obs.enable(True)
    getattr(d, op)(k1, k2, PLAN)
    c = obs.counters()
    assert c["queries.tile_slots"] == 20 * PLAN.max_candidates
    assert c["queries.candidates"] == int(hits.clamp(max=PLAN.max_candidates).sum())


def test_updates_and_queries_without_cleanup_do_not_wait():
    d, gen = _filled(6, calls=2)
    obs.enable(True)
    for _ in range(6):
        d = d.update(*_batch(gen, B + 3))
    d.lookup(torch.arange(8, dtype=torch.int32))
    d.count(*_windows(gen), PLAN)
    d.range(*_windows(gen), PLAN)
    assert obs.counters().get("host_syncs", 0) == 0


def _on_card_sequence(d, gen, dev):
    """(name, call) pairs over a filled dictionary on the card; each call
    returns the handle after it."""
    def upd(keys, values, is_delete, **kw):
        return lambda h: h.update(keys, values, is_delete, **kw)

    def query(op, *args):
        def call(h):
            getattr(h, op)(*args)
            return h
        return call

    calls = [(f"update {i}", upd(*_batch(gen, (B, 3 * B + 5)[i % 2], device=dev))) for i in range(6)]
    calls += [("cleanup", lambda h: h.cleanup())]
    calls += [(f"update {i}", upd(*_batch(gen, B + 1, device=dev))) for i in range(6, 9)]
    k1, k2 = _windows(gen)
    calls += [("lookup", query("lookup", torch.arange(64, dtype=torch.int32, device=dev))),
              ("count", query("count", k1.to(dev), k2.to(dev), PLAN)),
              ("range", query("range", k1.to(dev), k2.to(dev), PLAN))]
    keys, values, is_delete = _batch(gen, 2 * B)
    calls += [("update, host arrays", upd(keys.numpy(), values.numpy(), is_delete.numpy())),
              ("update, valid on the card", upd(keys.to(dev), values.to(dev), is_delete.to(dev),
                                                valid=(torch.arange(2 * B) % 3 > 0).to(dev))),
              ("lookup, host array", query("lookup", np.arange(64, dtype=np.int32)))]
    return calls


@pytest.mark.cuda
@pytest.mark.parametrize("validate", [False, True])
def test_host_syncs_equal_the_waits_the_card_reports(validate):
    """Every wait that `torch.cuda.set_sync_debug_mode("warn")` reports,
    call by call, is one `host_syncs` count; without validation, updates
    and queries on device inputs wait nowhere outside cleanup."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    dev = torch.device("cuda:0")
    warm, gen = _filled(8, validate=validate, device=dev)   # builds and loads every kernel first
    for _, call in _on_card_sequence(warm, gen, dev):
        warm = call(warm)
    torch.cuda.synchronize()
    d, gen = _filled(8, validate=validate, device=dev)
    seen = []
    obs.enable(True)
    try:
        for name, call in _on_card_sequence(d, gen, dev):
            before = obs.counters().get("host_syncs", 0)
            torch.cuda.set_sync_debug_mode("warn")
            with warnings.catch_warnings(record=True) as caught:
                warnings.simplefilter("always")
                d = call(d)
            torch.cuda.set_sync_debug_mode(0)
            reported = sum("synchroniz" in str(w.message) for w in caught)
            seen.append((name, reported, obs.counters().get("host_syncs", 0) - before))
    finally:
        torch.cuda.set_sync_debug_mode(0)
        obs.enable(False)
    assert all(r == c for _, r, c in seen), seen
    device_inputs = [c for name, _, c in seen if name != "cleanup" and "host" not in name and "valid" not in name]
    assert dict((n, c) for n, _, c in seen)["cleanup"] == 3
    if not validate:
        assert device_inputs == [0] * len(device_inputs), seen
