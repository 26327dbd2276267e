"""The port's serving layer against repro.serve, on the CPU.

Every scenario is written once over a namespace of either package and run
through both: the `DictionaryServer` replaying `make_trace` traffic (ticket
results, `ServerStats` and `pending_estimate()` after every step, for the
lsm and sorted_array backends), its tenant registry, admission policy and
occupancy hooks, `ServerPageTable`, and the standalone `pt_*` page table.
Results must be equal in value and dtype. The port's server is also held
against the port's own `replay_direct` and `replay_oracle`, and its entry
points against the card-by-default rule.
"""

import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.api import Dictionary as JaxDictionary
from repro.api import KeyDomainError as JaxKeyDomainError
from repro.core import semantics as jsem
from repro.serve import kvcache as jkv
from repro.serve import server as jserver
from repro.serve import traffic as jtraffic
from repro_torch import convert
from repro_torch.api import Dictionary, KeyDomainError
from repro_torch.serve import kvcache as tkv
from repro_torch.serve import server as tserver
from repro_torch.serve import traffic as ttraffic

JAX = types.SimpleNamespace(
    name="jax", server=jserver, traffic=jtraffic, kv=jkv, Dictionary=JaxDictionary,
    KeyDomainError=JaxKeyDomainError, device={})
TORCH = types.SimpleNamespace(
    name="torch", server=tserver, traffic=ttraffic, kv=tkv, Dictionary=Dictionary,
    KeyDomainError=KeyDomainError, device={"device": "cpu"})

BACKENDS = [
    pytest.param({"backend": "lsm", "num_levels": 8}, id="lsm"),
    pytest.param({"backend": "sorted_array", "capacity": 4096}, id="sorted_array"),
]


def host(x):
    if isinstance(x, torch.Tensor):
        return x.numpy()
    if isinstance(x, jax.Array):
        return np.asarray(x)
    return x


def assert_same(a, b, where="result"):
    """Equal trees: arrays by value and dtype, everything else by ==."""
    a, b = host(a), host(b)
    if isinstance(a, (tuple, list)):
        assert isinstance(b, (tuple, list)) and len(a) == len(b), where
        for i, (x, y) in enumerate(zip(a, b)):
            assert_same(x, y, f"{where}[{i}]")
    elif isinstance(a, dict):
        assert isinstance(b, dict) and a.keys() == b.keys(), where
        for k in a:
            assert_same(a[k], b[k], f"{where}[{k!r}]")
    elif isinstance(a, np.ndarray) or isinstance(b, np.ndarray):
        a, b = np.asarray(a), np.asarray(b)
        assert a.dtype == b.dtype, f"{where}: dtype {a.dtype} != {b.dtype}"
        np.testing.assert_array_equal(a, b, err_msg=where)
    else:
        assert a == b, f"{where}: {a!r} != {b!r}"


def both(scenario, *args, **kwargs):
    """Run `scenario(pkg, ...)` for the reference and the port; equal results."""
    exp = scenario(JAX, *args, **kwargs)
    got = scenario(TORCH, *args, **kwargs)
    assert_same(exp, got)
    return got


def make_server(pkg, **config):
    return pkg.server.DictionaryServer(pkg.server.ServerConfig(**config, **pkg.device))


def record_steps(srv, log):
    """Log (device steps issued, pending_estimate, device pending, stats)
    after every step(), including the ones result() and drain() run."""
    step = srv.step

    def logged():
        n = step()
        log.append((n, srv.pending_estimate(), int(srv.dictionary.pending()), srv.stats.as_dict()))
        return n

    srv.step = logged


# -- traffic replay -----------------------------------------------------------


def replay(pkg, mix, opts):
    tenants, trace = pkg.traffic.make_trace(mix, num_tenants=4, key_space=256, events=24, seed=11)
    srv = make_server(pkg, batch_size=64, **opts)
    for t in tenants:
        srv.register_tenant(t, key_space=256)
    log = []
    record_steps(srv, log)
    results = pkg.traffic.replay_server(srv, trace, step_every=16)
    return results, log, srv.stats.as_dict(), srv.pending_estimate()


@pytest.mark.parametrize("opts", BACKENDS)
@pytest.mark.parametrize("mix", ["decode_trickle", "mixed"])
def test_replay_matches_reference(mix, opts):
    results, log, _, pending = both(replay, mix, opts)
    assert len(log) >= 2
    for _, model, device, _ in log:
        assert model == device  # the host model is exact for one shard
    assert pending == log[-1][1]


@pytest.mark.parametrize("mix", jtraffic.MIXES)
def test_traces_match_reference(mix):
    def trace(pkg):
        tenants, ops = pkg.traffic.make_trace(mix, num_tenants=5, key_space=128, events=40, seed=3, window=16)
        return tenants, [(op.tenant, op.kind, op.keys, op.values, op.is_delete, op.k1, op.k2, op.max_results)
                         for op in ops]
    both(trace)


@pytest.mark.parametrize("opts", BACKENDS)
@pytest.mark.parametrize("mix", ["decode_trickle", "mixed"])
def test_server_matches_direct_and_oracle(mix, opts):
    """The port's server against one private port `Dictionary` per tenant,
    and its end state against the per-tenant dict oracle."""
    tenants, trace = ttraffic.make_trace(mix, num_tenants=4, key_space=256, events=24, seed=11)
    cfg = tserver.ServerConfig(batch_size=64, device="cpu", **opts)
    srv = tserver.DictionaryServer(cfg)
    for t in tenants:
        srv.register_tenant(t, key_space=256)
    got = ttraffic.replay_server(srv, trace, step_every=16)
    want = ttraffic.replay_direct(cfg.make_dictionary, tenants, trace)
    for i, (op, g, w) in enumerate(zip(trace, got, want)):
        if op.kind == "range":
            w = (w[0][:, :op.max_results], w[1][:, :op.max_results], w[2], w[3])
        assert_same(w, g, f"op{i} {op.kind}")
    oracles = ttraffic.replay_oracle(trace)
    all_keys = np.arange(256)
    tickets = {t: srv.submit_lookup(t, all_keys) for t in tenants}
    for t in tenants:
        found, vals = tickets[t].result()
        o = oracles.get(t, {})
        np.testing.assert_array_equal(found, [int(k) in o for k in all_keys])
        np.testing.assert_array_equal(vals, [o.get(int(k), 0) for k in all_keys])


def coalesce(pkg):
    srv = make_server(pkg, batch_size=64, num_levels=8)
    for i in range(8):
        srv.register_tenant(f"t{i}", key_space=64)
    for i in range(8):
        srv.submit_update(f"t{i}", np.arange(4), np.full(4, i, np.int32))
    issued = srv.step()
    tickets = [srv.submit_lookup(f"t{i}", np.arange(4)) for i in range(8)]
    return issued, [t.result() for t in tickets], srv.stats.as_dict()


def test_single_step_coalesces_homogeneous_phase():
    issued, results, stats = both(coalesce)
    assert issued == 1
    assert all(f.all() and (v == i).all() for i, (f, v) in enumerate(results))
    assert stats["ops_per_device_step"] >= 8.0


# -- tenants ------------------------------------------------------------------


def registration(pkg):
    srv = make_server(pkg, batch_size=32, num_levels=6)
    big = srv.register_tenant("big", key_space=jsem.MAX_USER_KEY - 100)
    with pytest.raises(pkg.KeyDomainError, match="overflow MAX_USER_KEY") as err:
        srv.register_tenant("straw", key_space=1024)
    small = srv.register_tenant("small", key_space=64)
    with pytest.raises(ValueError, match="already registered"):
        srv.register_tenant("small", key_space=4)
    return big.base, small.base, small.key_space, str(err.value), srv.tenants


def test_registration_overflow_matches_reference():
    both(registration)


def local_domain(pkg):
    srv = make_server(pkg, batch_size=32, num_levels=6)
    srv.register_tenant("a", key_space=100)
    messages = []
    for call in (lambda: srv.submit_update("a", np.asarray([100]), np.asarray([1], np.int32)),
                 lambda: srv.submit_lookup("a", np.asarray([-1])),
                 lambda: srv.submit_lookup("a", np.asarray([1.5])),
                 lambda: srv.submit_count("a", np.asarray([1, 2]), np.asarray([3])),
                 lambda: srv.submit_range("a", np.asarray([1]), np.asarray([3]), max_results=0)):
        with pytest.raises((pkg.KeyDomainError, ValueError)) as err:
            call()
        messages.append((type(err.value).__name__, str(err.value)))
    with pytest.raises(KeyError, match="unknown tenant"):
        srv.submit_lookup("nobody", np.asarray([0]))
    return messages, srv.stats.as_dict()


def test_local_domain_checked_at_submit():
    messages, stats = both(local_domain)
    assert [m[0] for m in messages[:3]] == ["KeyDomainError"] * 3
    assert stats["submitted"] == 0


def isolation(pkg):
    srv = make_server(pkg, batch_size=64, num_levels=8)
    srv.register_tenant("a", key_space=512)
    srv.register_tenant("b", key_space=512)
    keys = np.arange(0, 512, 7, dtype=np.int64)
    srv.submit_update("a", keys, (keys + 1).astype(np.int32))
    srv.submit_update("b", keys[:3], np.full(3, 99, np.int32))
    tickets = [srv.submit_count("a", np.asarray([0]), np.asarray([511])),
               srv.submit_count("b", np.asarray([0]), np.asarray([511])),
               srv.submit_range("a", np.asarray([0]), np.asarray([511]), max_results=128),
               srv.submit_lookup("b", keys[3:10])]
    return [t.result() for t in tickets]


def test_cross_tenant_isolation():
    (ca, _), (cb, _), (rk, rv, rc, _), (found, _) = both(isolation)
    keys = np.arange(0, 512, 7)
    assert int(ca[0]) == int(rc[0]) == len(keys) and int(cb[0]) == 3
    np.testing.assert_array_equal(rk[0, :len(keys)], keys)
    np.testing.assert_array_equal(rv[0, :len(keys)], keys + 1)
    assert not found.any()


def deregistration(pkg, backend_opts):
    srv = make_server(pkg, batch_size=64, **backend_opts)
    a = srv.register_tenant("a", key_space=256)
    srv.register_tenant("keep", key_space=256)
    keys = np.arange(0, 256, 5, dtype=np.int64)
    srv.submit_update("a", keys, np.ones(len(keys), np.int32))
    srv.submit_update("keep", keys, np.full(len(keys), 7, np.int32))
    srv.drain()
    size_before = int(srv.dictionary.size())
    removed = srv.deregister_tenant("a", chunk=16)  # several scan rounds
    size_after = int(srv.dictionary.size())
    b = srv.register_tenant("reborn", key_space=256)
    counts = srv.submit_count("reborn", np.asarray([0]), np.asarray([255])).result()
    survivor = srv.submit_lookup("keep", keys).result()
    return (removed, size_before, size_after, a.base, b.base, srv.tenants, counts, survivor,
            srv.stats.as_dict(), srv.pending_estimate())


@pytest.mark.parametrize("backend_opts", [{"num_levels": 8}, {"backend": "sorted_array", "capacity": 1024}],
                         ids=["lsm", "sorted_array"])
def test_deregistration_tombstones_full_range(backend_opts):
    removed, before, after, a_base, b_base, tenants, (counts, _), (found, vals), _, _ = both(
        deregistration, backend_opts)
    assert removed == 52 and after == before - 52
    assert a_base == b_base and "a" not in tenants
    assert int(counts[0]) == 0
    assert found.all() and (vals == 7).all()


def extent_reuse(pkg):
    srv = make_server(pkg, batch_size=64, num_levels=8)
    first = [srv.register_tenant(f"t{i}", key_space=1000).base for i in range(4)]
    srv.deregister_tenant("t1")
    mid = srv.register_tenant("mid", key_space=600).base  # first fit, split
    for name in ("t0", "t2", "t3", "mid"):
        srv.deregister_tenant(name)
    big = srv.register_tenant("big", key_space=3000).base
    return first, mid, big, srv._free_extents, srv._next_base


def test_extent_reuse_after_fragmentation():
    first, mid, big, _, _ = both(extent_reuse)
    assert mid == first[1] and big == first[0]


# -- admission policy and occupancy -------------------------------------------


def pending_model(pkg, flush_at_fraction, flush_threshold):
    srv = make_server(pkg, backend="lsm", batch_size=64, num_levels=8, flush_at_fraction=flush_at_fraction,
                      flush_threshold=flush_threshold)
    srv.register_tenant("a", key_space=4096)
    rng = np.random.default_rng(0)
    seen = []
    for _ in range(12):
        n = int(rng.integers(1, 90))
        srv.submit_update("a", rng.choice(4096, n, replace=False), np.ones(n, np.int32))
        srv.step()
        seen.append((srv.pending_estimate(), int(srv.dictionary.pending()), srv.stats.flushes))
    return seen


@pytest.mark.parametrize("flush_at_fraction,flush_threshold", [(0.8, None), (0.5, None), (1.0, 20)])
def test_pending_model_matches_reference(flush_at_fraction, flush_threshold):
    seen = both(pending_model, flush_at_fraction, flush_threshold)
    assert all(model == device for model, device, _ in seen)


def flush_policy(pkg, opts):
    srv = make_server(pkg, batch_size=64, flush_at_fraction=0.5, **opts)
    srv.register_tenant("a", key_space=4096)
    srv.submit_update("a", np.arange(40), np.ones(40, np.int32))
    srv.step()
    return srv.stats.flushes, srv.pending_estimate(), int(srv.dictionary.pending())


@pytest.mark.parametrize("opts", BACKENDS)
def test_flush_policy(opts):
    flushes, model, device = both(flush_policy, opts)
    assert (flushes, model, device) == ((1, 0, 0) if opts["backend"] == "lsm" else (0, 0, 0))


def idle_maintenance(pkg):
    srv = make_server(pkg, backend="lsm", batch_size=32, num_levels=8, maintenance_budget=64)
    srv.register_tenant("a", key_space=4096)
    keys = np.arange(256)
    srv.submit_update("a", keys, np.ones(256, np.int32))
    srv.submit_update("a", keys, np.ones(256, np.int32), is_delete=np.ones(256, bool))
    stats = srv.drain().as_dict()
    occ = srv.occupancy()
    return stats, [int(x) for x in occ], int(srv.dictionary.size())


def test_drain_runs_idle_maintenance():
    stats, _, size = both(idle_maintenance)
    assert stats["maintains"] >= 1 and size == 0


def occupancy_lsm(pkg):
    b = 32
    d = pkg.Dictionary.create("lsm", batch_size=b, num_levels=8, **pkg.device)
    seen = [d.buffered]
    for step in range(4):
        d = d.insert(np.arange(10 * step, 10 * step + 10), np.ones(10, np.int32))
        seen.append(([int(x) for x in d.occupancy()], int(d.flush_cost_estimate())))
        d = d.flush()
        seen.append(([int(x) for x in d.occupancy()], int(d.flush_cost_estimate())))
    d = d.delete(np.arange(100, 110)).flush()
    seen.append([int(x) for x in d.occupancy()])
    return seen


def occupancy_sa(pkg):
    d = pkg.Dictionary.create("sorted_array", capacity=256, batch_size=32, **pkg.device)
    seen = [d.buffered]
    d = d.insert(np.arange(10), np.ones(10, np.int32))
    seen.append(([int(x) for x in d.occupancy()], int(d.flush_cost_estimate())))
    d = d.delete(np.arange(3)).flush()
    seen.append(([int(x) for x in d.occupancy()], int(d.flush_cost_estimate())))
    return seen


@pytest.mark.parametrize("scenario", [occupancy_lsm, occupancy_sa], ids=["lsm", "sorted_array"])
def test_occupancy_matches_reference(scenario):
    seen = both(scenario)
    assert seen[0] is (scenario is occupancy_lsm)


# -- the page table -----------------------------------------------------------


def page_table_alone(pkg):
    srv = make_server(pkg, batch_size=64, num_levels=8)
    pt = pkg.kv.ServerPageTable(srv, num_pages=64, num_seqs=8)
    slots, _ = pt.allocate([1, 1, 1, 2], [0, 1, 2, 0])
    out = [slots, pt.lookup([1, 1, 1, 2], [0, 1, 2, 0]).result(), pt.seq_page_count([1, 2, 3]).result(),
           pt.seq_pages([1], max_pages=8).result(), pt.free_count, pt.evict([1, 1, 7], [0, 1, 0]),
           pt.free_count, pt.lookup([1, 1, 1], [0, 1, 2]).result()]
    with pytest.raises(ValueError, match="num_seqs"):
        pt.lookup([8], [0])
    return out, srv.stats.as_dict()


def test_server_page_table_matches_reference():
    (slots, (found, got), (counts, ok), (pages, _, _, _), free0, freed, free1, (found2, _)), _ = both(
        page_table_alone)
    assert len(set(slots.tolist())) == 4 and found.all()
    np.testing.assert_array_equal(got, slots)
    np.testing.assert_array_equal(counts, [3, 1, 0])
    np.testing.assert_array_equal(pages[0, :3], [0, 1, 2])
    assert (pages[0, 3:] == -1).all() and freed == 2 and free1 == free0 + 2
    np.testing.assert_array_equal(found2, [False, False, True])


def page_table_with_others(pkg):
    srv = make_server(pkg, batch_size=64, num_levels=8)
    pt = pkg.kv.ServerPageTable(srv, num_pages=32, num_seqs=4)
    srv.register_tenant("app", key_space=1024)
    pt.allocate([0, 1], [0, 0])
    srv.submit_update("app", np.asarray([5]), np.asarray([50], np.int32))
    c = pt.seq_page_count([0, 1])
    f = srv.submit_lookup("app", np.asarray([5]))
    return c.result(), f.result(), srv.stats.as_dict()


def test_page_table_coexists_with_other_tenants():
    (counts, _), (found, vals), _ = both(page_table_with_others)
    np.testing.assert_array_equal(counts, [1, 1])
    assert found.all() and int(vals[0]) == 50


def pool_exhaustion(pkg):
    srv = make_server(pkg, batch_size=32, num_levels=6)
    pt = pkg.kv.ServerPageTable(srv, num_pages=2, num_seqs=2)
    pt.allocate([0], [0])
    with pytest.raises(RuntimeError, match="exhausted") as err:
        pt.allocate([0, 0], [1, 2])
    return str(err.value), pt.free_count


def test_pool_exhaustion():
    both(pool_exhaustion)


PT = dict(num_pages=128, update_batch=16, num_levels=6)


def pt_lanes(seqs, pages):
    """tests/test_serving_integration.py's padding: lanes past len(seqs) invalid."""
    b = PT["update_batch"]
    return (np.resize(np.asarray(seqs, np.int32), b), np.resize(np.asarray(pages, np.int32), b),
            np.arange(b) < len(seqs))


def pt_state(pkg, state):
    """(free_count, free_list, index state as numpy) of a page table."""
    if pkg is JAX:
        index = jax.device_get(state.index.state)._asdict()
    else:
        index = convert.lsm_state_to_numpy(state.index.state)
    return state.free_count, state.free_list, index


def pt_scenario(pkg, maintenance_budget=None):
    kv = pkg.kv
    cfg = kv.PageTableConfig(**PT, maintenance_budget=maintenance_budget, **pkg.device)
    arr = jnp.asarray if pkg is JAX else torch.as_tensor
    out = []
    state = kv.pt_init(cfg)
    state, slots = kv.pt_allocate(cfg, state, *map(arr, pt_lanes([1, 1, 1, 2, 3, 3, 3, 3, 3, 4, 4],
                                                                 [0, 1, 2, 0, 0, 1, 2, 3, 4, 0, 1])))
    out += [slots, kv.pt_lookup(cfg, state, arr([1, 1, 1, 2, 9]), arr([0, 1, 2, 0, 0])), pt_state(pkg, state)]
    state = kv.pt_evict(cfg, state, *map(arr, pt_lanes([1, 1, 7], [0, 1, 0])))
    out += [kv.pt_lookup(cfg, state, arr([1, 1, 2]), arr([0, 1, 0])), pt_state(pkg, state)]
    out += [kv.pt_seq_page_count(cfg, state, arr([3, 4, 5, 1]), max_candidates=64),
            kv.pt_seq_pages(cfg, state, arr([3, 1]), max_pages=8, max_candidates=64)]
    rng = np.random.default_rng(7)
    for step in range(4):
        seqs, pages = rng.integers(1, 5, 16).astype(np.int32), rng.integers(0, 8, 16).astype(np.int32)
        valid = np.arange(16) < 12
        state, slots = kv.pt_allocate(cfg, state, arr(seqs), arr(pages), arr(valid))
        out.append(slots)
        if step % 2:
            state = kv.pt_evict(cfg, state, arr(seqs), arr(pages), arr(valid))
        if maintenance_budget is not None:
            state = kv.pt_maintain(cfg, state)
        out.append(pt_state(pkg, state))
    state = kv.pt_flush(cfg, state)
    out.append(pt_state(pkg, state))
    qs, qp = arr(np.repeat(np.arange(1, 5, dtype=np.int32), 8)), arr(np.tile(np.arange(8, dtype=np.int32), 4))
    out.append(kv.pt_lookup(cfg, state, qs, qp))
    state = kv.pt_compact(cfg, state)
    out += [kv.pt_lookup(cfg, state, qs, qp), pt_state(pkg, state), int(state.lsm.r)]
    return out


@pytest.mark.parametrize("maintenance_budget", [None, 48])
def test_standalone_page_table_matches_reference(maintenance_budget):
    out = both(pt_scenario, maintenance_budget)
    assert out[-1] <= 1


# -- the card by default ------------------------------------------------------


def test_entry_points_default_to_the_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        tserver.DictionaryServer(tserver.ServerConfig(batch_size=8, num_levels=4))
    with pytest.raises(RuntimeError, match="CUDA"):
        tkv.pt_init(tkv.PageTableConfig(num_pages=8, update_batch=8, num_levels=4))
    srv = tserver.DictionaryServer(tserver.ServerConfig(batch_size=8, num_levels=4, device="cpu"))
    assert srv.dictionary.device == torch.device("cpu")
