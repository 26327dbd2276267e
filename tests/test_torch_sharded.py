"""The port's range-partitioned sharded LSM against repro's, on the CPU.

The reference runs `shard_map` over tests/conftest.py's 4 forced host
devices; the port runs every shard on "cpu" (a device named once per shard).
The same numpy-seeded inputs go through both: `owner_of`/`shard_bounds`,
each `dist_*` operation at 4 shards with the states compared shard by shard
(`convert.dist_state_to_numpy`), `assemble_range` on hand-built input, the
facade under tests/harness.py's op sequences at 1, 2 and 4 shards (the cases
of tests/test_backend_parity.py), and the mesh and option errors. Every
comparison is exact, dtypes included.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import harness
from repro.api import CapabilityError as JaxCapabilityError
from repro.api import Dictionary as JaxDictionary
from repro.api import QueryPlan as JaxQueryPlan
from repro.compat import AxisType, make_mesh
from repro.core import distributed as jdist
from repro.core.lsm import LSMConfig as JaxLSMConfig
from repro_torch import convert
from repro_torch.api import CapabilityError, Dictionary, QueryPlan
from repro_torch.core import distributed as tdist
from repro_torch.core import semantics as sem
from repro_torch.core.lsm import LSMConfig
from repro_torch.launch.mesh import ShardMesh, make_shard_mesh

B = 8
LEVELS = 4          # per-shard capacity 8 * 15 = 120
S = 4


def host(x):
    return x.numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def assert_same(exp, got, where="result"):
    """Equal trees of arrays and scalars, dtypes included."""
    if isinstance(exp, (tuple, list)):
        assert isinstance(got, (tuple, list)) and len(exp) == len(got), where
        for i, (a, b) in enumerate(zip(exp, got)):
            assert_same(a, b, f"{where}[{i}]")
        return
    a, b = host(exp), host(got)
    if isinstance(got, (int, bool)):  # the port's host ints stand for int32 scalars
        a, b = a.item(), got
        assert a == b, f"{where}: {a} != {b}"
        return
    assert a.dtype == b.dtype, f"{where}: dtype {a.dtype} != {b.dtype}"
    np.testing.assert_array_equal(a, b, err_msg=where)


def assert_states_equal(jstates, tstates, where="state"):
    exp = jax.device_get(jstates)._asdict()
    got = convert.dist_state_to_numpy(tstates)
    assert set(exp) == set(got)
    for name in exp:
        assert_same(exp[name], got[name], f"{where}.{name}")


def configs(num_shards=S, b=B, levels=LEVELS):
    jcfg = jdist.DistLSMConfig(local=JaxLSMConfig(batch_size=b, num_levels=levels), num_shards=num_shards)
    tcfg = tdist.DistLSMConfig(local=LSMConfig(batch_size=b, num_levels=levels), num_shards=num_shards)
    jmesh = make_mesh((num_shards,), ("shard",), axis_types=(AxisType.Auto,), devices=jax.devices()[:num_shards])
    tmesh = make_shard_mesh(num_shards, devices=["cpu"] * num_shards)
    return jcfg, jmesh, tcfg, tmesh


def fuzz_keys(range_size, num_shards, rng):
    keys = {0, 1, sem.MAX_USER_KEY - 1, sem.MAX_USER_KEY}
    for s in range(1, num_shards + 1):
        for d in (-1, 0, 1):
            k = s * range_size + d
            if 0 <= k <= sem.MAX_USER_KEY:
                keys.add(k)
    keys |= {int(k) for k in rng.integers(0, sem.MAX_USER_KEY + 1, 256)}
    return np.array(sorted(keys), dtype=np.int32)


# -- partitioning --------------------------------------------------------------


@pytest.mark.parametrize("num_shards", [1, 2, 3, 4, 5, 7, 8])
def test_owner_and_bounds_match_reference(num_shards):
    jcfg, tcfg = (jdist.DistLSMConfig(local=c(batch_size=8, num_levels=2), num_shards=num_shards)
                  for c in (JaxLSMConfig, LSMConfig))
    assert tcfg.range_size == jcfg.range_size
    keys = fuzz_keys(tcfg.range_size, num_shards, np.random.default_rng(num_shards))
    assert_same(jdist.owner_of(jcfg, keys), tdist.owner_of(tcfg, keys), "owner_of")
    assert_same(jdist.owner_of(jcfg, keys), tdist.owner_of(tcfg, torch.from_numpy(keys)), "owner_of(tensor)")
    for s in range(num_shards):
        assert tdist.shard_bounds(tcfg, s) == tuple(int(x) for x in jdist.shard_bounds(jcfg, s))
    lo, hi = tdist.shard_bounds(tcfg, num_shards - 1)
    assert lo <= sem.MAX_USER_KEY <= hi  # for S = 5 the last hi lies above PLACEBO_KEY


# -- the dist_* operations at 4 shards -------------------------------------------


def pool(kind, rng):
    rs = (sem.PLACEBO_KEY + S - 1) // S
    if kind == "skewed":              # every key in shard 0
        return np.arange(40, dtype=np.int64)
    if kind == "hot_last":            # every key in the last shard
        return (S - 1) * rs + np.arange(40, dtype=np.int64)
    return harness.key_pool(rng)      # boundary keys of 1, 2 and 4 shards + a cluster + spread


def encoded_batch(rng, keys_pool, n, p_delete=0.3):
    keys = rng.choice(keys_pool, n).astype(np.int32)
    dels = rng.random(n) < p_delete
    kv = np.where(dels, keys * 2, keys * 2 + 1).astype(np.int32)
    vals = np.where(dels, 0, rng.integers(-1000, 1000, n)).astype(np.int32)
    return kv, vals


@functools.lru_cache(maxsize=None)
def jitted(name, cfg, mesh, **static):
    """The reference's `dist_*` op bound and jitted once per (cfg, mesh, static options)."""
    return jax.jit(functools.partial(getattr(jdist, name), cfg, mesh, **static))


class Pair:
    """The same sharded state in both packages, with every read compared."""

    def __init__(self, kind, seed, num_shards=S):
        self.rng = np.random.default_rng(seed)
        self.pool = pool(kind, self.rng)
        self.jcfg, self.jmesh, self.tcfg, self.tmesh = configs(num_shards)
        self.j = jdist.dist_lsm_init(self.jcfg, self.jmesh)
        self.t = tdist.dist_lsm_init(self.tcfg, self.tmesh)
        k1, k2 = harness.query_ranges(self.pool)
        self.k1, self.k2 = k1.astype(np.int32), k2.astype(np.int32)
        self.q = np.unique(np.concatenate([self.pool, np.clip(self.pool + 1, 0, sem.MAX_USER_KEY)])).astype(np.int32)

    def apply(self, name, *args, **kwargs):
        self.j = jitted(name, self.jcfg, self.jmesh, **kwargs)(self.j, *(jnp.asarray(a) for a in args))
        self.t = getattr(tdist, name)(self.tcfg, self.tmesh, self.t, *(
            torch.from_numpy(a) if isinstance(a, np.ndarray) else a for a in args), **kwargs)
        assert_states_equal(self.j, self.t, name)

    def check_reads(self, mc=64, mr=32):
        j, t, jc, tc, jm, tm = self.j, self.t, self.jcfg, self.tcfg, self.jmesh, self.tmesh
        q, k1, k2 = self.q, self.k1, self.k2
        assert_same(jitted("dist_lookup", jc, jm)(j, jnp.asarray(q)), tdist.dist_lookup(tc, tm, t, torch.from_numpy(q)),
                    "lookup")
        for cands in (mc, 4):  # 4 candidates truncate some windows: ok flags
            assert_same(jitted("dist_count", jc, jm, max_candidates=cands)(j, jnp.asarray(k1), jnp.asarray(k2)),
                        tdist.dist_count(tc, tm, t, torch.from_numpy(k1), torch.from_numpy(k2), cands), "count")
            exp = jitted("dist_range", jc, jm, max_candidates=cands, max_results=mr)(j, jnp.asarray(k1), jnp.asarray(k2))
            got = tdist.dist_range(tc, tm, t, torch.from_numpy(k1), torch.from_numpy(k2), cands, mr)
            assert_same(exp, got, "range (shard-major)")
            for rows in (mr, 3):
                assert_same(jdist.assemble_range(*exp, rows), tdist.assemble_range(*got, rows), "assembled range")
        for name in ("dist_size", "dist_pending", "dist_occupancy", "dist_flush_cost"):
            assert_same(jitted(name, jc, jm)(j), getattr(tdist, name)(tc, tm, t), name)


@pytest.mark.parametrize("kind", ["spread", "skewed", "hot_last"])
def test_update_matches_reference(kind):
    """Direct b-wide batches: each shard takes every batch (r ticks on all
    shards, owned lanes or not) and the states stay equal, down to overflow
    once a skewed shard's levels are full."""
    p = Pair(kind, seed=1)
    for step in range(17):  # max_batches = 15: the last two overflow every shard
        p.apply("dist_update", *encoded_batch(p.rng, p.pool, B))
        if step in (0, 6, 16):
            p.check_reads()
    assert all(st.overflowed for st in p.t)


@pytest.mark.parametrize("kind", ["spread", "skewed"])
def test_stage_flush_match_reference(kind):
    """Sub-batches with count < b (and 0, and b) stage into shard-local
    buffers, which overflow and flush independently; explicit flushes at
    several thresholds."""
    p = Pair(kind, seed=2)
    for step, count in enumerate([3, 8, 0, 5, 1, 8, 7, 2, 8, 6, 4]):
        kv, vals = encoded_batch(p.rng, p.pool, B)
        kv[count:], vals[count:] = sem.PLACEBO_KV, sem.EMPTY_VALUE
        p.apply("dist_stage", kv, vals, count)
        if step % 4 == 3:
            p.check_reads()
        if step == 5:
            p.apply("dist_flush", min_pending=4)
    p.check_reads()
    p.apply("dist_flush")
    p.check_reads()
    assert p.tcfg.local.batch_size == B and tdist.dist_pending(p.tcfg, p.tmesh, p.t) == 0


@pytest.mark.parametrize("budget,only_if_debt", [(B, False), (3 * B, True), (7 * B, False), (7 * B, True),
                                                 (None, False)])
def test_maintain_and_cleanup_match_reference(budget, only_if_debt):
    """Churn over a small pool (stale versions and tombstones in every
    shard), then budgeted maintenance, with and without the debt gate, and
    a full cleanup."""
    p = Pair("spread", seed=3)
    small = p.pool[:: max(1, len(p.pool) // 10)]
    for _ in range(6):
        p.apply("dist_update", *encoded_batch(p.rng, small, B, p_delete=0.4))
    kv, vals = encoded_batch(p.rng, small, B)
    p.apply("dist_stage", kv, vals, 5)
    p.apply("dist_maintain", budget=budget, only_if_debt=only_if_debt)
    p.check_reads()
    p.apply("dist_maintain", budget=budget, only_if_debt=only_if_debt)  # no debt left in the prefix
    p.apply("dist_cleanup")
    p.check_reads()


@pytest.mark.parametrize("kind,n", [("spread", 37), ("skewed", 40), ("spread", 120)])
def test_bulk_build_matches_reference(kind, n):
    """Each shard's r = ceil(owned / b) from one host read; no debt, no
    overflow, a fresh buffer; then updates on top."""
    p = Pair(kind, seed=4)
    rng = np.random.default_rng(n)
    space = np.unique(np.concatenate([p.pool, rng.integers(0, sem.MAX_USER_KEY + 1, 2 * n)]))
    keys = rng.choice(space, n, replace=False).astype(np.int32)
    vals = rng.integers(-1000, 1000, n).astype(np.int32)
    p.j = jitted("dist_bulk_build", p.jcfg, p.jmesh)(jnp.asarray(keys), jnp.asarray(vals))
    p.t = tdist.dist_bulk_build(p.tcfg, p.tmesh, torch.from_numpy(keys), torch.from_numpy(vals))
    assert_states_equal(p.j, p.t, "bulk build")
    p.check_reads()
    p.apply("dist_update", *encoded_batch(p.rng, keys, B))
    p.check_reads()


def test_bulk_build_past_per_shard_capacity_raises_in_both():
    jcfg, jmesh, tcfg, tmesh = configs()
    keys = np.arange(tcfg.local.capacity + 1, dtype=np.int32) * 1000  # spread: no shard would overflow
    for build, cfg, mesh in ((jdist.dist_bulk_build, jcfg, jmesh), (tdist.dist_bulk_build, tcfg, tmesh)):
        with pytest.raises(ValueError, match="exceeds per-shard capacity 120"):
            build(cfg, mesh, keys, keys)


def test_assemble_range_truncation_matches_reference():
    """Shard-major rows built by hand: shard 1 clipped its own window
    (count > m), query 2's total passes max_results, query 3 is empty."""
    m, nq = 4, 4
    counts = np.array([[2, 0, 3, 0], [5, 1, 4, 0], [0, 2, 4, 0]], np.int32)
    keys = np.full((3, nq, m), sem.PLACEBO_KEY, np.int32)
    vals = np.zeros((3, nq, m), np.int32)
    base = 0
    for s in range(3):
        for q in range(nq):
            c = min(int(counts[s, q]), m)
            keys[s, q, :c] = base + np.arange(c)
            vals[s, q, :c] = -(base + np.arange(c))
            base += 10
    ok = np.array([False, True, True, True])
    for max_results in (4, 6, 16):
        exp = jdist.assemble_range(jnp.asarray(keys), jnp.asarray(vals), jnp.asarray(counts), jnp.asarray(ok),
                                   max_results)
        got = tdist.assemble_range(*(torch.from_numpy(a) for a in (keys, vals, counts, ok)), max_results)
        assert_same(exp, got, f"max_results={max_results}")
        assert [bool(x) for x in got[3]] == [False, True, max_results >= 11, True]


def test_factories_and_converters():
    jcfg, jmesh, tcfg, tmesh = configs()
    rng = np.random.default_rng(5)
    keys_pool = pool("spread", rng)
    t = tdist.dist_lsm_init(tcfg, tmesh)
    j = jdist.dist_lsm_init(jcfg, jmesh)
    update, stage = tdist.make_dist_update(tcfg, tmesh), tdist.make_dist_stage(tcfg, tmesh)
    for _ in range(3):
        kv, vals = encoded_batch(rng, keys_pool, B)
        t = update(t, torch.from_numpy(kv), torch.from_numpy(vals))
        j = jitted("dist_update", jcfg, jmesh)(j, jnp.asarray(kv), jnp.asarray(vals))
    t = stage(t, torch.from_numpy(kv), torch.from_numpy(vals), 6)
    j = jitted("dist_stage", jcfg, jmesh)(j, jnp.asarray(kv), jnp.asarray(vals), 6)
    assert_states_equal(j, t)
    q = keys_pool.astype(np.int32)
    k1, k2 = jnp.asarray(q), jnp.asarray(q + 5)
    assert_same(jitted("dist_lookup", jcfg, jmesh)(j, k1), tdist.make_dist_lookup(tcfg, tmesh)(t, torch.from_numpy(q)))
    assert_same(jitted("dist_count", jcfg, jmesh, max_candidates=64)(j, k1, k2),
                tdist.make_dist_count(tcfg, tmesh, 64)(t, torch.from_numpy(q), torch.from_numpy(q + 5)))
    assert_same(jitted("dist_range", jcfg, jmesh, max_candidates=64, max_results=8)(j, k1, k2),
                tdist.make_dist_range(tcfg, tmesh, 64, 8)(t, torch.from_numpy(q), torch.from_numpy(q + 5)))
    assert_same(jitted("dist_size", jcfg, jmesh)(j), tdist.make_dist_size(tcfg, tmesh)(t))
    # The stacked fields carry back into a new tuple of shard states (copies).
    fields = jax.device_get(j)._asdict()
    fields["buf_kv"] = np.array(fields["buf_kv"])
    back = convert.dist_state_from_numpy(tcfg, fields, tmesh.devices)
    assert_states_equal(j, back)
    fields["buf_kv"][:] = 0
    assert torch.equal(back[0].buf_kv, t[0].buf_kv)
    with pytest.raises(ValueError, match="leading shard axis"):
        convert.dist_state_from_numpy(configs(2)[2], fields, ["cpu"] * 2)
    for fn in (tdist.make_dist_flush(tcfg, tmesh), tdist.make_dist_maintain(tcfg, tmesh, 3 * B),
               tdist.make_dist_cleanup(tcfg, tmesh)):
        t = fn(t)
    assert tdist.dist_pending(tcfg, tmesh, t) == 0


# -- the facade, through both packages ---------------------------------------------


SHARDS = [1, 2, 4]
CAPACITY = B * 63
PLAN = dict(max_candidates=CAPACITY, max_results=64)


def both(num_shards, num_levels=6, b=B):
    return {
        "jax": JaxDictionary.create("lsm_sharded", batch_size=b, num_levels=num_levels, num_shards=num_shards),
        "torch": Dictionary.create("lsm_sharded", batch_size=b, num_levels=num_levels, num_shards=num_shards,
                                   device="cpu"),
    }


WIDTH = 64          # at least any update below (gen_ops' longest is 3b + 1)
QUERIES = 64        # at least any pool's queries below (63)


class Padded:
    """A facade handle whose updates are padded to WIDTH lanes, the padding
    masked out with `valid=False` (neither facade stages it): the reference
    then compiles one update executable per shard count, not one per
    length."""

    def __init__(self, d):
        self.d = d

    def __getattr__(self, name):
        return getattr(self.d, name)

    def update(self, keys, values, is_delete):
        pad = WIDTH - len(keys)
        return Padded(self.d.update(np.pad(keys, (0, pad)), np.pad(values, (0, pad)),
                                    is_delete=np.pad(is_delete, (0, pad)), valid=np.arange(WIDTH) < len(keys)))

    def cleanup(self):
        return Padded(self.d.cleanup())

    def flush(self):
        return Padded(self.d.flush())

    def maintain(self, budget):
        return Padded(self.d.maintain(budget))


def padded(num_shards):
    return {name: Padded(d) for name, d in both(num_shards).items()}


def insert(d, keys, values):
    return d.update(keys, values, np.zeros(len(keys), bool))


def differential(num_shards, ops, keys_pool, pad=True):
    """Replay `ops` through both facades against the dict oracle (updates
    padded unless `pad` is False), then compare the final states."""
    k1, k2 = harness.query_ranges(keys_pool)
    q = np.unique(np.concatenate([keys_pool, np.clip(keys_pool + 1, 0, sem.MAX_USER_KEY)]))
    q = np.pad(q, (0, QUERIES - len(q)), mode="edge")  # one lookup shape for every test
    dicts = padded(num_shards) if pad else both(num_shards)
    out = harness.run_differential(dicts, ops, plan=JaxQueryPlan(**PLAN), query_keys=q, k1=k1, k2=k2)
    j, t = (getattr(out[name], "d", out[name]) for name in ("jax", "torch"))
    assert_states_equal(j.state, t.state, "final state")
    assert_same(j.occupancy(), t.occupancy(), "occupancy")
    assert_same(j.pending(), t.pending(), "pending")
    assert_same(j.flush_cost_estimate(), t.flush_cost_estimate(), "flush cost")
    assert t.overflowed() == bool(j.overflowed())
    return out


@pytest.mark.parametrize("num_shards", SHARDS)
@pytest.mark.parametrize("seed", [0, 1])
def test_facade_randomized_sequences(seed, num_shards):
    rng = np.random.default_rng(seed)
    keys_pool = harness.key_pool(rng)
    differential(num_shards, harness.gen_ops(rng, keys_pool, n_steps=8, batch_size=B), keys_pool)


@pytest.mark.parametrize("num_shards", SHARDS)
def test_facade_boundary_key_churn(num_shards):
    bks = np.array(harness.boundary_keys(), dtype=np.int64)
    n = len(bks)
    ops = [
        ("update", bks, np.arange(n, dtype=np.int32), np.zeros(n, bool)),
        ("update", bks[::2], np.zeros((n + 1) // 2, np.int32), np.ones((n + 1) // 2, bool)),
        ("cleanup",),
        ("update", bks, -np.arange(n, dtype=np.int32), np.zeros(n, bool)),
        ("update", bks[1::2], np.zeros(n // 2, np.int32), np.ones(n // 2, bool)),
        ("cleanup",),
    ]
    differential(num_shards, ops, bks, pad=False)  # the facades' unmasked update path


@pytest.mark.parametrize("num_shards", SHARDS)
def test_facade_tombstone_churn(num_shards):
    rng = np.random.default_rng(7)
    keys_pool = np.array([0, 3, 5, sem.MAX_USER_KEY], dtype=np.int64)
    ops = harness.gen_ops(rng, keys_pool, n_steps=10, batch_size=B, p_cleanup=0.2, p_delete=0.5, max_batches=2)
    differential(num_shards, ops, keys_pool)


@pytest.mark.parametrize("num_shards", SHARDS)
def test_facade_heavy_maintain(num_shards):
    rng = np.random.default_rng(11)
    keys_pool = harness.key_pool(rng)
    ops = harness.gen_ops(rng, keys_pool, n_steps=10, batch_size=B, p_cleanup=0.05, p_delete=0.45, p_maintain=0.4)
    assert any(op[0] == "maintain" for op in ops)
    differential(num_shards, ops, keys_pool)


@pytest.mark.parametrize("num_shards", SHARDS)
def test_facade_bulk_build_matches_incremental(num_shards):
    rng = np.random.default_rng(5)
    keys = rng.choice(sem.MAX_USER_KEY, 37, replace=False).astype(np.int64)
    vals = (keys % 997).astype(np.int32) - 500
    q = np.unique(np.concatenate([keys, keys + 1]))
    built = {name: d.bulk_build(keys, vals) for name, d in both(num_shards).items()}
    assert_states_equal(built["jax"].state, built["torch"].state, "bulk build")
    assert_same(built["jax"].lookup(q), built["torch"].lookup(q))
    assert int(built["torch"].size()) == 37
    inc = Dictionary.create("lsm_sharded", batch_size=B, num_levels=6, num_shards=num_shards, device="cpu")
    inc = inc.insert(keys, vals).flush()
    assert_same(built["torch"].lookup(q), inc.lookup(q))
    with pytest.raises(ValueError, match="capacity"):
        both(num_shards, num_levels=1, b=4)["torch"].bulk_build(np.arange(5), np.arange(5))


@pytest.mark.parametrize("num_shards", SHARDS)
def test_facade_range_overflow_on_one_hot_shard(num_shards):
    """All keys in shard 0: its window sees every hit; a small plan flips
    ok and keeps the count exact."""
    keys = np.arange(40, dtype=np.int64)
    k1, k2 = np.array([0]), np.array([sem.MAX_USER_KEY])
    for rows in (16, 64):
        res = [insert(d, keys, keys.astype(np.int32)).range(k1, k2, plan(max_candidates=CAPACITY, max_results=rows))
               for d, plan in zip(padded(num_shards).values(), (JaxQueryPlan, QueryPlan))]
        assert_same(*res)
        assert bool(res[1][3][0]) == (rows == 64) and int(res[1][2][0]) == 40


@pytest.mark.parametrize("num_shards", SHARDS)
def test_facade_count_candidate_overflow(num_shards):
    keys = np.arange(40, dtype=np.int64)
    k1, k2 = np.array([0]), np.array([sem.MAX_USER_KEY])
    for cands in (16, CAPACITY):
        res = [insert(d, keys, keys.astype(np.int32)).count(k1, k2, plan(max_candidates=cands))
               for d, plan in zip(padded(num_shards).values(), (JaxQueryPlan, QueryPlan))]
        assert_same(*res)
        assert bool(res[1][1][0]) == (cands == CAPACITY)


@pytest.mark.parametrize("num_shards", SHARDS)
def test_facade_auto_plan_is_exact(num_shards):
    keys = np.unique(np.clip(np.arange(50, dtype=np.int64) * harness.range_size(4), 0, sem.MAX_USER_KEY))
    res = [insert(d, keys, np.ones(len(keys), np.int32)).count(np.array([0]), np.array([sem.MAX_USER_KEY]))
           for d in padded(num_shards).values()]
    assert_same(*res)
    assert bool(res[1][1][0]) and int(res[1][0][0]) == len(keys)


@pytest.mark.parametrize("num_shards", SHARDS)
def test_facade_num_shards_and_surface(num_shards):
    j, t = both(num_shards, num_levels=3).values()
    assert (t.num_shards, t.backend, t.capacity, t.batch_size, t.buffered) == (
        j.num_shards, j.backend, j.capacity, j.batch_size, j.buffered)
    assert t._backend.max_query_candidates == j._backend.max_query_candidates
    assert vars(t.capabilities) == vars(j.capabilities)
    assert t.devices == (torch.device("cpu"),) and len(t.state) == num_shards
    assert repr(t) == "Dictionary(backend='lsm_sharded', capacity=56, batch_size=8, device='cpu')"
    assert Dictionary.create("lsm", batch_size=B, num_levels=3, device="cpu").num_shards == 1


@pytest.mark.parametrize("num_shards", [2, 4])
def test_facade_overflow_latches_on_one_shard(num_shards):
    """Keys all in shard 0: its buffer and one batch slot take 8 elements,
    the 9th overflows it while the other shards stay empty."""
    j, t = both(num_shards, num_levels=1, b=4).values()
    for keys in ([1, 2, 3, 4], [5, 6, 7, 8], [9]):
        j, t = (d.insert(np.array(keys), np.zeros(len(keys), np.int32)) for d in (j, t))
        assert t.overflowed() == bool(j.overflowed()) == (keys == [9])
    assert [st.overflowed for st in t.state] == [True] + [False] * (num_shards - 1)


def test_capability_errors_name_lsm_sharded_as_the_reference_does():
    jc = JaxDictionary.create("cuckoo", capacity=16)
    tc = Dictionary.create("cuckoo", capacity=16, device="cpu")
    for op in (lambda d: d.count(0, 1), lambda d: d.range(0, 1), lambda d: d.cleanup(),
               lambda d: d.insert(np.asarray([1]), np.asarray([1])), lambda d: d.delete(np.asarray([1]))):
        with pytest.raises(JaxCapabilityError) as exp:
            op(jc)
        with pytest.raises(CapabilityError) as got:
            op(tc)
        assert str(got.value) == str(exp.value) and "lsm_sharded" in str(got.value)


# -- mesh and option errors ------------------------------------------------------------


def test_make_shard_mesh_errors(monkeypatch):
    mesh = make_shard_mesh(3, axis="s", devices=["cpu"] * 4)
    assert mesh == ShardMesh((torch.device("cpu"),) * 3, ("s",)) and mesh.shape == {"s": 3}
    assert make_shard_mesh(devices=["cpu"] * 2).shape == {"shard": 2}
    with pytest.raises(ValueError, match="num_shards must be >= 1"):
        make_shard_mesh(0, devices=["cpu"])
    with pytest.raises(ValueError, match="num_shards=5 exceeds the 4 visible"):
        make_shard_mesh(5, devices=["cpu"] * 4)
    # No card and no explicit device: raise, never fall back to the CPU.
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        make_shard_mesh(1)
    with pytest.raises(RuntimeError, match="CUDA"):
        Dictionary.create("lsm_sharded", num_shards=2, batch_size=B, num_levels=3)
    with pytest.raises(RuntimeError, match="CUDA"):
        Dictionary.create("lsm_sharded", num_shards=2, batch_size=B, num_levels=3, device="cuda")


def test_create_option_errors_match_reference():
    mesh = make_shard_mesh(2, devices=["cpu"] * 2)
    jmesh = make_mesh((2,), ("shard",), axis_types=(AxisType.Auto,), devices=jax.devices()[:2])
    d = Dictionary.create("lsm_sharded", batch_size=B, num_levels=3, mesh=mesh, device="cpu")
    assert d.num_shards == 2
    for create, m, kw in ((JaxDictionary.create, jmesh, {}), (Dictionary.create, mesh, {"device": "cpu"})):
        with pytest.raises(TypeError, match="unknown options for backend 'lsm_sharded'"):
            create("lsm_sharded", batch_size=B, num_levels=3, load_factor=0.5, **kw)
        with pytest.raises(ValueError, match="no axis 'nope'"):
            create("lsm_sharded", batch_size=B, num_levels=3, mesh=m, axis="nope", **kw)
        with pytest.raises(ValueError, match="num_shards=3 disagrees"):
            create("lsm_sharded", batch_size=B, num_levels=3, mesh=m, num_shards=3, **kw)
        with pytest.raises(ValueError, match="num_shards must be >= 1"):
            create("lsm_sharded", batch_size=B, num_levels=3, num_shards=0, **kw)
    # A pinned device without num_shards holds one shard.
    assert Dictionary.create("lsm_sharded", batch_size=B, num_levels=3, device="cpu").num_shards == 1
