"""Core parity: repro_torch.core against repro.core, state field by field.

Random sequences of stage (ragged counts, duplicate keys, tombstones), flush,
cleanup, maintain (the harness's budget menu, with and without only_if_debt)
and overflow run through both packages from one start state; so do
sequences of the direct, paper-exact updates (lsm_update / insert / delete /
update_mixed, with in-batch duplicates) and bulk builds. After every op
every LSMState field must be equal; every few ops lookup, count and range
must be equal too, including `ok` and the range padding. Exact integers.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from harness import maintain_budgets
from repro.core import cleanup as jclean
from repro.core import lsm as jlsm
from repro.core import queries as jq
from repro.core import semantics as jsem
from repro_torch import convert
from repro_torch.core import cascade as tcascade
from repro_torch.core import cleanup as tclean
from repro_torch.core import lsm as tlsm
from repro_torch.core import queries as tq

_JIT = {}


def jitted(name, cfg, *statics):
    """One jitted JAX core function per (name, config, static arguments)."""
    key = (name, cfg, statics)
    if key not in _JIT:
        fns = {
            "stage": lambda st, kv, v, c: jlsm.lsm_stage(cfg, st, kv, v, c),
            "flush": lambda st, mp: jlsm.lsm_flush(cfg, st, mp),
            "cleanup": lambda st: jclean.lsm_cleanup(cfg, st),
            "maintain": lambda st: jclean.lsm_maintain(cfg, st, statics[0], only_if_debt=statics[1]),
            "lookup": lambda st, q: jq.lsm_lookup(cfg, st, q),
            "count": lambda st, k1, k2: jq.lsm_count(cfg, st, k1, k2, statics[0]),
            "range": lambda st, k1, k2: jq.lsm_range(cfg, st, k1, k2, *statics),
            "size": lambda st: jclean.lsm_valid_count(cfg, st),
            "update": lambda st, kv, v: jlsm.lsm_update(cfg, st, kv, v),
            "insert": lambda st, k, v: jlsm.lsm_insert(cfg, st, k, v),
            "delete": lambda st, k: jlsm.lsm_delete(cfg, st, k),
            "mixed": lambda st, k, v, d: jlsm.lsm_update_mixed(cfg, st, k, v, d),
        }
        _JIT[key] = jax.jit(fns[name])
    return _JIT[key]


def assert_states_equal(js, ts, where):
    exp = jax.device_get(js)._asdict()
    got = convert.lsm_state_to_numpy(ts)
    assert set(got) == set(exp)
    for name in exp:
        e, g = exp[name], got[name]
        if name in ("key_vars", "values"):
            assert len(g) == len(e)
            for i, (gl, el) in enumerate(zip(g, e)):
                np.testing.assert_array_equal(gl, el, err_msg=f"{where}: {name}[{i}]")
        else:
            np.testing.assert_array_equal(g, e, err_msg=f"{where}: {name}")
            assert np.asarray(g).dtype == np.asarray(e).dtype, f"{where}: {name} dtype"


def assert_queries_equal(b, L, js, ts, pool, where):
    cfg_j, cfg_t = jlsm.LSMConfig(b, L), tlsm.LSMConfig(b, L)
    q = np.concatenate([pool, [0, jsem.MAX_USER_KEY, jsem.PLACEBO_KEY, np.iinfo(np.int32).max]]).astype(np.int32)
    for got, exp in zip(tq.lsm_lookup(cfg_t, ts, torch.from_numpy(q)), jitted("lookup", cfg_j)(js, q)):
        np.testing.assert_array_equal(got.numpy(), np.asarray(exp), err_msg=f"{where}: lookup")
    k1 = np.array([0, pool[2], pool[5], 7, jsem.MAX_USER_KEY, 9], np.int32)
    k2 = np.array([jsem.MAX_USER_KEY, pool[-3], pool[5], 3, jsem.MAX_USER_KEY, 1 << 20], np.int32)
    big = cfg_j.capacity + b
    for m, r in ((big, big), (5, 3)):  # exact, and truncated (ok flags)
        got = tq.lsm_count(cfg_t, ts, torch.from_numpy(k1), torch.from_numpy(k2), m)
        exp = jitted("count", cfg_j, m)(js, k1, k2)
        for g, e in zip(got, exp):
            np.testing.assert_array_equal(g.numpy(), np.asarray(e), err_msg=f"{where}: count M={m}")
        got = tq.lsm_range(cfg_t, ts, torch.from_numpy(k1), torch.from_numpy(k2), m, r)
        exp = jitted("range", cfg_j, m, r)(js, k1, k2)
        for g, e in zip(got, exp):
            np.testing.assert_array_equal(g.numpy(), np.asarray(e), err_msg=f"{where}: range M={m}")
    assert int(tclean.lsm_valid_count(cfg_t, ts)) == int(jitted("size", cfg_j)(js)), where


def gen_core_ops(rng, b, n_ops):
    budgets = maintain_budgets(b)
    ops = []
    for _ in range(n_ops):
        roll = rng.random()
        if roll < 0.6:
            ops.append(("stage", int(rng.integers(0, b + 1))))
        elif roll < 0.72:
            ops.append(("flush", int(rng.choice([1, max(b // 2, 1), b]))))
        elif roll < 0.8:
            ops.append(("cleanup",))
        else:
            ops.append(("maintain", budgets[int(rng.integers(len(budgets)))], bool(rng.random() < 0.5)))
    return ops


def replay(b, L, js, ts, rng, n_ops, pool):
    cfg_j, cfg_t = jlsm.LSMConfig(b, L), tlsm.LSMConfig(b, L)
    for step, op in enumerate(gen_core_ops(rng, b, n_ops)):
        where = f"step {step} {op}"
        if op[0] == "stage":
            count = op[1]
            kv = np.full(b, jsem.PLACEBO_KV, np.int32)
            val = np.zeros(b, np.int32)
            keys = rng.choice(pool, count)
            kv[:count] = (keys << 1) | (rng.random(count) >= 0.3)
            val[:count] = rng.integers(-1000, 1000, count)
            val[:count][(kv[:count] & 1) == 0] = jsem.EMPTY_VALUE
            js = jitted("stage", cfg_j)(js, kv, val, np.int32(count))
            ts = tlsm.lsm_stage(cfg_t, ts, torch.from_numpy(kv), torch.from_numpy(val), count)
        elif op[0] == "flush":
            js = jitted("flush", cfg_j)(js, np.int32(op[1]))
            ts = tlsm.lsm_flush(cfg_t, ts, op[1])
        elif op[0] == "cleanup":
            js = jitted("cleanup", cfg_j)(js)
            ts = tclean.lsm_cleanup(cfg_t, ts)
        else:
            js = jitted("maintain", cfg_j, op[1], op[2])(js)
            ts = tclean.lsm_maintain(cfg_t, ts, op[1], only_if_debt=op[2])
        assert_states_equal(js, ts, where)
        if step % 4 == 3:
            assert_queries_equal(b, L, js, ts, pool, where)
    assert_queries_equal(b, L, js, ts, pool, "end")
    assert tlsm.lsm_flush_cost(cfg_t, ts) == int(jlsm.lsm_flush_cost(cfg_j, js))
    assert int(tlsm.lsm_debt(cfg_t, ts)) == int(jlsm.lsm_debt(cfg_j, js))
    assert tlsm.lsm_num_elements(cfg_t, ts) == int(jlsm.lsm_num_elements(cfg_j, js))


def key_pool(rng, b):
    pool = np.concatenate([rng.integers(0, 3 * b, 2 * b), rng.integers(0, jsem.MAX_USER_KEY + 1, b),
                           [0, jsem.MAX_USER_KEY]])
    return np.unique(pool).astype(np.int32)


@pytest.mark.parametrize("seed,b,L,n_ops", [(0, 8, 3, 40), (1, 16, 3, 30), (2, 8, 4, 40), (3, 64, 4, 24)])
def test_core_parity_random_sequences(seed, b, L, n_ops):
    rng = np.random.default_rng(seed)
    js = jlsm.lsm_init(jlsm.LSMConfig(b, L))
    ts = tlsm.lsm_init(tlsm.LSMConfig(b, L), "cpu")
    assert_states_equal(js, ts, "init")
    replay(b, L, js, ts, rng, n_ops, key_pool(rng, b))


def test_core_parity_from_bulk_build():
    b, L = 8, 4
    rng = np.random.default_rng(7)
    keys = rng.choice(6 * b, 5 * b + 3, replace=False).astype(np.int32)
    pool = np.union1d(key_pool(rng, b), keys).astype(np.int32)
    vals = rng.integers(-100, 100, keys.size).astype(np.int32)
    js = jlsm.lsm_bulk_build(jlsm.LSMConfig(b, L), jnp.asarray(keys), jnp.asarray(vals))
    ts = tlsm.lsm_bulk_build(tlsm.LSMConfig(b, L), torch.from_numpy(keys), torch.from_numpy(vals))
    assert_states_equal(js, ts, "bulk build")
    assert_queries_equal(b, L, js, ts, pool, "bulk build")
    replay(b, L, js, ts, rng, 20, pool)


@pytest.mark.parametrize("n", [0, 1, 8, 21, 56, 120])
def test_bulk_build_parity(n):
    b, L = 8, 4  # capacity 120: n = 120 fills every level
    rng = np.random.default_rng(n)
    keys = rng.choice(1 << 29, n, replace=False).astype(np.int32)
    vals = rng.integers(-100, 100, n).astype(np.int32)
    js = jlsm.lsm_bulk_build(jlsm.LSMConfig(b, L), jnp.asarray(keys), jnp.asarray(vals))
    ts = tlsm.lsm_bulk_build(tlsm.LSMConfig(b, L), torch.from_numpy(keys), torch.from_numpy(vals))
    assert_states_equal(js, ts, f"bulk build of {n}")


def test_bulk_build_beyond_capacity_raises():
    keys = np.arange(121, dtype=np.int32)
    with pytest.raises(ValueError, match="capacity"):
        jlsm.lsm_bulk_build(jlsm.LSMConfig(8, 4), jnp.asarray(keys), jnp.asarray(keys))
    with pytest.raises(ValueError, match="capacity"):
        tlsm.lsm_bulk_build(tlsm.LSMConfig(8, 4), torch.from_numpy(keys), torch.from_numpy(keys))


def direct_batch(rng, b, pool):
    """b lanes of keys from the pool with in-batch duplicates: a lane may
    repeat an earlier lane's key (the same insert twice with another value,
    or an insert and a delete of one key)."""
    keys = rng.choice(pool, b).astype(np.int32)
    for lane in range(1, b):
        if rng.random() < 0.3:
            keys[lane] = keys[rng.integers(0, lane)]
    vals = rng.integers(-1000, 1000, b).astype(np.int32)
    return keys, vals, rng.random(b) < 0.3


@pytest.mark.parametrize("seed,b,L,n_ops", [(0, 8, 2, 14), (1, 8, 4, 24)])
def test_direct_update_parity(seed, b, L, n_ops):
    cfg_j, cfg_t = jlsm.LSMConfig(b, L), tlsm.LSMConfig(b, L)
    rng = np.random.default_rng(seed)
    pool = key_pool(rng, b)
    js, ts = jlsm.lsm_init(cfg_j), tlsm.lsm_init(cfg_t, "cpu")
    for step in range(n_ops):  # L = 2 holds 3 batches: the fourth overflows
        keys, vals, dels = direct_batch(rng, b, pool)
        kind = ("mixed", "insert", "delete", "update", "cleanup")[step % 5]
        where = f"step {step} {kind}"
        if kind == "mixed":
            js = jitted(kind, cfg_j)(js, keys, vals, dels)
            ts = tlsm.lsm_update_mixed(cfg_t, ts, torch.from_numpy(keys), torch.from_numpy(vals),
                                       torch.from_numpy(dels))
        elif kind == "insert":
            js = jitted(kind, cfg_j)(js, keys, vals)
            ts = tlsm.lsm_insert(cfg_t, ts, torch.from_numpy(keys), torch.from_numpy(vals))
        elif kind == "delete":
            js = jitted(kind, cfg_j)(js, keys)
            ts = tlsm.lsm_delete(cfg_t, ts, torch.from_numpy(keys))
        elif kind == "update":
            kv = ((keys << 1) | ~dels).astype(np.int32)
            vals = np.where(dels, jsem.EMPTY_VALUE, vals).astype(np.int32)
            js = jitted(kind, cfg_j)(js, kv, vals)
            ts = tlsm.lsm_update(cfg_t, ts, torch.from_numpy(kv), torch.from_numpy(vals))
        else:
            js = jitted(kind, cfg_j)(js)
            ts = tclean.lsm_cleanup(cfg_t, ts)
        assert_states_equal(js, ts, where)
        if step % 4 == 3:
            assert_queries_equal(b, L, js, ts, pool, where)
    assert ts.overflowed == (L == 2)
    assert_queries_equal(b, L, js, ts, pool, "end")


def test_direct_update_rejects_wrong_width():
    cfg = tlsm.LSMConfig(8, 3)
    with pytest.raises(ValueError, match="shape"):
        tlsm.lsm_update(cfg, tlsm.lsm_init(cfg, "cpu"), torch.zeros(7, dtype=torch.int32),
                        torch.zeros(7, dtype=torch.int32))


def test_overflow_latches_and_keeps_levels():
    b, L = 4, 2
    cfg_j, cfg_t = jlsm.LSMConfig(b, L), tlsm.LSMConfig(b, L)
    js, ts = jlsm.lsm_init(cfg_j), tlsm.lsm_init(cfg_t, "cpu")
    for i in range(5):  # 3 batches fill L = 2; the next flushes overflow
        kv = ((np.arange(b, dtype=np.int32) + 10 * i) << 1) | 1
        val = np.full(b, i, np.int32)
        js = jitted("stage", cfg_j)(js, kv, val, np.int32(b))
        js = jitted("flush", cfg_j)(js, np.int32(1))
        ts = tlsm.lsm_flush(cfg_t, tlsm.lsm_stage(cfg_t, ts, torch.from_numpy(kv), torch.from_numpy(val), b), 1)
        assert_states_equal(js, ts, f"batch {i}")
    assert ts.overflowed and ts.r == cfg_t.max_batches


@pytest.mark.parametrize("r", [0, 1, 2, 3, 5, 7, 8, 11, 1023])
def test_placement_level_is_lowest_zero_bit(r):
    from repro.core import cascade as jcascade

    assert tcascade.placement_level(r) == int(jcascade.placement_level(r))


def test_compact_real_matches():
    rng = np.random.default_rng(4)
    kv = rng.integers(0, 100, 13).astype(np.int32)
    val = rng.integers(0, 100, 13).astype(np.int32)
    mask = rng.random(13) < 0.5
    got = tlsm.compact_real(torch.from_numpy(kv), torch.from_numpy(val), torch.from_numpy(mask))
    exp = jlsm.compact_real(jnp.asarray(kv), jnp.asarray(val), jnp.asarray(mask))
    for g, e in zip(got, exp):
        np.testing.assert_array_equal(g.numpy(), np.asarray(e))


def test_level_and_arena_views_and_merge_all_levels_match():
    """level_view, arena_view and merge_all_levels on a state carried across
    by convert; arena_view is a copy, so an in-place update after it leaves
    what it returned as it was."""
    b, L = 8, 4
    rng = np.random.default_rng(11)
    cfg_j, cfg_t = jlsm.LSMConfig(b, L), tlsm.LSMConfig(b, L)
    js = jlsm.lsm_init(cfg_j)
    for _ in range(6):  # r = 6: levels 1 and 2 hold residents, with ties and tombstones
        keys = rng.integers(0, 3 * b, b)
        kv = ((keys << 1) | (rng.random(b) >= 0.3)).astype(np.int32)
        val = rng.integers(-100, 100, b).astype(np.int32)
        js = jitted("stage", cfg_j)(js, kv, val, np.int32(b))
        js = jitted("flush", cfg_j)(js, np.int32(b))
    ts = convert.lsm_state_from_numpy(cfg_t, jax.device_get(js)._asdict(), "cpu")
    assert ts.r == int(js.r) == 6
    for i in range(L):
        for g, e in zip(tlsm.level_view(cfg_t, ts, i), jlsm.level_view(cfg_j, js, i)):
            np.testing.assert_array_equal(g.numpy(), np.asarray(e), err_msg=f"level {i}")
    arena = tlsm.arena_view(ts)
    for g, e in zip(arena, jlsm.arena_view(js)):
        np.testing.assert_array_equal(g.numpy(), np.asarray(e))
    for g, e in zip(tclean.merge_all_levels(cfg_t, ts), jclean.merge_all_levels(cfg_j, js)):
        np.testing.assert_array_equal(g.numpy(), np.asarray(e))
    snapshot = [a.clone() for a in arena]
    ts = tclean.lsm_cleanup(cfg_t, ts)
    assert ts.r < 6
    assert not torch.equal(tlsm.arena_view(ts)[0], snapshot[0])
    for a, s in zip(arena, snapshot):
        assert torch.equal(a, s)
