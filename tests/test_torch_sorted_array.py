"""Sorted-array parity: repro_torch.core.sorted_array against
repro.core.sorted_array, state field by field.

A bulk build, then random direct batches (the paper's in-batch rule:
`sa_update_batch`, `sa_insert`, `sa_delete`), staged sub-batches (the
recency rule: `sa_stage`) and cleanups run through both packages. After every
op the SAState fields must be equal, dtypes included; every few ops lookup,
count and range must be equal too, and so must `sa_would_overflow`. The state
converts across in both directions (`convert.sa_state_*`). Exact integers.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import semantics as jsem
from repro.core import sorted_array as jsa
from repro_torch import convert
from repro_torch.core import sorted_array as tsa

CAP, B = 256, 8
_JIT = {}


def jitted(name, *statics):
    """One jitted JAX sorted-array function per name and static arguments."""
    key = (name, statics)
    if key not in _JIT:
        cfg = jsa.SAConfig(CAP)
        fns = {
            "update": lambda st, kv, v: jsa.sa_update_batch(cfg, st, kv, v),
            "stage": lambda st, kv, v: jsa.sa_stage(cfg, st, kv, v),
            "insert": lambda st, k, v: jsa.sa_insert(cfg, st, k, v),
            "delete": lambda st, k: jsa.sa_delete(cfg, st, k),
            "cleanup": lambda st: jsa.sa_cleanup(cfg, st),
            "lookup": lambda st, q: jsa.sa_lookup(cfg, st, q),
            "count": lambda st, k1, k2: jsa.sa_count(cfg, st, k1, k2, statics[0]),
            "range": lambda st, k1, k2: jsa.sa_range(cfg, st, k1, k2, *statics),
        }
        _JIT[key] = jax.jit(fns[name])
    return _JIT[key]


def t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def assert_states_equal(js, ts, where):
    exp = jax.device_get(js)._asdict()
    got = convert.sa_state_to_numpy(ts)
    assert set(got) == set(exp)
    for name in exp:
        np.testing.assert_array_equal(got[name], exp[name], err_msg=f"{where}: {name}")
        assert np.asarray(got[name]).dtype == np.asarray(exp[name]).dtype, f"{where}: {name} dtype"


def assert_queries_equal(js, ts, pool, where):
    cfg = tsa.SAConfig(CAP)
    q = np.concatenate([pool, [0, jsem.MAX_USER_KEY, jsem.PLACEBO_KEY]]).astype(np.int32)
    for got, exp in zip(tsa.sa_lookup(cfg, ts, t(q)), jitted("lookup")(js, q)):
        np.testing.assert_array_equal(got.numpy(), np.asarray(exp), err_msg=f"{where}: lookup")
    k1 = np.array([0, pool[2], pool[5], 7, jsem.MAX_USER_KEY], np.int32)
    k2 = np.array([jsem.MAX_USER_KEY, pool[-3], pool[5], 3, jsem.MAX_USER_KEY], np.int32)
    for m, r in ((CAP, CAP), (5, 3)):  # exact, and truncated (ok flags)
        for g, e in zip(tsa.sa_count(cfg, ts, t(k1), t(k2), m), jitted("count", m)(js, k1, k2)):
            np.testing.assert_array_equal(g.numpy(), np.asarray(e), err_msg=f"{where}: count M={m}")
        for g, e in zip(tsa.sa_range(cfg, ts, t(k1), t(k2), m, r), jitted("range", m, r)(js, k1, k2)):
            np.testing.assert_array_equal(g.numpy(), np.asarray(e), err_msg=f"{where}: range M={m}")
    for batch in (0, B, CAP):
        exp = bool(jsa.sa_would_overflow(jsa.SAConfig(CAP), js, batch))
        assert bool(tsa.sa_would_overflow(cfg, ts, batch)) == exp, where


def batch(rng, pool, width):
    """Lanes with in-batch duplicates: the same insert twice with another
    value, and an insert and a delete of one key."""
    keys = rng.choice(pool, width).astype(np.int32)
    for lane in range(1, width):
        if rng.random() < 0.3:
            keys[lane] = keys[rng.integers(0, lane)]
    dels = rng.random(width) < 0.3
    kv = ((keys << 1) | ~dels).astype(np.int32)
    vals = np.where(dels, jsem.EMPTY_VALUE, rng.integers(-1000, 1000, width)).astype(np.int32)
    return keys, kv, vals


@pytest.mark.parametrize("seed,n_bulk,n_ops", [(0, 0, 16), (1, 19, 16)])
def test_sa_parity_sequence(seed, n_bulk, n_ops):
    cfg_j, cfg_t = jsa.SAConfig(CAP), tsa.SAConfig(CAP)
    rng = np.random.default_rng(seed)
    pool = np.unique(np.concatenate([rng.integers(0, 3 * B, 2 * B), rng.integers(0, jsem.MAX_USER_KEY, B),
                                     [0, jsem.MAX_USER_KEY]])).astype(np.int32)
    keys = rng.choice(pool, n_bulk, replace=False).astype(np.int32) if n_bulk else np.zeros(0, np.int32)
    vals = rng.integers(-50, 50, n_bulk).astype(np.int32)
    if n_bulk:
        js = jsa.sa_bulk_build(cfg_j, jnp.asarray(keys), jnp.asarray(vals))
        ts = tsa.sa_bulk_build(cfg_t, t(keys), t(vals))
    else:
        js, ts = jsa.sa_init(cfg_j), tsa.sa_init(cfg_t, "cpu")
    assert_states_equal(js, ts, "start")
    for step in range(n_ops):
        kind = ("update", "stage", "insert", "delete", "stage", "update", "cleanup")[step % 7]
        keys, kv, vals = batch(rng, pool, B)
        if kind in ("update", "stage"):
            if kind == "stage":  # a facade sub-batch: real lanes first, placebos after
                count = int(rng.integers(0, B + 1))
                kv[count:], vals[count:] = jsem.PLACEBO_KV, jsem.EMPTY_VALUE
            js = jitted(kind)(js, kv, vals)
            ts = (tsa.sa_update_batch if kind == "update" else tsa.sa_stage)(cfg_t, ts, t(kv), t(vals))
        elif kind == "insert":
            js = jitted(kind)(js, keys, vals)
            ts = tsa.sa_insert(cfg_t, ts, t(keys), t(vals))
        elif kind == "delete":
            js = jitted(kind)(js, keys)
            ts = tsa.sa_delete(cfg_t, ts, t(keys))
        else:
            js = jitted(kind)(js)
            ts = tsa.sa_cleanup(cfg_t, ts)
        assert_states_equal(js, ts, f"step {step} {kind}")
        if step % 3 == 2:
            assert_queries_equal(js, ts, pool, f"step {step} {kind}")
    assert_queries_equal(js, ts, pool, "end")


@pytest.mark.parametrize("n", [1, 9, CAP])
def test_sa_bulk_build_parity(n):
    rng = np.random.default_rng(n)
    keys = rng.choice(1 << 29, n, replace=False).astype(np.int32)
    vals = rng.integers(-100, 100, n).astype(np.int32)
    js = jsa.sa_bulk_build(jsa.SAConfig(CAP), jnp.asarray(keys), jnp.asarray(vals))
    assert_states_equal(js, tsa.sa_bulk_build(tsa.SAConfig(CAP), t(keys), t(vals)), f"bulk build of {n}")


def test_sa_bulk_build_beyond_capacity_raises():
    keys = np.arange(CAP + 1, dtype=np.int32)
    with pytest.raises(ValueError, match="capacity"):
        jsa.sa_bulk_build(jsa.SAConfig(CAP), jnp.asarray(keys), jnp.asarray(keys))
    with pytest.raises(ValueError, match="capacity"):
        tsa.sa_bulk_build(tsa.SAConfig(CAP), t(keys), t(keys))


def test_sa_init_matches():
    assert_states_equal(jsa.sa_init(jsa.SAConfig(CAP)), tsa.sa_init(tsa.SAConfig(CAP), "cpu"), "init")


def test_sa_state_round_trip():
    rng = np.random.default_rng(3)
    keys = rng.choice(1000, 50, replace=False).astype(np.int32)
    js = jsa.sa_bulk_build(jsa.SAConfig(CAP), jnp.asarray(keys), jnp.asarray(keys + 1))
    js = jitted("delete")(js, keys[:B])
    ts = convert.sa_state_from_numpy(tsa.SAConfig(CAP), jax.device_get(js)._asdict(), "cpu")
    assert_states_equal(js, ts, "round trip")
    # And back: the JAX functions take the port's state.
    back = jsa.SAState(**{k: jnp.asarray(v) for k, v in convert.sa_state_to_numpy(ts).items()})
    for got, exp in zip(jitted("lookup")(back, keys), jitted("lookup")(js, keys)):
        np.testing.assert_array_equal(np.asarray(got), np.asarray(exp))
    with pytest.raises(ValueError, match="slots"):
        convert.sa_state_from_numpy(tsa.SAConfig(CAP + 1), jax.device_get(js)._asdict(), "cpu")
