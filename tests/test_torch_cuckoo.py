"""The port's cuckoo hash baseline against repro.core.cuckoo and the cuckoo
backend of repro.api, on the CPU.

The same numpy-seeded keys go through both packages; hashes, slot tables,
`build_ok` and lookups must be equal in value and dtype. Also the
reference's seed fault (every seed >= 2 raises OverflowError in both), the
facade's capability errors, and the serving surface (`buffered`,
`num_shards`) of every ported backend against the reference's.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.api import Dictionary as JaxDictionary
from repro.core import cuckoo as jck
from repro_torch import convert
from repro_torch.api import CapabilityError, Dictionary
from repro_torch.core import cuckoo as tck
from torch_cases import INT32_MAX, MAX_USER_KEY, PLACEBO_KEY

EDGE_KEYS = [-(1 << 31), -5, -1, 0, 1, 2, MAX_USER_KEY, PLACEBO_KEY, INT32_MAX]


def configs(table_size, max_rounds=64, seed=0):
    return (jck.CuckooConfig(table_size, max_rounds, seed), tck.CuckooConfig(table_size, max_rounds, seed))


def assert_same(jax_arrays, torch_tensors):
    for a, b in zip(jax_arrays, torch_tensors):
        a = np.asarray(a)
        b = b.numpy() if isinstance(b, torch.Tensor) else np.asarray(b)
        assert a.dtype == b.dtype, (a.dtype, b.dtype)
        np.testing.assert_array_equal(a, b)


def assert_tables_equal(jtable, ttable):
    exp = jax.device_get(jtable)._asdict()
    got = convert.cuckoo_table_to_numpy(ttable)
    assert set(got) == set(exp)
    for name in exp:
        assert got[name].dtype == np.asarray(exp[name]).dtype, name
        np.testing.assert_array_equal(got[name], np.asarray(exp[name]), err_msg=name)


@pytest.mark.parametrize("seed", [0, 1])
@pytest.mark.parametrize("table_size", [1, 7, 125, 1 << 20, (1 << 31) - 1])
def test_hash_matches_reference(table_size, seed):
    rng = np.random.default_rng(table_size)
    keys = np.concatenate([EDGE_KEYS, rng.integers(-(1 << 31), 1 << 31, 500)]).astype(np.int32)
    which = rng.integers(0, 4, keys.size).astype(np.int32)
    jcfg, tcfg = configs(table_size, seed=seed)
    assert_same([jck._hash(jcfg, jnp.asarray(keys), jnp.asarray(which))],
                [tck._hash(tcfg, torch.from_numpy(keys), torch.from_numpy(which))])


def build_case(n, load):
    """tests/test_baselines.py's cuckoo keys: unique, below 2^20."""
    rng = np.random.default_rng(n)
    keys = rng.choice(1 << 20, n, replace=False).astype(np.int32)
    return keys, (keys * 7 % 1009).astype(np.int32), int(n / load)


@pytest.mark.parametrize("seed", [0, 1])
@pytest.mark.parametrize("n,load", [(100, 0.8), (1000, 0.8), (4000, 0.6)])
def test_build_and_lookup_match_reference(n, load, seed):
    keys, vals, m = build_case(n, load)
    jcfg, tcfg = configs(m, max_rounds=200, seed=seed)
    jt = jck.cuckoo_build(jcfg, jnp.asarray(keys), jnp.asarray(vals))
    tt = tck.cuckoo_build(tcfg, torch.from_numpy(keys), torch.from_numpy(vals))
    assert tt.build_ok and bool(jt.build_ok)
    assert_tables_equal(jt, tt)
    q = np.concatenate([keys[:512], keys[:128] + (1 << 21), EDGE_KEYS]).astype(np.int32)
    assert_same(jck.cuckoo_lookup(jcfg, jt, jnp.asarray(q)), tck.cuckoo_lookup(tcfg, tt, torch.from_numpy(q)))
    found, got = tck.cuckoo_lookup(tcfg, tt, torch.from_numpy(keys))
    assert bool(found.all())
    np.testing.assert_array_equal(got.numpy(), vals)


@pytest.mark.parametrize("max_rounds", [1, 3])
def test_too_few_rounds_leave_the_same_partial_table(max_rounds):
    keys, vals, m = build_case(1000, 0.95)
    jcfg, tcfg = configs(m, max_rounds=max_rounds, seed=1)
    jt = jck.cuckoo_build(jcfg, jnp.asarray(keys), jnp.asarray(vals))
    tt = tck.cuckoo_build(tcfg, torch.from_numpy(keys), torch.from_numpy(vals))
    assert not tt.build_ok and not bool(jt.build_ok)
    assert tt.rounds == max_rounds
    assert_tables_equal(jt, tt)
    assert_same(jck.cuckoo_lookup(jcfg, jt, jnp.asarray(keys)), tck.cuckoo_lookup(tcfg, tt, torch.from_numpy(keys)))


@pytest.mark.parametrize("seed", [2, 5, -1])
def test_seed_outside_uint32_raises_in_both(seed):
    """The reference computes uint32(seed * 0x85EBCA6B), which overflows for
    every seed >= 2 (and every negative seed); the port raises the same."""
    keys, vals, m = build_case(100, 0.8)
    jcfg, tcfg = configs(m, seed=seed)
    with pytest.raises(OverflowError):
        jck.cuckoo_build(jcfg, jnp.asarray(keys), jnp.asarray(vals))
    with pytest.raises(OverflowError):
        tck.cuckoo_build(tcfg, torch.from_numpy(keys), torch.from_numpy(vals))
    with pytest.raises(OverflowError):
        Dictionary.create("cuckoo", capacity=128, seed=seed, device="cpu").bulk_build(keys, vals)


def test_table_converters_round_trip():
    keys, vals, m = build_case(100, 0.8)
    _, tcfg = configs(m, seed=1)
    tt = tck.cuckoo_build(tcfg, torch.from_numpy(keys), torch.from_numpy(vals))
    back = convert.cuckoo_table_from_numpy(tcfg, convert.cuckoo_table_to_numpy(tt), "cpu")
    assert back.build_ok == tt.build_ok
    assert torch.equal(back.slot_keys, tt.slot_keys) and torch.equal(back.slot_vals, tt.slot_vals)
    with pytest.raises(ValueError):
        convert.cuckoo_table_from_numpy(tck.CuckooConfig(m + 1), convert.cuckoo_table_to_numpy(tt), "cpu")


@pytest.mark.parametrize("capacity,load_factor,seed", [(64, 0.8, 0), (1000, 0.5, 1)])
def test_facade_matches_reference(capacity, load_factor, seed):
    rng = np.random.default_rng(capacity)
    keys = rng.choice(MAX_USER_KEY + 1, capacity * 3 // 4, replace=False).astype(np.int32)
    vals = rng.integers(-1000, 1000, keys.size).astype(np.int32)
    opts = dict(capacity=capacity, load_factor=load_factor, seed=seed)
    jd = JaxDictionary.create("cuckoo", **opts)
    td = Dictionary.create("cuckoo", device="cpu", **opts)
    assert (td.capacity, td.batch_size, td.buffered, td.num_shards) == (
        jd.capacity, jd.batch_size, jd.buffered, jd.num_shards)
    assert int(td.size()) == int(jd.size()) == 0
    assert td.overflowed() == bool(jd.overflowed()) is False
    jd, td = jd.bulk_build(keys, vals), td.bulk_build(keys, vals)
    assert_tables_equal(jd.state, td.state)
    assert int(td.size()) == int(jd.size()) == keys.size
    assert td.size().dtype == torch.int32
    assert td.overflowed() == bool(jd.overflowed()) is False
    q = np.concatenate([keys, rng.integers(0, MAX_USER_KEY + 1, 200), [0, MAX_USER_KEY]]).astype(np.int32)
    assert_same(jd.lookup(q), td.lookup(q))
    assert td.flush().pending() == 0


def test_facade_overflow_when_the_build_fails():
    keys = np.arange(100, dtype=np.int32)
    opts = dict(capacity=100, load_factor=1.0, max_rounds=2, seed=1)
    jd = JaxDictionary.create("cuckoo", **opts).bulk_build(keys, keys)
    td = Dictionary.create("cuckoo", device="cpu", **opts).bulk_build(keys, keys)
    assert td.overflowed() is True and bool(jd.overflowed())
    assert int(td.size()) == int(jd.size()) < 100
    assert_tables_equal(jd.state, td.state)


def test_capability_errors():
    """tests/test_dictionary_api.py's cuckoo capability checks, on the port:
    lookups work; updates, ordered queries and cleanup raise, naming the
    backends that can."""
    keys = np.arange(50, dtype=np.int32)
    ck = Dictionary.create("cuckoo", capacity=64, device="cpu").bulk_build(keys, keys * 2)
    f, v = ck.lookup(np.asarray([7, 99]))
    assert f.tolist() == [True, False] and int(v[0]) == 14
    assert not ck.capabilities.supports_ordered_queries
    for call, op in ((lambda: ck.count(0, 10), "count"), (lambda: ck.range(0, 10), "range"),
                     (lambda: ck.insert(np.asarray([1]), np.asarray([1])), "update"),
                     (lambda: ck.delete(np.asarray([1])), "delete"), (lambda: ck.cleanup(), "cleanup"),
                     (lambda: ck.maintain(8), "maintain")):
        with pytest.raises(CapabilityError, match=f"does not support '{op}'") as err:
            call()
        if op != "maintain":
            assert "lsm" in str(err.value)


@pytest.mark.parametrize("backend,options", [
    ("lsm", dict(capacity=1000, batch_size=8)),
    ("sorted_array", dict(capacity=1000, batch_size=8)),
    ("cuckoo", dict(capacity=1000)),
])
def test_serving_surface_matches_reference(backend, options):
    jd = JaxDictionary.create(backend, **options)
    td = Dictionary.create(backend, device="cpu", **options)
    assert td.buffered == jd.buffered
    assert td.num_shards == jd.num_shards == 1
    jo, to = jd.occupancy(), td.occupancy()
    assert [int(x) for x in to] == [int(x) for x in jo]
