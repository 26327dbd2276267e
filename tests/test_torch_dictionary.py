"""Facade parity: repro_torch.api.Dictionary against repro.api.Dictionary.

tests/harness.py's op sequences (ragged updates, duplicates, tombstone churn,
flush, cleanup, budgeted maintain) replay through both facades, for the
"lsm" and "sorted_array" backends; after every op both must equal the dict
oracle and each other, range padding included. Also: bulk_build and its
checks, linear handles, key-domain errors, capability errors, and the
card-by-default rule.
"""

import numpy as np
import pytest
import torch

import harness
from repro.api import Dictionary as JaxDictionary
from repro.api import KeyDomainError as JaxKeyDomainError
from repro_torch.api import (
    CapabilityError,
    ConsumedHandleError,
    Dictionary,
    KeyDomainError,
    QueryPlan,
)
from repro_torch.api import dictionary as tdict
from repro_torch.core import semantics as sem


def both(backend="lsm", **options):
    return {
        "torch": Dictionary.create(backend, device="cpu", **options),
        "jax": JaxDictionary.create(backend, **options),
    }


@pytest.mark.parametrize("seed,b,options", [
    (0, 8, {}),
    (1, 8, {"flush_threshold": 5}),
    (2, 16, {"maintenance_budget": 48}),
    (3, 8, {"flush_threshold": 8, "maintenance_budget": 8}),
])
def test_gen_ops_parity(seed, b, options):
    rng = np.random.default_rng(seed)
    pool = harness.key_pool(rng)
    ops = harness.gen_ops(rng, pool, n_steps=9, batch_size=b)
    k1, k2 = harness.query_ranges(pool)
    plan = QueryPlan(max_candidates=512, max_results=512)
    dicts = both(capacity=63 * b, batch_size=b, **options)  # no overflow: the oracle has none
    harness.run_differential(dicts, ops, plan=plan, query_keys=np.concatenate([pool, [3, 4]]), k1=k1, k2=k2)


@pytest.mark.parametrize("seed,b", [(4, 8), (5, 16)])
def test_gen_ops_parity_sorted_array(seed, b):
    rng = np.random.default_rng(seed)
    pool = harness.key_pool(rng)
    ops = harness.gen_ops(rng, pool, n_steps=9, batch_size=b)
    k1, k2 = harness.query_ranges(pool)
    plan = QueryPlan(max_candidates=512, max_results=512)
    dicts = both("sorted_array", capacity=63 * b, batch_size=b)
    harness.run_differential(dicts, ops, plan=plan, query_keys=np.concatenate([pool, [3, 4]]), k1=k1, k2=k2)


@pytest.mark.parametrize("backend,n", [("lsm", 45), ("sorted_array", 45)])
def test_bulk_build_parity(backend, n):
    rng = np.random.default_rng(n)
    pool = harness.key_pool(rng, extra=96)
    keys = rng.choice(pool, n, replace=False)
    vals = rng.integers(-1000, 1000, n).astype(np.int32)
    dicts = both(backend, capacity=504, batch_size=8)
    dicts = {name: d.bulk_build(keys, vals) for name, d in dicts.items()}
    k1, k2 = harness.query_ranges(pool)
    plan = QueryPlan(max_candidates=512, max_results=512)
    query_keys = np.concatenate([pool, [3, 4]])
    raw = [harness.check_vs_oracle(name, d, dict(zip(keys.tolist(), vals.tolist())), query_keys, k1, k2, plan)
           for name, d in dicts.items()]
    for got, exp in zip(*raw):
        np.testing.assert_array_equal(got, exp)
    # Then updates on top. The first re-writes what the bulk build holds, so
    # the differential run's oracle starts from it.
    ops = [("update", keys, vals, np.zeros(n, bool))] + harness.gen_ops(rng, pool, n_steps=3, batch_size=8)
    harness.run_differential(dicts, ops, plan=plan, query_keys=query_keys, k1=k1, k2=k2)


@pytest.mark.parametrize("backend", ["lsm", "sorted_array"])
def test_bulk_build_checks(backend):
    d = Dictionary.create(backend, device="cpu", capacity=64, batch_size=8)
    j = JaxDictionary.create(backend, capacity=64, batch_size=8)
    for h, domain_error in ((d, KeyDomainError), (j, JaxKeyDomainError)):
        with pytest.raises(domain_error):
            h.bulk_build(np.array([1, sem.PLACEBO_KEY]), np.array([1, 2]))
        with pytest.raises(ValueError, match="unique"):
            h.bulk_build(np.array([4, 9, 4]), np.array([1, 2, 3]))
    # A refused call leaves the handle live; a bulk build consumes it.
    built = d.bulk_build(torch.tensor([9, 4, 7]), 5)
    assert built.lookup([4, 7, 9, 1])[1].tolist() == [5, 5, 5, 0]
    with pytest.raises(ConsumedHandleError):
        d.lookup([4])
    # validate=False skips the checks.
    loose = Dictionary.create(backend, device="cpu", capacity=64, batch_size=8, validate=False)
    loose = loose.bulk_build(np.array([3, 3]), np.array([1, 2]))
    assert int(loose.size()) == 1
    with pytest.raises(ValueError, match="capacity"):
        Dictionary.create(backend, device="cpu", capacity=64, batch_size=8).bulk_build(
            np.arange(200), np.arange(200))


def test_sorted_array_capabilities():
    d = Dictionary.create("sorted_array", device="cpu", capacity=64, batch_size=8)
    with pytest.raises(CapabilityError, match="maintain"):
        d.maintain(8)
    with pytest.raises(CapabilityError, match="maintain"):
        Dictionary.create("sorted_array", device="cpu", capacity=64, maintenance_budget=8)
    d = d.insert([5, 5, 6], [1, 2, 3])
    assert d.pending() == 0 and d.flush_cost_estimate() == 0
    assert [int(x) for x in d.occupancy()] == [0, 3, 0]
    assert not d.overflowed()


def test_valid_mask_and_occupancy_parity():
    rng = np.random.default_rng(11)
    d = both(capacity=56, batch_size=8)
    for _ in range(5):
        n = int(rng.integers(1, 30))
        keys = rng.integers(0, 40, n)
        vals = rng.integers(-9, 9, n).astype(np.int32)
        dels = rng.random(n) < 0.3
        valid = rng.random(n) < 0.6
        d = {k: h.update(keys, vals, is_delete=dels, valid=valid) for k, h in d.items()}
        t, j = d["torch"], d["jax"]
        assert t.pending() == int(j.pending())
        assert t.flush_cost_estimate() == int(j.flush_cost_estimate())
        assert [int(x) for x in t.occupancy()] == [int(x) for x in j.occupancy()]
        q = np.arange(42)
        for got, exp in zip(t.lookup(q), j.lookup(q)):
            np.testing.assert_array_equal(got.numpy(), np.asarray(exp))
        assert int(t.size()) == int(j.size())
        assert t.overflowed() == bool(j.overflowed())


def test_default_plan_auto_sizing_matches():
    t = Dictionary.create("lsm", device="cpu", capacity=100, batch_size=8)
    j = JaxDictionary.create("lsm", capacity=100, batch_size=8)
    assert t.capacity == j.capacity and t.batch_size == j.batch_size
    t, j = t.insert([1, 5, 9], [10, 50, 90]), j.insert([1, 5, 9], [10, 50, 90])
    for got, exp in zip(t.range([0, 4], [6, 100]), j.range([0, 4], [6, 100])):
        np.testing.assert_array_equal(got.numpy(), np.asarray(exp))


def test_consumed_handle_raises():
    d = Dictionary.create("lsm", device="cpu", capacity=64, batch_size=8)
    d2 = d.insert([1, 2, 3], [4, 5, 6])
    with pytest.raises(ConsumedHandleError):
        d.lookup([1])
    with pytest.raises(ConsumedHandleError):
        d.insert([4], [4])
    d3 = d2.flush()
    for op in (lambda h: h.size(), lambda h: h.cleanup(), lambda h: h.maintain(8), lambda h: h.pending()):
        with pytest.raises(ConsumedHandleError):
            op(d2)
    found, vals = d3.lookup([1, 2, 3, 4])
    assert found.tolist() == [True, True, True, False]
    assert vals.tolist()[:3] == [4, 5, 6]


def test_empty_update_keeps_handle():
    d = Dictionary.create("lsm", device="cpu", capacity=64, batch_size=8)
    assert d.insert(np.zeros(0, np.int64), np.zeros(0, np.int32)) is d
    d.lookup([0])  # still live


@pytest.mark.parametrize("bad", [[-1], [sem.PLACEBO_KEY], [1 << 31], [5, sem.MAX_USER_KEY + 7]])
@pytest.mark.parametrize("wrap", [np.array, torch.tensor], ids=["numpy", "tensor"])
def test_key_domain_errors(bad, wrap):
    # Tensors are checked on their own device, numpy arrays on the host.
    d = Dictionary.create("lsm", device="cpu", capacity=64, batch_size=8)
    with pytest.raises(KeyDomainError):
        d.insert(wrap(bad, dtype=np.int64 if wrap is np.array else torch.int64), np.zeros(len(bad), np.int32))
    with pytest.raises(KeyDomainError):
        d.lookup(wrap(bad))
    with pytest.raises(KeyDomainError):
        d.count(wrap(bad), wrap(bad))
    with pytest.raises(KeyDomainError):
        d.bulk_build(wrap(bad), np.zeros(len(bad), np.int32))
    # Masked-out lanes are exempt, and the handle survives a refused call.
    d = d.insert(wrap(bad + [3]), np.zeros(len(bad) + 1, np.int32),
                 valid=np.array([False] * len(bad) + [True]))
    assert d.lookup([3])[0].tolist() == [True]


def test_float_keys_rejected():
    d = Dictionary.create("lsm", device="cpu", capacity=64, batch_size=8)
    with pytest.raises(KeyDomainError):
        d.lookup(np.array([1.5]))
    for bad in (torch.tensor([1.5]), torch.tensor([True])):
        with pytest.raises(KeyDomainError):
            d.lookup(bad)


def test_create_defaults_to_the_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        Dictionary.create("lsm", capacity=64, batch_size=8)
    with pytest.raises(RuntimeError, match="CUDA"):
        Dictionary.create("lsm", capacity=64, batch_size=8, device="cuda")
    assert tdict.resolve_device("cpu") == torch.device("cpu")


def test_create_option_errors():
    with pytest.raises(TypeError):
        Dictionary.create("lsm", device="cpu", load_factor=0.5)
    with pytest.raises(KeyError, match="ROADMAP.md queue A item 10"):
        Dictionary.create("lsm_sharded", device="cpu")
    # The cuckoo backend is ported: the reference's option errors.
    with pytest.raises(TypeError):
        Dictionary.create("cuckoo", device="cpu", num_levels=4)
    with pytest.raises(CapabilityError):
        Dictionary.create("cuckoo", device="cpu", maintenance_budget=8)
    with pytest.raises(ValueError):
        Dictionary.create("lsm", device="cpu", batch_size=8, flush_threshold=9)
    with pytest.raises(ValueError):
        Dictionary.create("lsm", device="cpu", maintenance_budget=0)
