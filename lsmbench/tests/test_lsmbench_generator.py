"""The sliding-window generator: the same seed gives the same inputs, the
window keeps its live count, a batch takes effect only when committed, and
the key sets are what they claim."""

import pytest
import torch
from lsmbench_tiny import harness

gen = harness.load_module("generators", "sliding_window")
Keyspace, Stream = gen.Keyspace, gen.Stream

MIX = {"insert": 0.4, "overwrite": 0.2, "delete": 0.4}


def stream(seed, live=1024, bits=16, lanes=64):
    return Stream(Keyspace(bits, seed, "cpu"), live, MIX, seed, lanes)


def test_keyspace_is_a_bijection_onto_the_domain():
    ks = Keyspace(16, 2**31 + 17, "cpu")
    keys = ks.table.to(torch.int64)
    assert keys.numel() == (1 << 16) - 1
    assert torch.unique(keys).numel() == keys.numel()
    assert int(keys.min()) == 0 and int(keys.max()) == (1 << 16) - 2


def test_same_seed_same_inputs_other_seed_other_inputs():
    a, b, c = stream(5), stream(5), stream(6)
    for s in (a, b, c):
        s.bulk()
    for call in range(60):
        ba, bb, bc = a.update(), b.update(), c.update()
        assert all(torch.equal(x, y) for x, y in zip(ba[:3], bb[:3]))
        assert not torch.equal(ba.keys, bc.keys)
        for s, batch in ((a, ba), (b, bb), (c, bc)):
            s.commit(batch)
    shares = {"live": 0.5, "deleted": 0.25, "fresh": 0.5}
    assert torch.equal(a.lookup_keys(512, shares, ("ring", 3)), b.lookup_keys(512, shares, ("ring", 3)))
    assert all(torch.equal(x, y) for x, y in zip(a.windows(64, 256, 1), b.windows(64, 256, 1)))


@pytest.mark.parametrize("chunk_lanes", [256, gen.CHUNK_LANES])
def test_sliding_window_keeps_its_live_count(monkeypatch, chunk_lanes):
    """Also across chunks of made batches (256 lanes: 4 calls a chunk), and
    every write carries a value of its own."""
    monkeypatch.setattr(gen, "CHUNK_LANES", chunk_lanes)
    s = stream(11)
    keys, vals = s.bulk()
    live = dict.fromkeys(keys.tolist())
    values = [vals]
    for call in range(2000):   # far past the first wrap of the insert counters
        batch = s.update()
        assert torch.equal(s.update().keys, batch.keys)   # nothing moves until the commit
        s.commit(batch)
        k, dels = batch.keys, batch.is_delete
        values.append(batch.values)
        for key, d in zip(k.tolist(), dels.tolist()):
            if d:
                assert key in live
                del live[key]
            else:
                live[key] = None
        assert len(live) == s.live == 1024
    assert set(s.live_keys().tolist()) == set(live)
    assert torch.unique(torch.cat(values)).numel() == 1024 + 2000 * 64
    assert s.lo > s.ks.cycle   # the counters wrapped
    assert not set(s.dead_keys().tolist()) & set(live)
    assert not set(s.absent_keys(4096).tolist()) & set(live)


@pytest.mark.parametrize("tag", [("ring", 0, 0), ("round", 5, 0)])
def test_lookup_shares(tag):
    s = stream(12)
    s.bulk()
    for _ in range(40):
        batch = s.update()
        s.commit(batch)
    live = set(s.live_keys().tolist())
    fresh = set(batch.keys[batch.n_del:].tolist())
    q = s.lookup_keys(1000, {"live": 0.5, "deleted": 0.25, "fresh": 0.5}, tag).tolist()
    assert sum(k in live for k in q) == 500
    assert sum(k in fresh for k in q[250:500]) == 250
    assert set(q[500:750]) <= set(s.dead_keys().tolist())
    assert not set(q[500:]) & live


def test_lookups_of_a_round_depend_on_the_window_alone():
    """The window's lookups are made a chunk of calls ahead: the same keys
    as one made for that state alone, and the same again after a replay."""
    a, b = stream(14), stream(14)
    shares = {"live": 0.5, "deleted": 0.25, "fresh": 0.5}
    seen = []
    for s in (a, b):
        s.bulk()
        keys = []
        for call in range(70):
            s.commit(s.update())
            if call % 3 == 0 or s is a:
                keys.append((call, s.lookup_keys(256, shares, ("round", call, 1))))
        seen.append(dict(keys))
    assert all(torch.equal(seen[0][c], k) for c, k in seen[1].items())


def test_windows_stay_in_the_domain():
    s = stream(13)
    k1, k2 = s.windows(4096, 256, 0)
    assert int(k1.min()) >= 0 and int(k2.max()) <= (1 << 16) - 2
    assert torch.equal(k2 - k1, torch.full_like(k1, 255))
