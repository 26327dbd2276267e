"""The CUDA kernels against their plain versions, on a card (exact).

They skip without a CUDA device. On a machine with one, run them without
the suite's conftest (it imports JAX, which this file does not need):

    PYTHONPATH=src python -m pytest -q --noconftest -m cuda tests/test_torch_cuda.py
"""

import os

import numpy as np
import pytest
import torch

# cuBLAS reads this when CUDA starts; the supervisor test below runs under
# torch.use_deterministic_algorithms(True), which requires it.
os.environ.setdefault("CUBLAS_WORKSPACE_CONFIG", ":4096:8")

from repro_torch.kernels import bitonic_sort, lsm_lookup, merge_path
from torch_cases import (
    LOOKUP_CASES, MAX_USER_KEY, MERGE_CASES, PAIR_LENGTHS, QUERY_EDGES, SORT_NS, eq, lookup_case, merge_pair, runs_np,
    sort_case, sorted_run, t,
)


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device and nvcc: the kernels run only on the card")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("lengths,key_hi", MERGE_CASES)
def test_cuda_merge_matches_plain(cuda, lengths, key_hi):
    runs = runs_np(len(lengths) + key_hi, lengths, key_hi)
    for compare_full in (False, True):
        if compare_full:
            runs = [(np.sort(kv), v) for kv, v in runs]
        got = merge_path.merge_cascade_path(
            [t(kv).to(cuda) for kv, _ in runs], [t(v).to(cuda) for _, v in runs], compare_full=compare_full)
        exp = merge_path.merge_cascade_path(
            [t(kv) for kv, _ in runs], [t(v) for _, v in runs], compare_full=compare_full)
        eq(got[0].cpu(), exp[0])
        eq(got[1].cpu(), exp[1])


@pytest.mark.cuda
@pytest.mark.parametrize("key_hi", [5, 1000])
@pytest.mark.parametrize("n", [0, 1, 3, 31, 33, 255, 257, 4095, 4097, 4099, (1 << 16) + 1])
def test_cuda_bounds_match_plain(cuda, n, key_hi):
    """Lengths 0, 1, 3 and 2^k +- 1; with few keys the placebo tail (a third
    of the run) and the equal-key segments span many probes."""
    rng = np.random.default_rng(n)
    kv, _ = sorted_run(rng, n, key_hi, placebo_tail=n // 3)
    q = np.concatenate([rng.integers(-1, key_hi + 2, 500), QUERY_EDGES]).astype(np.int32)
    for upper in (False, True):
        got = lsm_lookup.bound(t(kv).to(cuda), t(q).to(cuda), upper=upper)
        eq(got.cpu(), lsm_lookup.bound(t(kv), t(q), upper=upper))


@pytest.mark.cuda
@pytest.mark.parametrize("key_hi", [4, 1 << 12, 1 << 24])
def test_cuda_bounds_runs_match_plain(cuda, key_hi):
    """13 runs as count/range sees them: an empty write buffer, levels with
    placebo tails (every fourth all placebos), windows with k1 > k2 and the
    edge keys at both ends."""
    rng = np.random.default_rng(key_hi)
    lengths = [0] + [(1 << 8) << i for i in range(12)]
    runs = [sorted_run(rng, n, key_hi, placebo_tail=n if s % 4 == 3 else n // 4)[0] for s, n in enumerate(lengths)]
    k1 = np.concatenate([rng.integers(-1, key_hi + 2, 3000), QUERY_EDGES, [5, MAX_USER_KEY]]).astype(np.int32)
    k2 = np.concatenate([k1[:3000] + rng.integers(-3, 1 << 10, 3000), QUERY_EDGES[::-1], [4, MAX_USER_KEY]])
    k2 = np.clip(k2, -(1 << 31), (1 << 31) - 1).astype(np.int32)
    got = lsm_lookup.bounds_runs([t(kv).to(cuda) for kv in runs], t(k1).to(cuda), t(k2).to(cuda))
    exp = lsm_lookup.bounds_runs_plain([t(kv) for kv in runs], t(k1), t(k2))
    eq(got[0].cpu(), exp[0])
    eq(got[1].cpu(), exp[1])


@pytest.mark.cuda
@pytest.mark.parametrize("na,nb", [(0, 5000), (1, 5000), (5000, 1), (3, 3), (64, 1 << 18), (9000, 9001)])
def test_cuda_merge_split_matches_plain(cuda, na, nb):
    """The split at every tile boundary and at every 7th diagonal."""
    for key_hi in (1, 40, 1 << 20):
        for compare_full in (False, True):
            (a, _), (b, _) = merge_pair(na + nb + key_hi, na, nb, key_hi, compare_full)
            n = na + nb
            diags = torch.cat([torch.arange(0, n + 1, merge_path.path_tile()), torch.arange(0, n + 1, 7),
                               torch.tensor([n])])
            got = merge_path.merge_split(t(a).to(cuda), t(b).to(cuda), diags.to(cuda), compare_full=compare_full)
            shift = 0 if compare_full else 1
            eq(got.cpu(), merge_path.merge_split_plain(t(a) >> shift, t(b) >> shift, diags))


@pytest.mark.cuda
def test_cuda_launch_rejects_mixed_devices(cuda):
    kv = t(np.arange(0, 512, 2, dtype=np.int32))
    with pytest.raises(ValueError, match="CUDA"):
        lsm_lookup.bound(kv.to(cuda), kv)
    with pytest.raises(ValueError, match="CUDA"):
        merge_path.merge_cascade_path([kv.to(cuda), kv], [kv.to(cuda), kv])
    with pytest.raises(ValueError, match="CUDA"):
        lsm_lookup.fused_lookup_runs([kv.to(cuda)], [kv], kv.to(cuda))
    with pytest.raises(ValueError, match="CUDA"):
        merge_path.merge_path(kv.to(cuda), kv.to(cuda), kv, kv)
    with pytest.raises(ValueError, match="CUDA"):
        bitonic_sort.block_sort(kv.to(cuda), kv)
    with pytest.raises(ValueError, match="CUDA"):
        lsm_lookup.bounds_runs([kv.to(cuda), kv], kv.to(cuda), kv.to(cuda))


@pytest.mark.cuda
def test_cuda_fused_lookup_matches_plain(cuda):
    runs, q = lookup_case(9, [8, 0, 16, 32, 64, 128, 256], 200, 1000)
    got = lsm_lookup.fused_lookup_runs(
        [t(kv).to(cuda) for kv, _ in runs], [t(v).to(cuda) for _, v in runs], t(q).to(cuda))
    exp = lsm_lookup.fused_lookup_runs([t(kv) for kv, _ in runs], [t(v) for _, v in runs], t(q))
    eq(got[0].cpu(), exp[0])
    eq(got[1].cpu(), exp[1])


@pytest.mark.cuda
@pytest.mark.parametrize("side", ["1000", "below", "above"])  # of the fewest queries taken in bucket order
@pytest.mark.parametrize("case", range(len(LOOKUP_CASES)))
def test_cuda_lookup_cases_match_plain(cuda, case, side):
    bucket_min = lsm_lookup.LOOKUP_KERNEL.constant("repro_lookup_bucket_min")
    nq = {"1000": 1000, "below": bucket_min - 1, "above": bucket_min + 3}[side]
    lengths, key_hi = LOOKUP_CASES[case]
    runs, q = lookup_case(100 + case, lengths, key_hi, nq)
    kvs, vals = [t(kv) for kv, _ in runs], [t(v) for _, v in runs]
    got = lsm_lookup.fused_lookup_runs([x.to(cuda) for x in kvs], [x.to(cuda) for x in vals], t(q).to(cuda))
    exp = lsm_lookup.fused_lookup_plain(kvs, vals, t(q))
    eq(got[0].cpu(), exp[0])
    eq(got[1].cpu(), exp[1])


@pytest.mark.cuda
@pytest.mark.parametrize("nq", [4097, 1 << 18])
def test_cuda_lookup_stride_crossing_segments(cuda, nq):
    """One run of 2^22 slots over 64 keys: every equal-key segment (mixed
    status bits) spans ~2^16 slots, many sample strides of the kernel."""
    rng = np.random.default_rng(nq)
    kv, val = sorted_run(rng, 1 << 22, 64, placebo_tail=1 << 18)
    q = np.concatenate([rng.integers(-1, 67, nq - len(QUERY_EDGES)), QUERY_EDGES]).astype(np.int32)
    got = lsm_lookup.fused_lookup_runs([t(kv).to(cuda)], [t(val).to(cuda)], t(q).to(cuda))
    exp = lsm_lookup.fused_lookup_plain([t(kv)], [t(val)], t(q))
    eq(got[0].cpu(), exp[0])
    eq(got[1].cpu(), exp[1])
    assert ((exp[0] >> 1 == t(q)) & (exp[0] & 1 == 0)).any()  # tombstone hits


# Count/range stages 2-5 (csrc/window_select.cu): run lengths, key_hi,
# windows, window width, and the (max_candidates, max_results) plans. Few
# keys put duplicates within and across runs (mixed status bits, every
# fourth run all placebos); small plans cut windows inside a run and
# overflow rows; M = 2944 is the most a COUNT buffer keeps in shared memory,
# M = 3000 and above (RANGE from 2770) take the scratch array.
SELECT_CASES = [
    ([1 << 12] + [256 << i for i in range(10)], 1 << 16, 3000, 600, [(100, 16), (1024, 512), (333, 40)]),
    ([5000], 100, 1000, 20, [(1000, 50), (64, 3)]),
    ([300] * 32, 3000, 2000, 100, [(777, 100), (33, 5)]),
    ([0, 17, 0, 0, 250, 0], 60, 500, 20, [(30, 8), (1, 1), (0, 0)]),
    ([1 << 14] * 4, 1 << 12, 1500, 400, [(2944, 0), (3000, 300), (5000, 300), (8192, 1024)]),
    ([100, 0, 100], 50, 0, 10, [(16, 4)]),
]


@pytest.mark.cuda
def test_cuda_window_select_matches_plain(cuda):
    """count_runs / range_runs on the card (one launch of the kernel after
    stage 1) against the same calls on CPU tensors (the plain tile, row sort
    and masks), bit for bit, ok=False windows included."""
    from repro_torch.core import queries
    from repro_torch.kernels import window_select

    kernel = window_select.SELECT_KERNEL
    seen = {"cut": False, "overflow": False}
    for c, (lengths, key_hi, nq, width, plans) in enumerate(SELECT_CASES):
        rng = np.random.default_rng(40 + c)
        runs = [sorted_run(rng, n, key_hi, placebo_tail=n if s % 4 == 3 else n // 4) for s, n in enumerate(lengths)]
        k1 = np.concatenate([rng.integers(-2, key_hi + 3, max(nq - len(QUERY_EDGES), 0)), QUERY_EDGES])[:nq]
        k2 = np.clip(k1 + rng.integers(-3, width, nq), -(1 << 31), (1 << 31) - 1).astype(np.int32)
        k1 = k1.astype(np.int32)
        cpu = [(t(kv), t(v)) for kv, v in runs]
        dev = [(kv.to(cuda), v.to(cuda)) for kv, v in cpu]
        windows_cpu, windows_dev = (t(k1), t(k2)), (t(k1).to(cuda), t(k2).to(cuda))
        lows, highs = lsm_lookup.bounds_runs_plain([kv for kv, _ in cpu], *windows_cpu)
        total = (highs - lows).clamp(min=0).sum(0)
        for m, r in plans:
            for name, call in (("count", lambda rs, w: queries.count_runs(rs, *w, m)),
                               ("range", lambda rs, w: queries.range_runs(rs, *w, m, r))):
                before = kernel.launches
                got = call(dev, windows_dev)
                assert kernel.launches == before + 1, (c, m, name)
                exp = call(cpu, windows_cpu)
                for g, e in zip(got, exp):
                    assert g.is_cuda and g.dtype == e.dtype and g.shape == e.shape
                    eq(g.cpu(), e)
                if name == "range" and nq:
                    seen["cut"] |= bool((total > m).any())
                    seen["overflow"] |= bool((exp[2] > r).any())
    assert seen == {"cut": True, "overflow": True}


@pytest.mark.cuda
def test_cuda_window_select_counters(cuda):
    """The tracing counters of one count call on the card: the windows the
    kernel answered, the slots of the plan, and the candidates it holds."""
    from repro_torch import obs
    from repro_torch.core import queries

    rng = np.random.default_rng(3)
    runs = [sorted_run(rng, n, 500, placebo_tail=n // 4) for n in (64, 0, 256, 1024)]
    k1 = rng.integers(0, 500, 700).astype(np.int32)
    k2 = (k1 + 60).astype(np.int32)
    dev = [(t(kv).to(cuda), t(v).to(cuda)) for kv, v in runs]
    lows, highs = lsm_lookup.bounds_runs_plain([t(kv) for kv, _ in runs], t(k1), t(k2))
    obs.reset()
    obs.enable(True)
    try:
        queries.count_runs(dev, t(k1).to(cuda), t(k2).to(cuda), 48)
        got = obs.counters()
    finally:
        obs.enable(False)
        obs.reset()
    assert got["queries.window_kernel"] == 700 and got["queries.tile_slots"] == 700 * 48
    assert got["queries.candidates"] == int((highs - lows).clamp(min=0).sum(0).clamp(max=48).sum())


@pytest.mark.cuda
@pytest.mark.parametrize("n", SORT_NS + [1 << 16, 5 << 12])
def test_cuda_sort_matches_plain(cuda, n):
    kv, val = sort_case(n, n, 6)  # few distinct keys: identical key variables repeat
    got = bitonic_sort.bitonic_sort_pairs(t(kv).to(cuda), t(val).to(cuda))
    exp = bitonic_sort.sort_pairs_plain(t(kv), t(val))
    eq(got[0].cpu(), exp[0])
    eq(got[1].cpu(), exp[1])
    got = bitonic_sort.block_sort(t(kv).to(cuda), t(val).to(cuda))
    exp = bitonic_sort.block_sort_plain(t(kv), t(val))
    eq(got[0].cpu(), exp[0])
    eq(got[1].cpu(), exp[1])


@pytest.mark.cuda
@pytest.mark.parametrize("na_tiles,na_extra", [(0, n) for n in PAIR_LENGTHS + [3, 3000]] + [(1, 1), (2, 1)])
@pytest.mark.parametrize("nb", PAIR_LENGTHS + [3, 5000, 70001])
def test_cuda_merge_path_matches_plain(cuda, na_tiles, na_extra, nb):
    """Lengths around a merge tile (`a` holds na_tiles kernel tiles and
    na_extra elements); inputs at the start of their storage and as views 1
    or 3 elements into it (windows and bases off a 16-byte boundary: scalar
    loads), a fresh output and one 1 element into its storage (scalar
    stores); one key everywhere (ties across whole tiles) and random keys."""
    na = na_tiles * merge_path.path_tile() + na_extra
    for key_hi, offset in ((30, 0), (1, 1), (1 << 20, 3)):
        for compare_full in (False, True):
            runs = merge_pair(na * 7 + nb + key_hi, na, nb, key_hi, compare_full)
            args = [torch.cat([t(np.zeros(offset, np.int32)), t(a)]).to(cuda)[offset:] for run in runs for a in run]
            exp = merge_path.merge_path(*[a.cpu() for a in args], compare_full=compare_full)
            out = [torch.empty(na + nb + 1, dtype=torch.int32, device=cuda)[1:] for _ in range(2)]
            for o in (None, out):
                got = merge_path.merge_path(*args, compare_full=compare_full, out=o)
                eq(got[0].cpu(), exp[0])
                eq(got[1].cpu(), exp[1])


@pytest.mark.cuda
@pytest.mark.parametrize("n,width,k", [(5, 8, 2), (13, 4, 3), (3000, 1024, 2), (5000, 1024, 32),
                                       ((1 << 16) + 77, 4096, 5), (40, 5, 1)])
def test_cuda_merge_groups_matches_plain(cuda, n, width, k):
    kv, val = map(t, sort_case(n, n, 50))
    for s in range(0, n, width):  # each run sorted by the full key variable
        order = torch.sort(kv[s:s + width], stable=True).indices
        kv[s:s + width], val[s:s + width] = kv[s:s + width][order], val[s:s + width][order]
    got = merge_path.merge_groups(kv.to(cuda), val.to(cuda), width, k, compare_full=True)
    exp = merge_path.merge_groups(kv, val, width, k, compare_full=True)
    eq(got[0].cpu(), exp[0])
    eq(got[1].cpu(), exp[1])


# Tie-heavy K-way cases: K runs of all-equal keys spanning many 4096-element
# tiles; LSM levels with placebo tails and all-placebo levels; K = 1.
KWAY_CASES = [
    ("equal", [5000] * 32), ("equal", [1, 0, 9000, 3, 4096, 4097]),
    ("placebo", [1 << 10] + [1 << (10 + i) for i in range(12)]), ("random", [0]), ("random", [12345]),
    ("random", [3, 0, 1, 70000, 5, 4095, 4097, 1 << 15, 0, 2, 6, 8, 1]),
]


def kway_runs(kind, lengths, seed):
    rng = np.random.default_rng(seed)
    if kind == "equal":
        return [sorted_run(rng, n, 1) for n in lengths]
    if kind == "placebo":
        return [sorted_run(rng, n, 1 << 20, placebo_tail=n if s % 4 == 3 else n // 3)
                for s, n in enumerate(lengths)]
    return [sorted_run(rng, n, 1 << 12, placebo_tail=n // 5) for n in lengths]


@pytest.mark.cuda
@pytest.mark.parametrize("case", range(len(KWAY_CASES)))
def test_cuda_kway_merge_tie_cases_match_plain(cuda, case):
    kind, lengths = KWAY_CASES[case]
    runs = kway_runs(kind, lengths, case)
    for compare_full in (False, True):
        if compare_full:
            runs = [(np.sort(kv), v) for kv, v in runs]
        kvs, vals = [t(kv) for kv, _ in runs], [t(v) for _, v in runs]
        got = merge_path.merge_cascade_path([x.to(cuda) for x in kvs], [x.to(cuda) for x in vals],
                                            compare_full=compare_full)
        exp = merge_path.merge_cascade_plain(kvs, vals, shift=0 if compare_full else 1)
        eq(got[0].cpu(), exp[0])
        eq(got[1].cpu(), exp[1])


@pytest.mark.cuda
@pytest.mark.parametrize("case", range(len(KWAY_CASES)))
def test_cuda_cascade_split_matches_plain(cuda, case):
    kind, lengths = KWAY_CASES[case]
    kvs = [t(kv) for kv, _ in kway_runs(kind, lengths, case)]
    total = sum(lengths)
    diags = torch.cat([torch.arange(0, total + 1, 4096), torch.arange(0, total + 1, 997), torch.tensor([total])])
    for compare_full in (False, True):
        if compare_full:  # runs sorted by the full key variable
            kvs = [torch.sort(x).values for x in kvs]
        got = merge_path.cascade_split([x.to(cuda) for x in kvs], diags.to(cuda), compare_full=compare_full)
        exp = merge_path.cascade_split_plain(kvs, diags, shift=0 if compare_full else 1)
        eq(got.cpu(), exp)


# -- the modules above the kernels: on the card against the same calls on the CPU


def both_devices(fn, cuda):
    """fn(device) on the card and on the CPU; every tensor of the results to the host."""
    def host(x):
        if isinstance(x, torch.Tensor):
            return x.cpu()
        if isinstance(x, (tuple, list)):
            return type(x)(host(y) for y in x)
        return x
    return host(fn(cuda)), host(fn(torch.device("cpu")))


def assert_same(got, exp):
    if isinstance(exp, torch.Tensor):
        eq(got, exp)
    elif isinstance(exp, np.ndarray):
        assert got.dtype == exp.dtype
        np.testing.assert_array_equal(got, exp)
    elif isinstance(exp, (tuple, list)):
        assert len(got) == len(exp)
        for g, e in zip(got, exp):
            assert_same(g, e)
    else:
        assert got == exp


@pytest.mark.cuda
@pytest.mark.parametrize("n,load,seed,max_rounds", [(1000, 0.8, 0, 100), (1 << 16, 0.8, 1, 100), (4000, 0.95, 1, 3)])
def test_cuda_cuckoo_matches_cpu(cuda, n, load, seed, max_rounds):
    from repro_torch.core import cuckoo

    rng = np.random.default_rng(n)
    keys = rng.choice(MAX_USER_KEY + 1, n, replace=False).astype(np.int32)
    vals = rng.integers(-(1 << 30), 1 << 30, n).astype(np.int32)
    q = np.concatenate([keys, rng.integers(0, MAX_USER_KEY + 1, 1000), QUERY_EDGES]).astype(np.int32)
    cfg = cuckoo.CuckooConfig(int(n / load), max_rounds, seed)

    def run(device):
        table = cuckoo.cuckoo_build(cfg, t(keys).to(device), t(vals).to(device))
        return table.slot_keys, table.slot_vals, table.build_ok, table.rounds, cuckoo.cuckoo_lookup(cfg, table, t(q).to(device))

    got, exp = both_devices(run, cuda)
    assert_same(got, exp)
    assert exp[2] == (max_rounds == 100)


@pytest.mark.cuda
@pytest.mark.parametrize("opts", [{"backend": "lsm", "num_levels": 8}, {"backend": "sorted_array", "capacity": 4096},
                                  {"backend": "lsm_sharded", "num_levels": 8, "num_shards": 4}])
def test_cuda_server_trace_matches_cpu(cuda, opts):
    from repro_torch.serve import traffic
    from repro_torch.serve.server import DictionaryServer, ServerConfig

    tenants, trace = traffic.make_trace("mixed", num_tenants=8, key_space=512, events=200, seed=5)

    def run(device):
        # An indexed card holds every shard of the sharded backend.
        dev = torch.device("cuda", torch.cuda.current_device()) if device.type == "cuda" else device
        srv = DictionaryServer(ServerConfig(batch_size=64, device=dev, **opts))
        for name in tenants:
            srv.register_tenant(name, key_space=512)
        results = traffic.replay_server(srv, trace, step_every=32)
        srv.cleanup()
        end = [srv.submit_lookup(name, np.arange(512)).result() for name in tenants]
        return results, end, [srv.stats.as_dict()], srv.pending_estimate()

    got, exp = both_devices(run, cuda)
    assert_same(got, exp)


@pytest.mark.cuda
def test_cuda_dedup_steps_match_cpu(cuda):
    from repro_torch import convert
    from repro_torch.data import pipeline

    def run(device):
        cfg = pipeline.PipelineConfig(vocab_size=512, seq_len=64, batch_per_shard=256, dedup_levels=6, device=device)
        state, out = pipeline.pipeline_init(cfg), []
        for step in (0, 1, 0):
            state, batch, n_dup = pipeline.dedup_batch(cfg, state, pipeline.make_batch(cfg, 0, step), 0, step)
            out += [batch["tokens"], batch["labels"], n_dup, state.duplicates_seen]
        index = convert.lsm_state_to_numpy(state.dedup_index)
        return out, [index[k] for k in sorted(index) if k not in ("key_vars", "values")], list(index["key_vars"])

    got, exp = both_devices(run, cuda)
    assert_same(got, exp)
    assert int(exp[0][-2]) == 256


def sharded_ops(rng, b, n_calls):
    """Ragged facade updates over keys spread across 4 shard ranges and
    clustered at their boundaries (duplicates, deletes, negative values)."""
    edges = np.array([k for s in range(1, 4) for k in (s * (1 << 28) - 1, s * (1 << 28))] + [0, MAX_USER_KEY])
    pool = np.concatenate([edges, rng.integers(0, MAX_USER_KEY + 1, 6 * b), rng.integers(0, 3000, b)])
    for _ in range(n_calls):
        n = int(rng.integers(1, 3 * b + 2))
        yield (rng.choice(pool, n), rng.integers(-(1 << 20), 1 << 20, n).astype(np.int32), rng.random(n) < 0.3)


@pytest.mark.cuda
@pytest.mark.parametrize("b,levels", [(64, 6), (1024, 5)])
def test_cuda_sharded_dictionary_matches_cpu(cuda, b, levels):
    """Four shards on one card against the same calls with every shard on
    the CPU: bulk build, ragged updates, flush, maintain, direct batches,
    every query, cleanup, and the shard states field by field."""
    from repro_torch import convert
    from repro_torch.api import Dictionary, QueryPlan
    from repro_torch.core import distributed as dist

    def run(device):
        dev = torch.device("cuda", torch.cuda.current_device()) if device.type == "cuda" else device
        rng = np.random.default_rng(b)
        d = Dictionary.create("lsm_sharded", num_shards=4, batch_size=b, num_levels=levels, device=dev)
        keys = rng.choice(MAX_USER_KEY + 1, 5 * b, replace=False)
        d = d.bulk_build(keys, rng.integers(-99, 99, keys.size).astype(np.int32))
        plan = QueryPlan(max_candidates=4 * b, max_results=64)
        q = np.concatenate([keys[:b], rng.integers(0, MAX_USER_KEY + 1, b), [0, MAX_USER_KEY]])
        k1 = np.concatenate([rng.integers(0, MAX_USER_KEY - (1 << 20), 64), [(1 << 28) - 5, (2 << 28) - 5, 0]])
        k2 = np.concatenate([k1[:64] + (1 << 20), [(1 << 28) + 5, (2 << 28) + 5, MAX_USER_KEY]])
        out = []
        for i, (k, v, dl) in enumerate(sharded_ops(rng, b, 12)):
            d = d.update(k, v, is_delete=dl)
            if i == 5:
                d = d.flush().maintain(3 * b)
            out += [d.pending(), list(d.occupancy()), d.flush_cost_estimate()]
        be = d._backend
        kv = torch.from_numpy((rng.choice(keys, b) * 2 + 1).astype(np.int32)).to(dev)
        state = dist.dist_update(be.cfg, be.mesh, dist.dist_flush(be.cfg, be.mesh, d.state), kv, kv)
        out += [list(convert.dist_state_to_numpy(state).values()), d.lookup(q), d.count(k1, k2, plan),
                d.range(k1, k2, plan), d.size()]
        d = d.cleanup()
        out += [list(convert.dist_state_to_numpy(d.state).values()), d.lookup(q), d.size(), d.overflowed()]
        return out

    got, exp = both_devices(run, cuda)
    assert_same(got, exp)


def _leaves(tree):
    if isinstance(tree, dict):
        for v in tree.values():
            yield from _leaves(v)
    elif isinstance(tree, list):
        for v in tree:
            yield from _leaves(v)
    else:
        yield tree


def _model_outputs(cfg, model, batch):
    """train forward, prefill(S-1) and one decode step (the reference smoke
    test's protocol) on the model's device."""
    from repro_torch.models import model_zoo as zoo

    dev = model.embed.device
    b = {k: torch.as_tensor(v, device=dev) for k, v in batch.items()}
    n_prefix = cfg.num_patches if cfg.has_vision_stub else 0
    st = b["tokens"].shape[1]
    with torch.inference_mode():
        logits, aux = zoo.apply_train(cfg, model, b)
        pre, caches = zoo.apply_prefill(cfg, model, dict(b, tokens=b["tokens"][:, :st - 1]), cache_pad_to=st + n_prefix)
        dec, _ = zoo.apply_decode(cfg, model, b["tokens"][:, st - 1:], caches, st - 1 + n_prefix)
    return [logits, aux, pre, dec, *_leaves(caches)]


@pytest.fixture
def fp32_matmuls():
    saved = torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = False
    yield
    torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = saved


@pytest.mark.cuda
@pytest.mark.parametrize("arch", ["qwen2-7b", "granite-20b", "stablelm-1.6b", "codeqwen1.5-7b", "mamba2-780m",
                                  "jamba-v0.1-52b", "olmoe-1b-7b", "deepseek-v3-671b", "internvl2-2b",
                                  "seamless-m4t-medium"])
def test_cuda_smoke_model_matches_cpu(cuda, fp32_matmuls, arch):
    """fp32 with TF32 off: |card - cpu| <= 1e-4 + 1e-3 |cpu| (matrix products
    summed in other orders, exp/tanh differing in the last bits); seamless'
    encoder runs in bf16 whatever the weights, so it takes bf16's 2e-2."""
    import copy

    from repro_torch.configs.base import get_smoke_config
    from repro_torch.models import model_zoo as zoo

    cfg = get_smoke_config(arch)
    cpu_model = zoo.init_params(cfg, seed=1, device="cpu", dtype=torch.float32)
    rng = np.random.default_rng(1)
    st = 32 - (cfg.num_patches if cfg.has_vision_stub else 0)
    batch = {"tokens": rng.integers(0, cfg.vocab_size, (2, st))}
    if cfg.has_vision_stub:
        batch["patch_embeds"] = rng.normal(size=(2, cfg.num_patches, cfg.d_model)).astype(np.float32)
    if cfg.is_encoder_decoder:
        batch["frames"] = rng.normal(size=(2, 16, cfg.d_model)).astype(np.float32)
    exp = _model_outputs(cfg, cpu_model, batch)
    got = _model_outputs(cfg, copy.deepcopy(cpu_model).to(cuda), batch)
    tol = dict(rtol=2e-2, atol=2e-2) if cfg.is_encoder_decoder else dict(rtol=1e-3, atol=1e-4)
    assert len(got) == len(exp)
    for g, e in zip(got, exp):
        assert g.device.type == "cuda" and g.dtype == e.dtype and g.shape == e.shape
        torch.testing.assert_close(g.cpu(), e, **tol)


@pytest.mark.cuda
@pytest.mark.parametrize("direct", [False, True], ids=["server", "direct"])
def test_cuda_serve_matches_cpu(cuda, direct, capsys):
    """Serving qwen2-7b's smoke config: the same page-table
    results on the card as on the CPU, the index emptied at the end."""
    from repro_torch.launch import serve

    argv = ["--smoke", "--requests", "6", "--batch", "4", "--prompt-len", "24", "--page-size", "4",
            "--gen-tokens", "3"] + (["--direct"] if direct else [])
    got = serve.main(argv)  # the card is the default device
    exp = serve.main(argv + ["--device", "cpu"])
    assert got["model"].embed.device.type == "cuda"
    assert got["waves"] == exp["waves"] == [{"pages_per_seq": [6] * 4, "free": 1000}] * 2
    assert got["r"] == exp["r"] == 0 and got["live_pages"] == 0 and got["tokens"] == exp["tokens"]
    assert got.get("stats") == exp.get("stats")


@pytest.mark.cuda
def test_cuda_examples_match_cpu(cuda, capsys, monkeypatch):
    """The quickstart and the serving example's --server variant on cuda:0:
    every line as on the CPU, but for the repr's device field."""
    from torch_cases import run_example, without_device_field

    for name, argv in (("torch_quickstart.py", []), ("torch_dictionary_serving.py", ["--server"])):
        got = run_example(name, argv + ["--device", "cuda:0"], capsys, monkeypatch)
        exp = run_example(name, argv + ["--device", "cpu"], capsys, monkeypatch)
        assert len(got) == len(exp) >= 10
        assert without_device_field(got) == without_device_field(exp), name


# ---------------------------------------------------------------------------
# the training path
# ---------------------------------------------------------------------------

# eps 1e-6: at the default 1e-8 an element whose gradient is at fp32 noise
# takes an update of either sign (tests/test_torch_train.py).
STEP_CFG = dict(lr=1e-3, eps=1e-6, warmup_steps=2, total_steps=10)


def _train_step(cfg, model, batch):
    """One train step on the model's device: (metrics, parameters, m, v) by name."""
    from repro_torch.optim.adam import AdamConfig, adam_init
    from repro_torch.train.steps import make_train_step

    dev = model.embed.device
    ocfg = AdamConfig(**STEP_CFG)
    model, opt, metrics = make_train_step(cfg, ocfg)(
        model, adam_init(ocfg, model), {k: torch.as_tensor(v, device=dev) for k, v in batch.items()})
    return metrics, {n: p.detach() for n, p in model.named_parameters()}, opt.m, opt.v


@pytest.mark.cuda
@pytest.mark.parametrize("arch", ["qwen2-7b", "granite-20b", "stablelm-1.6b", "codeqwen1.5-7b", "mamba2-780m",
                                  "jamba-v0.1-52b", "olmoe-1b-7b", "deepseek-v3-671b", "internvl2-2b",
                                  "seamless-m4t-medium"])
def test_cuda_train_step_matches_cpu(cuda, fp32_matmuls, arch):
    """One train step (remat "full", AdamW) in fp32 with TF32 off: loss,
    aux, grad_norm, lr at rtol 1e-4; every updated parameter and both
    moments within 1e-3 of the tensor's largest magnitude on the CPU. The
    audio encoder runs in bf16 whatever the weights: its leaves take bf16's
    2e-2 elementwise."""
    import copy

    from repro_torch.configs.base import get_smoke_config
    from repro_torch.models import model_zoo as zoo

    cfg = get_smoke_config(arch)
    cpu_model = zoo.init_params(cfg, seed=1, device="cpu", dtype=torch.float32)
    card_model = copy.deepcopy(cpu_model).to(cuda)
    rng = np.random.default_rng(1)
    st = 32 - (cfg.num_patches if cfg.has_vision_stub else 0)
    batch = {"tokens": rng.integers(0, cfg.vocab_size, (2, st)), "labels": rng.integers(0, cfg.vocab_size, (2, st))}
    if cfg.has_vision_stub:
        batch["patch_embeds"] = rng.normal(size=(2, cfg.num_patches, cfg.d_model)).astype(np.float32)
    if cfg.is_encoder_decoder:
        batch["frames"] = rng.normal(size=(2, 16, cfg.d_model)).astype(np.float32)
    exp = _train_step(cfg, cpu_model, batch)
    got = _train_step(cfg, card_model, batch)
    for k in ("loss", "aux_loss", "grad_norm", "lr"):
        torch.testing.assert_close(got[0][k].cpu(), exp[0][k], rtol=1e-4, atol=1e-7)
    for g_tree, e_tree in zip(got[1:], exp[1:]):
        for name, e in e_tree.items():
            g = g_tree[name]
            assert g.device.type == "cuda" and g.dtype == e.dtype and g.shape == e.shape, name
            if name.startswith("enc_"):
                torch.testing.assert_close(g.cpu().float(), e.float(), rtol=2e-2, atol=2e-2)
            else:
                err = (g.cpu().float() - e.float()).abs().max().item()
                assert err <= 1e-3 * e.float().abs().max().item(), (name, err)


@pytest.fixture
def deterministic():
    torch.use_deterministic_algorithms(True)
    yield
    torch.use_deterministic_algorithms(False)


@pytest.mark.cuda
def test_cuda_supervisor_restarts_equal_unbroken_run(cuda, deterministic, tmp_path):
    """The training driver on the card (stablelm's smoke config, the dedup
    index on the card): a failure before the first save (restart from the
    initial state) and one after a save (restore from the checkpoint) each
    end bit for bit equal to an unbroken run: parameters, moments, the dedup
    index and its host fields, and every logged loss."""
    from repro_torch.checkpoint.checkpoint import tree_flatten_with_path
    from repro_torch.launch import train

    argv = ["--smoke", "--steps", "6", "--batch", "8", "--seq", "16", "--log-every", "1"]
    runs = {name: train.run(argv + ["--ckpt-dir", str(tmp_path / name), *extra]) for name, extra in (
        ("unbroken", []), ("early", ["--fail-at", "2", "--save-every", "50"]),
        ("late", ["--fail-at", "4", "--save-every", "2"]))}
    assert "RESTART from initial state (no checkpoint)" in runs["early"]["supervisor_log"]
    assert "RESTART from checkpoint step 4" in runs["late"]["supervisor_log"]
    exp = tree_flatten_with_path(runs["unbroken"]["state"])[0]
    assert exp[0][1].device.type == "cuda"
    for name in ("early", "late"):
        got = tree_flatten_with_path(runs[name]["state"])[0]
        assert [p for p, _ in got] == [p for p, _ in exp]
        for (path, a), (_, b) in zip(got, exp):
            assert (torch.equal(a, b) and a.device == b.device) if isinstance(b, torch.Tensor) else a == b, (name, path)
        assert runs[name]["losses"][-6:] == runs["unbroken"]["losses"], name


@pytest.mark.cuda
def test_cuda_compression_matches_cpu(cuda):
    """int8 compression with error feedback over 1 and 4 ranks on the card
    against the same calls on the CPU, bit for bit: the mean and every
    residual over three calls (fp32, bf16 with a zero leaf, int32 with
    negatives)."""
    for n in (1, 4):
        check_compression(cuda, n)


def check_compression(cuda, n):
    from repro_torch.checkpoint.checkpoint import tree_flatten_with_path, tree_map
    from repro_torch.dist.compression import compressed_tree_psum, init_error_state

    g = torch.Generator().manual_seed(n)
    steps = [[{"w": torch.randn(64, 33, generator=g), "b": {"x": torch.randn(1000, generator=g).bfloat16(),
                                                           "zero": torch.zeros(4, dtype=torch.bfloat16)},
               "c": torch.randint(-50, 50, (7,), generator=g, dtype=torch.int32)} for _ in range(n)]
             for _ in range(3)]
    results = {}
    for where in ("cpu", cuda):
        errs = [init_error_state(tree_map(lambda x: x.to(where), t)) for t in steps[0]]
        for trees in steps:
            mean, errs = compressed_tree_psum([tree_map(lambda x: x.to(where), t) for t in trees], errs)
        results[str(where)] = [mean] + errs
    for got, exp in zip(results[str(cuda)], results["cpu"]):
        for (path, a), (_, b) in zip(tree_flatten_with_path(got)[0], tree_flatten_with_path(exp)[0]):
            assert a.device.type == "cuda" and a.dtype == b.dtype and torch.equal(a.cpu(), b), (n, path)


@pytest.mark.cuda
def test_cuda_restore_and_resume_through_a_plan(cuda, deterministic, tmp_path):
    """A one-device plan over the card restores every leaf there, equal to a
    restore without a plan, and a plan that splits a leaf raises; the
    training driver's --resume on the card restores through its plan and
    ends bit for bit equal to an unbroken run."""
    check_restore_with_a_plan(cuda, tmp_path / "restore")
    check_resume_through_the_plan(tmp_path / "resume")


def check_restore_with_a_plan(cuda, tmp_path):
    from repro_torch.checkpoint.checkpoint import CheckpointManager, TensorSpec, tree_map
    from repro_torch.dist.sharding import Placement, _model_spec, replicated
    from repro_torch.launch.mesh import make_debug_mesh
    from repro_torch.launch.train import best_fit_mesh

    tree = {"w": torch.randn(8, 16).bfloat16(), "n": {"b": torch.arange(16, dtype=torch.int32), "r": 3}}
    cm = CheckpointManager(str(tmp_path))
    cm.save(1, tree)
    mesh = best_fit_mesh([torch.device("cuda", 0)])
    plan = {"w": Placement(mesh, _model_spec((8, 16), mesh)), "n": {"b": replicated(mesh)}}
    got = cm.restore(1, tree_map(TensorSpec.of, tree), shardings=plan)
    exp = cm.restore(1, tree_map(lambda x: TensorSpec(tuple(x.shape), x.dtype, cuda) if isinstance(x, torch.Tensor)
                                 else x, tree))
    assert got["w"].device == got["n"]["b"].device == torch.device("cuda", 0) and got["n"]["r"] == 3
    assert torch.equal(got["w"], exp["w"]) and torch.equal(got["n"]["b"], exp["n"]["b"])
    assert torch.equal(got["w"].cpu(), tree["w"])
    split = make_debug_mesh(1, 2, devices=[cuda, cuda])
    with pytest.raises(ValueError, match="splits"):
        cm.restore(1, tree_map(TensorSpec.of, tree), shardings={"w": Placement(split, (None, "model"))})


def check_resume_through_the_plan(tmp_path):
    import shutil

    from repro_torch.checkpoint.checkpoint import tree_flatten_with_path
    from repro_torch.launch import train

    argv = ["--smoke", "--steps", "6", "--batch", "8", "--seq", "16", "--log-every", "1"]
    unbroken = train.run(argv + ["--ckpt-dir", str(tmp_path / "a")])
    train.run(argv + ["--ckpt-dir", str(tmp_path / "b"), "--save-every", "3"])
    shutil.rmtree(tmp_path / "b" / "step_00000006")
    resumed = train.run(argv + ["--ckpt-dir", str(tmp_path / "b"), "--save-every", "3", "--resume"])
    assert [r["step"] for r in resumed["log"]] == [3, 4, 5]
    exp = tree_flatten_with_path(unbroken["state"])[0]
    got = tree_flatten_with_path(resumed["state"])[0]
    assert [p for p, _ in got] == [p for p, _ in exp]
    for (path, a), (_, b) in zip(got, exp):
        assert (torch.equal(a, b) and a.device == b.device) if isinstance(b, torch.Tensor) else a == b, path
    assert resumed["losses"] == unbroken["losses"][3:]
