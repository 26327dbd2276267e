"""The CUDA kernels against their plain versions, on a card (exact).

They skip without a CUDA device. On a machine with one, run them without
the suite's conftest (it imports JAX, which this file does not need):

    PYTHONPATH=src python -m pytest -q --noconftest -m cuda tests/test_torch_cuda.py
"""

import numpy as np
import pytest
import torch

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
@pytest.mark.parametrize("opts", [{"backend": "lsm", "num_levels": 8}, {"backend": "sorted_array", "capacity": 4096}])
def test_cuda_server_trace_matches_cpu(cuda, opts):
    from repro_torch.serve import traffic
    from repro_torch.serve.server import DictionaryServer, ServerConfig

    tenants, trace = traffic.make_trace("mixed", num_tenants=8, key_space=512, events=200, seed=5)

    def run(device):
        srv = DictionaryServer(ServerConfig(batch_size=64, device=device, **opts))
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
