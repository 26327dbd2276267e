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
    MERGE_CASES, PAIR_LENGTHS, QUERY_EDGES, SORT_NS, eq, lookup_case, merge_pair, runs_np, sort_case,
    sorted_run, t,
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
@pytest.mark.parametrize("n", [0, 1, 255, 4099])
def test_cuda_bounds_match_plain(cuda, n):
    rng = np.random.default_rng(n)
    kv, _ = sorted_run(rng, n, 1000, placebo_tail=n // 5)
    q = np.concatenate([rng.integers(0, 1002, 500), QUERY_EDGES]).astype(np.int32)
    for upper in (False, True):
        got = lsm_lookup.bound(t(kv).to(cuda), t(q).to(cuda), upper=upper)
        eq(got.cpu(), lsm_lookup.bound(t(kv), t(q), upper=upper))


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


@pytest.mark.cuda
def test_cuda_fused_lookup_matches_plain(cuda):
    runs, q = lookup_case(9, [8, 0, 16, 32, 64, 128, 256], 200, 1000)
    got = lsm_lookup.fused_lookup_runs(
        [t(kv).to(cuda) for kv, _ in runs], [t(v).to(cuda) for _, v in runs], t(q).to(cuda))
    exp = lsm_lookup.fused_lookup_runs([t(kv) for kv, _ in runs], [t(v) for _, v in runs], t(q))
    eq(got[0].cpu(), exp[0])
    eq(got[1].cpu(), exp[1])


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
@pytest.mark.parametrize("na", PAIR_LENGTHS + [3000])
@pytest.mark.parametrize("nb", PAIR_LENGTHS + [5000])
def test_cuda_merge_path_matches_plain(cuda, na, nb):
    for compare_full in (False, True):
        runs = merge_pair(na * 7 + nb, na, nb, 30, compare_full)
        args = [t(a) for run in runs for a in run]
        got = merge_path.merge_path(*[a.to(cuda) for a in args], compare_full=compare_full)
        exp = merge_path.merge_path(*args, compare_full=compare_full)
        eq(got[0].cpu(), exp[0])
        eq(got[1].cpu(), exp[1])


@pytest.mark.cuda
@pytest.mark.parametrize("n,width", [(5, 8), (13, 4), (3000, 1024), (5000, 1024), (1 << 16, 1 << 15)])
def test_cuda_merge_round_matches_plain(cuda, n, width):
    kv, val = map(t, sort_case(n, n, 50))
    for s in range(0, n, width):  # each run sorted by the full key variable
        order = torch.sort(kv[s:s + width], stable=True).indices
        kv[s:s + width], val[s:s + width] = kv[s:s + width][order], val[s:s + width][order]
    got = merge_path.merge_round(kv.to(cuda), val.to(cuda), width, compare_full=True)
    exp = merge_path.merge_round(kv, val, width, compare_full=True)
    eq(got[0].cpu(), exp[0])
    eq(got[1].cpu(), exp[1])
