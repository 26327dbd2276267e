"""The CUDA kernels against their plain versions, on a card (exact).

They skip without a CUDA device. On a machine with one, run them without
the suite's conftest (it imports JAX, which this file does not need):

    PYTHONPATH=src python -m pytest -q --noconftest -m cuda tests/test_torch_cuda.py
"""

import numpy as np
import pytest
import torch

from repro_torch.kernels import lsm_lookup, merge_path
from torch_cases import MERGE_CASES, QUERY_EDGES, eq, lookup_case, runs_np, sorted_run, t


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


@pytest.mark.cuda
def test_cuda_fused_lookup_matches_plain(cuda):
    runs, q = lookup_case(9, [8, 0, 16, 32, 64, 128, 256], 200, 1000)
    got = lsm_lookup.fused_lookup_runs(
        [t(kv).to(cuda) for kv, _ in runs], [t(v).to(cuda) for _, v in runs], t(q).to(cuda))
    exp = lsm_lookup.fused_lookup_runs([t(kv) for kv, _ in runs], [t(v) for _, v in runs], t(q))
    eq(got[0].cpu(), exp[0])
    eq(got[1].cpu(), exp[1])
