"""The K-way Merge Path's split and grouped merge, and the K-way-round batch
sort, against the JAX reference on the CPU.

The CUDA kernel (csrc/merge_cascade.cu) splits every output tile with the
K-way split that `repro.kernels.merge_path.cascade_partition` computes; its
plain version `cascade_split_plain` is held against it here on the same
numpy-seeded runs and diagonals, and tests/test_torch_cuda.py holds the
kernel's split launcher against the plain version on a card. The grouped
merge's plain version is held against a fold of `ref.merge_ref` (the
port's, which tests/test_torch_kernels.py holds against the JAX one), and the
batch sort's steps (tile sorts, then K-way rounds) against `ref.sort_ref`.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import merge_path as jmerge
from repro.kernels import ref as jref
from repro_torch.kernels import bitonic_sort, merge_path, ref
from torch_cases import PLACEBO_KV, eq, sort_case, sorted_run, stable_merge_np, t

SPLIT_KINDS = ["random", "short", "equal", "placebo"]
DIAG_SLOTS = 1536  # every diagonal 0..total, padded: one JAX query shape for all cases


def split_case(seed, k, kind, shift):
    """K runs of one kind, each sorted by what the merge compares:
    random keys; empty and length-1 runs among longer ones; one key in every
    run; or LSM levels (placebo tails, some runs all placebos)."""
    rng = np.random.default_rng(seed)
    if kind == "random":
        runs = [sorted_run(rng, int(n), 60) for n in rng.choice([0, 16, 40], k)]
    elif kind == "short":
        runs = [sorted_run(rng, int(n), 20) for n in rng.choice([0, 1, 0, 1, 16], k)]
    elif kind == "equal":
        runs = [sorted_run(rng, int(n), 1) for n in rng.choice([1, 16, 40], k)]
    else:
        lengths = [8 << min(s, 2) for s in range(k)]
        runs = [sorted_run(rng, n, 50, placebo_tail=n if s % 3 == 2 else n // 4) for s, n in enumerate(lengths)]
    if shift == 0:
        runs = [(np.sort(kv), v) for kv, v in runs]
    return runs


# Every kind in both compare modes at K = 1 and 2; at K = 13 and 32 (where
# the eager JAX reference runs 31 searches per run) each kind once, the
# modes alternating.
SPLIT_CASES = ([(k, kind, shift) for k in (1, 2) for kind in SPLIT_KINDS for shift in (0, 1)]
               + [(k, kind, (i + k) % 2) for k in (13, 32) for i, kind in enumerate(SPLIT_KINDS)])


@pytest.mark.parametrize("k,kind,shift", SPLIT_CASES)
def test_cascade_split_matches_jax_partition(k, kind, shift):
    runs = split_case(k * 7 + len(kind) + shift, k, kind, shift)
    total = sum(kv.shape[0] for kv, _ in runs)
    diags = np.minimum(np.arange(DIAG_SLOTS, dtype=np.int32), total)
    got = merge_path.cascade_split([t(kv) for kv, _ in runs], t(diags.astype(np.int64)), compare_full=shift == 0)
    assert got.dtype == torch.int64 and got.shape == (k, DIAG_SLOTS)
    exp = jmerge.cascade_partition([jnp.asarray(kv >> shift) for kv, _ in runs], jnp.asarray(diags))
    eq(got, np.asarray(exp))


def test_cascade_split_placebo_segment_spans_runs():
    # Every run ends in one long equal-key segment (placebos): a diagonal
    # inside it takes the segment's elements in run order.
    runs = [np.array([2, 4, PLACEBO_KV, PLACEBO_KV], np.int32), np.full(3, PLACEBO_KV, np.int32),
            np.array([4, PLACEBO_KV], np.int32)]
    got = merge_path.cascade_split_plain([t(kv) for kv in runs], torch.tensor([0, 3, 4, 5, 6, 8, 9]))
    eq(got, [[0, 2, 3, 4, 4, 4, 4], [0, 0, 0, 0, 1, 3, 3], [0, 1, 1, 1, 1, 1, 2]])


def group_case(seed, n, width, shift):
    rng = np.random.default_rng(seed)
    kv = (rng.integers(0, 25, n) << 1 | (rng.random(n) < 0.5)).astype(np.int32)
    for s in range(0, n, width):  # runs of `width`, each sorted by kv >> shift
        kv[s:s + width] = kv[s:s + width][np.argsort(kv[s:s + width] >> shift, kind="stable")]
    return kv, rng.permutation(n).astype(np.int32)


@pytest.mark.parametrize("n,width,k", [(0, 4, 3), (5, 8, 2), (37, 4, 3), (100, 8, 32), (257, 8, 32),
                                       (1000, 16, 13), (64, 1, 32), (40, 5, 1)])
def test_merge_groups_plain_matches_merge_ref_fold(n, width, k):
    kv, val = group_case(n + width + k, n, width, 1)
    got = merge_path.merge_groups(t(kv), t(val), width, k)
    for g in range(0, n, k * width):  # the last group may be short or have fewer runs
        spans = [(s, min(s + width, n)) for s in range(g, min(g + k * width, n), width)]
        e = spans[-1][1]
        exp = ref.merge_cascade_ref([t(kv[a:b]) for a, b in spans], [t(val[a:b]) for a, b in spans])
        eq(got[0][g:e], exp[0])
        eq(got[1][g:e], exp[1])


@pytest.mark.parametrize("n,width,k", [(37, 4, 3), (257, 8, 32), (1000, 16, 13)])
def test_merge_groups_plain_compare_full_matches_fold(n, width, k):
    kv, val = group_case(n * 3 + k, n, width, 0)
    got = merge_path.merge_groups(t(kv), t(val), width, k, compare_full=True)
    for g in range(0, n, k * width):
        acc_kv, acc_val = kv[g:g], val[g:g]
        for s in range(g, min(g + k * width, n), width):
            acc_kv, acc_val = stable_merge_np(acc_kv, acc_val, kv[s:s + width], val[s:s + width], 0)
        eq(got[0][g:g + acc_kv.size], acc_kv)
        eq(got[1][g:g + acc_kv.size], acc_val)


@pytest.mark.parametrize("n", [4095, 4096, 4097, 3 * 4096 + 1000])
def test_block_sort_plain_matches_sort_ref_per_tile(n):
    kv, val = sort_case(n + 1, n, 40)
    got = bitonic_sort.block_sort_plain(t(kv), t(val))
    for s in range(0, n, bitonic_sort.TILE):
        exp = jref.sort_ref(jnp.asarray(kv[s:s + bitonic_sort.TILE]), jnp.asarray(val[s:s + bitonic_sort.TILE]))
        eq(got[0][s:s + bitonic_sort.TILE], np.asarray(exp[0]))
        eq(got[1][s:s + bitonic_sort.TILE], np.asarray(exp[1]))


@pytest.mark.parametrize("n,rounds", [(0, []), (4096, []), (4097, [(4096, 2)]), (1 << 16, [(4096, 16)]),
                                      (1 << 26, [(4096, 32), (1 << 17, 32), (1 << 22, 16)]),
                                      (4096 * 33 + 5, [(4096, 32), (1 << 17, 2)])])
def test_merge_rounds_are_k_way(n, rounds):
    # 1 + ceil(log32(n / TILE)) launches per sort.
    assert bitonic_sort.merge_rounds(n) == rounds


@pytest.mark.parametrize("n", [4096 * 3 + 7, 4096 * 33 + 5])
def test_sort_by_k_way_rounds_matches_sort_ref(n):
    kv, val = sort_case(n, n, 300)
    got = bitonic_sort.sort_by_tiles(t(kv), t(val))
    exp = jref.sort_ref(jnp.asarray(kv), jnp.asarray(val))
    eq(got[0], np.asarray(exp[0]))
    eq(got[1], np.asarray(exp[1]))
