"""The port's batch sort and pairwise merge against the JAX reference, bit for bit.

On the CPU `ops.sort_pairs` and `ops.merge_sorted` run their plain versions
(a stable `torch.sort`; `ref.merge_ref`'s rank formula with a shift). They are
held against the JAX package's `ref.sort_ref` / `ref.merge_ref` at ragged
lengths, and against the Pallas kernels in interpret mode at the shapes those
accept. The steps the card runs (tile sort, then merge rounds) are composed
here from their plain versions and held against the same oracles;
tests/test_torch_cuda.py holds the CUDA kernels against the plain versions.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import bitonic_sort as jbitonic
from repro.kernels import merge_path as jmerge
from repro.kernels import ref as jref
from repro_torch.kernels import bitonic_sort, merge_path, ops, ref
from torch_cases import eq, merge_pair, sort_case, stable_merge_np, t


def assert_pairs(got, exp):
    for g, e in zip(got, exp):
        assert g.dtype == torch.int32
        eq(g, e)


# ---------------------------------------------------------------------------
# sort
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("n", [1, 7, 8, 64, 1000, 4096, 8192, 16384, 9000])
@pytest.mark.parametrize("key_hi", [4, 1 << 16, 1 << 30])
def test_sort_matches_sort_ref(n, key_hi):
    kv, val = sort_case(n + key_hi, n, key_hi)
    exp = jref.sort_ref(jnp.asarray(kv), jnp.asarray(val))
    assert_pairs(ops.sort_pairs(t(kv), t(val)), exp)
    assert_pairs(ref.sort_ref(t(kv), t(val)), exp)
    # The card's steps: 4096-element tile sorts, then K-way merge rounds.
    assert_pairs(bitonic_sort.sort_by_tiles(t(kv), t(val)), exp)


def test_sort_keeps_the_earlier_duplicate_first():
    # Identical inserts: the earlier lane comes first (and wins a lookup);
    # a tombstone comes before every insert of its key.
    kv = np.array([7, 7, 6, 7, 3], np.int32)
    val = np.array([1, 2, 0, 3, 4], np.int32)
    got_kv, got_val = ops.sort_pairs(t(kv), t(val))
    eq(got_kv, [3, 6, 7, 7, 7])
    eq(got_val, [4, 0, 1, 2, 3])


@pytest.mark.parametrize("n", [8, 1024, 2048])
def test_sort_matches_pallas_interpret(n):
    # The Pallas network is not stable among identical key variables: the
    # key variables are equal, the (kv, value) pairs equal as multisets.
    kv, val = sort_case(n, n, 5)
    got_kv, got_val = ops.sort_pairs(t(kv), t(val))
    exp_kv, exp_val = jbitonic.bitonic_sort_pairs(jnp.asarray(kv), jnp.asarray(val), interpret=True)
    eq(got_kv, exp_kv)
    got_pairs = sorted(zip(got_kv.tolist(), got_val.tolist()))
    exp_pairs = sorted(zip(np.asarray(exp_kv).tolist(), np.asarray(exp_val).tolist()))
    assert got_pairs == exp_pairs


@pytest.mark.parametrize("n", [0, 1, 4000, 4096, 10000])
def test_block_sort_sorts_each_tile(n):
    kv, val = sort_case(n, n, 9)
    got_kv, got_val = bitonic_sort.block_sort(t(kv), t(val))
    for s in range(0, n, bitonic_sort.TILE):
        order = np.argsort(kv[s:s + bitonic_sort.TILE], kind="stable")
        eq(got_kv[s:s + bitonic_sort.TILE], kv[s:][order])
        eq(got_val[s:s + bitonic_sort.TILE], val[s:][order])


# ---------------------------------------------------------------------------
# pairwise merge
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("na,nb", [(256, 256), (256, 512), (2048, 256)])
@pytest.mark.parametrize("compare_full", [False, True])
def test_merge_matches_pallas_interpret(na, nb, compare_full):
    (a, av), (b, bv) = merge_pair(na + nb, na, nb, 3, compare_full)  # long runs of equal keys
    got = merge_path.merge_path(t(a), t(av), t(b), t(bv), compare_full=compare_full)
    exp = jmerge.merge_path(jnp.asarray(a), jnp.asarray(av), jnp.asarray(b), jnp.asarray(bv),
                            compare_full=compare_full, interpret=True)
    assert_pairs(got, exp)


@pytest.mark.parametrize("compare_full", [False, True])
def test_merge_all_equal_keys_matches_pallas_interpret(compare_full):
    # Every key equal: the whole of `a` (the newer run) comes first.
    a, b = np.full(256, 41, np.int32), np.full(256, 41, np.int32)
    av, bv = np.arange(256, dtype=np.int32), np.arange(256, dtype=np.int32) + 1000
    got = merge_path.merge_path(t(a), t(av), t(b), t(bv), compare_full=compare_full)
    exp = jmerge.merge_path(jnp.asarray(a), jnp.asarray(av), jnp.asarray(b), jnp.asarray(bv),
                            compare_full=compare_full, interpret=True)
    assert_pairs(got, exp)
    eq(got[1], np.concatenate([av, bv]))


@pytest.mark.parametrize("na,nb", [(0, 0), (0, 257), (1, 1), (1, 255), (255, 1), (257, 0),
                                   (255, 257), (257, 255), (256, 257)])
def test_merge_ragged_matches_merge_ref(na, nb):
    # Lengths the Pallas kernel's 256-multiple gate refuses.
    (a, av), (b, bv) = merge_pair(3 * na + nb, na, nb, 40, False)
    got = ops.merge_sorted(t(a), t(av), t(b), t(bv))
    assert_pairs(got, jref.merge_ref(jnp.asarray(a), jnp.asarray(av), jnp.asarray(b), jnp.asarray(bv)))
    assert_pairs(got, ref.merge_ref(t(a), t(av), t(b), t(bv)))
    (a, av), (b, bv) = merge_pair(na + 5 * nb, na, nb, 40, True)
    got = merge_path.merge_path(t(a), t(av), t(b), t(bv), compare_full=True)
    assert_pairs(got, stable_merge_np(a, av, b, bv, 0))


def test_merge_writes_out():
    (a, av), (b, bv) = merge_pair(2, 9, 4, 6, False)
    out = (torch.full((13,), -5, dtype=torch.int32), torch.full((13,), -5, dtype=torch.int32))
    res = merge_path.merge_path(t(a), t(av), t(b), t(bv), out=out)
    assert res[0] is out[0] and res[1] is out[1]
    assert_pairs(out, stable_merge_np(a, av, b, bv, 1))
    with pytest.raises(ValueError):
        merge_path.merge_path(t(a), t(av), t(b), t(bv), out=(out[0][:5], out[1][:5]))


@pytest.mark.parametrize("n,width,k", [(0, 4, 2), (5, 8, 2), (8, 4, 2), (13, 4, 3), (3000, 1024, 2), (4096, 1024, 4)])
@pytest.mark.parametrize("compare_full", [False, True])
def test_merge_groups_merges_adjacent_groups(n, width, k, compare_full):
    rng = np.random.default_rng(n + width)
    kv = (rng.integers(0, 20, n) << 1 | (rng.random(n) < 0.5)).astype(np.int32)
    shift = 0 if compare_full else 1
    for s in range(0, n, width):  # runs of `width`, each sorted by kv >> shift
        kv[s:s + width] = kv[s:s + width][np.argsort(kv[s:s + width] >> shift, kind="stable")]
    val = np.arange(n, dtype=np.int32)
    got = merge_path.merge_groups(t(kv), t(val), width, k, compare_full=compare_full)
    for g in range(0, n, k * width):  # a stable sort of the group, earlier runs first
        e = min(g + k * width, n)
        order = np.argsort(kv[g:e] >> shift, kind="stable")
        eq(got[0][g:e], kv[g:e][order])
        eq(got[1][g:e], val[g:e][order])
