"""Seeded inputs shared by the port's kernel tests (no JAX: the card tests
import this on machines without it)."""

import numpy as np
import torch

PLACEBO_KEY = (1 << 30) - 1
MAX_USER_KEY = PLACEBO_KEY - 1
PLACEBO_KV = PLACEBO_KEY << 1
INT32_MAX = np.iinfo(np.int32).max

QUERY_EDGES = [0, 1, MAX_USER_KEY, PLACEBO_KEY, INT32_MAX, -1]

MERGE_CASES = [
    ([0], 8), ([1], 8), ([5, 0, 3], 8), ([1, 1], 4), ([255, 257], 8),
    ([17, 255, 0, 257, 1], 40), ([64, 64, 128, 256, 512], 1 << 20),
    ([3, 9, 27, 81, 243, 5, 7, 11, 13, 17, 19, 23, 29], 30),
]


def sorted_run(rng, n, key_hi, tomb_frac=0.3, placebo_tail=0):
    """A run as the LSM keeps it: ascending original key, placebos last (with
    EMPTY_VALUE), mixed status bits within equal keys."""
    keys = np.sort(rng.integers(0, key_hi, n - placebo_tail))
    kv = (keys << 1) | (rng.random(keys.size) >= tomb_frac)
    kv = np.concatenate([kv, np.full(placebo_tail, PLACEBO_KV)]).astype(np.int32)
    val = rng.integers(-1000, 1 << 20, n).astype(np.int32)
    val[n - placebo_tail:] = 0
    return kv, val


SORT_NS = [0, 1, 7, 8, 1000, 4096, 4097, 3000, 16384]
PAIR_LENGTHS = [0, 1, 255, 256, 257]  # each side of a pairwise merge on the card


def sort_case(seed, n, key_hi, placebo_frac=0.1):
    """A batch as an update sees it: random keys below key_hi with mixed
    status bits, some placebo lanes, and distinct values (so a test sees
    which of two identical key variables came first)."""
    rng = np.random.default_rng(seed)
    kv = (rng.integers(0, key_hi, n) << 1) | (rng.random(n) < 0.6)
    kv[rng.random(n) < placebo_frac] = PLACEBO_KV
    return kv.astype(np.int32), rng.permutation(n).astype(np.int32) - n // 2


def merge_pair(seed, na, nb, key_hi, full):
    """Two runs for a pairwise merge, each sorted by what the merge compares:
    the full key variable (`full`) or the original key."""
    rng = np.random.default_rng(seed)
    runs = [sorted_run(rng, n, key_hi, placebo_tail=n // 5) for n in (na, nb)]
    if full:
        runs = [(np.sort(kv), v) for kv, v in runs]
    return runs


def stable_merge_np(a_kv, a_val, b_kv, b_val, shift):
    """Oracle: a stable sort of the concatenation, `a` first, by kv >> shift."""
    kv, val = np.concatenate([a_kv, b_kv]), np.concatenate([a_val, b_val])
    order = np.argsort(kv >> shift, kind="stable")
    return kv[order], val[order]


def runs_np(seed, lengths, key_hi, placebo_frac=0.25):
    rng = np.random.default_rng(seed)
    return [sorted_run(rng, n, key_hi, placebo_tail=int(n * placebo_frac)) for n in lengths]


def t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def eq(got, exp):
    np.testing.assert_array_equal(np.asarray(got), np.asarray(exp))


# Multi-run lookup shapes, (run lengths newest first, key_hi): tie-heavy runs
# far longer than a sample stride of the lookup kernel (equal-key segments
# across sample boundaries), runs shorter than a stride and of lengths no
# multiple of one, empty runs, one run, MAX_RUNS = 32 runs.
LOOKUP_CASES = [
    ([5000, 3, 0, 4097, 1, 20000], 7),
    ([1 << 14], 3),
    ([1 << 14], 1 << 20),
    ([0, 0, 1000, 0], 50),
    ([17] * 32, 9),
    ([4095, 4097, 1234, 1, 0, 777] * 5 + [3, 9], 1000),
    ([1 << 12, 1 << 13, 1 << 14, 1 << 15], 1 << 22),
]


def lookup_case(seed, lengths, key_hi, nq):
    rng = np.random.default_rng(seed)
    runs = [sorted_run(rng, n, key_hi, placebo_tail=n // 4) for n in lengths]
    q = np.concatenate([rng.integers(0, key_hi + 3, nq - len(QUERY_EDGES)), QUERY_EDGES]).astype(np.int32)
    return runs, q
