"""Count/range stage 1 in one launch, and the pairwise Merge Path's split,
against the JAX reference on the CPU. Every comparison is exact.

The CUDA bound kernel (csrc/bounds.cu) computes, in one launch, the lower
bound of k1 and the upper bound of k2 in every run; its plain version
`lsm_lookup.bounds_runs_plain` is held here against `repro.kernels.ops`'
per-run `lower_bound` / `upper_bound` (the XLA reference and, on shapes that
pass its gates, the interpret-mode Pallas `lower_bound_streamed`). The CUDA
Merge Path (csrc/merge_path.cu) first splits every output tile boundary;
`merge_path.merge_split_plain` is held against the JAX `merge_partition` and
against the split a JAX reference merge implies. tests/test_torch_cuda.py
holds both kernels against these plain versions on a card.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import queries as jq
from repro.kernels import lsm_lookup as jlookup
from repro.kernels import merge_path as jmerge
from repro.kernels import ops as jops
from repro.kernels import ref as jref
from repro_torch.core import queries as tq
from repro_torch.kernels import lsm_lookup, merge_path, ops
from torch_cases import MAX_USER_KEY, PLACEBO_KEY, QUERY_EDGES, eq, sorted_run, t

# Runs as count/range sees them, newest first: an empty write buffer, levels
# with placebo tails (every fourth all placebos) and few distinct keys, so
# equal-key segments are long.
RUN_KINDS = {
    "lsm": ([0] + [8 << i for i in range(8)], 60),
    "short": ([1, 0, 3, 2, 0, 17, 5], 6),
    "random": ([40, 300, 0, 1000], 1 << 20),
}


def runs_case(kind, seed):
    lengths, key_hi = RUN_KINDS[kind]
    rng = np.random.default_rng(seed)
    return [sorted_run(rng, n, key_hi, placebo_tail=n if s % 4 == 3 else n // 4) for s, n in enumerate(lengths)]


def windows(rng, key_hi, nq):
    """k1 below, inside and above the keys, the edge keys, and k2 from
    k1 - 3 to k1 + 40 (k1 > k2 included)."""
    k1 = np.concatenate([rng.integers(-2, key_hi + 3, nq - len(QUERY_EDGES)), QUERY_EDGES])
    k2 = np.clip(k1 + rng.integers(-3, 41, nq), -(1 << 31), (1 << 31) - 1)
    return k1.astype(np.int32), k2.astype(np.int32)


@pytest.mark.parametrize("kind", sorted(RUN_KINDS))
def test_bounds_runs_plain_matches_jax_bounds(kind):
    runs = runs_case(kind, len(kind))
    k1, k2 = windows(np.random.default_rng(7), RUN_KINDS[kind][1], 300)
    lows, highs = lsm_lookup.bounds_runs([t(kv) for kv, _ in runs], t(k1), t(k2))
    assert lows.dtype == highs.dtype == torch.int32 and lows.shape == highs.shape == (len(runs), k1.size)
    for s, (kv, _) in enumerate(runs):
        orig = jnp.asarray(kv >> 1)
        eq(lows[s], jops.lower_bound(orig, jnp.asarray(k1)))
        eq(highs[s], jops.upper_bound(orig, jnp.asarray(k2)))


def test_bounds_runs_plain_matches_pallas_streamed(monkeypatch):
    """On shapes that pass the Pallas kernel's gates (runs of whole 2048-key
    chunks, queries in blocks of 256), the reference's bounds run the
    interpret-mode `lower_bound_streamed`: directly for the lower bound, as
    lower_bound(k2 + 1) with the INT32_MAX guard for the upper one."""
    monkeypatch.setattr(jops, "_BACKEND", "pallas")
    rng = np.random.default_rng(3)
    runs = [sorted_run(rng, 2048, 50, placebo_tail=700), sorted_run(rng, 4096, 1 << 16, placebo_tail=4096)]
    k1, k2 = windows(rng, 50, 256)
    lows, highs = lsm_lookup.bounds_runs([t(kv) for kv, _ in runs], t(k1), t(k2))
    for s, (kv, _) in enumerate(runs):
        orig = jnp.asarray(kv >> 1)
        eq(lows[s], jlookup.lower_bound_streamed(orig, jnp.asarray(k1), interpret=True))
        eq(highs[s], jops.upper_bound(orig, jnp.asarray(k2)))


def per_run_bounds(runs, k1, k2):
    """Stage 1 as the port ran it before one launch did all runs: a lower
    and an upper bound launch per run."""
    return (torch.stack([ops.lower_bound(kv, k1) for kv, _ in runs]),
            torch.stack([ops.upper_bound(kv, k2) for kv, _ in runs]))


@pytest.mark.parametrize("kind", ["lsm", "short"])
def test_count_range_equal_before_and_after_one_launch_stage1(kind, monkeypatch):
    """count_runs / range_runs on LSM-shaped runs with placebo tails give the
    same results with stage 1 in one call and as per-run calls, and equal the
    JAX reference's."""
    runs = runs_case(kind, 11)
    k1, k2 = windows(np.random.default_rng(5), RUN_KINDS[kind][1], 64)
    k1[:2] = [PLACEBO_KEY, 0]
    k2[:2] = [PLACEBO_KEY, MAX_USER_KEY]
    truns = [(t(kv), t(v)) for kv, v in runs]
    jruns = [(jnp.asarray(kv), jnp.asarray(v)) for kv, v in runs]
    m, r = 48, 16
    after = (tq.count_runs(truns, t(k1), t(k2), m), tq.range_runs(truns, t(k1), t(k2), m, r))
    monkeypatch.setattr(ops, "window_bounds", per_run_bounds)
    before = (tq.count_runs(truns, t(k1), t(k2), m), tq.range_runs(truns, t(k1), t(k2), m, r))
    expected = (jq.count_runs(jruns, jnp.asarray(k1), jnp.asarray(k2), m),
                jq.range_runs(jruns, jnp.asarray(k1), jnp.asarray(k2), m, r))
    for got, old, exp in zip(after, before, expected):
        for g, o, e in zip(got, old, exp):
            eq(g, o)
            eq(g, e)


# Merge Path split cases: (na, nb, key_hi); the SA shape is a tiny `a` into
# a long `b` with a placebo tail, key_hi 1 puts one key in every element.
SPLIT_CASES = [(0, 700, 50), (1, 700, 50), (700, 1, 50), (1, 1, 1), (300, 400, 1), (3000, 2000, 40),
               (6, 9000, 1 << 20), (0, 0, 1)]


def split_runs(na, nb, key_hi, shift, seed):
    rng = np.random.default_rng(seed)
    a = sorted_run(rng, na, key_hi, placebo_tail=na // 5)[0]
    b = sorted_run(rng, nb, key_hi, placebo_tail=nb // 2)[0]
    if shift == 0:
        a, b = np.sort(a), np.sort(b)
    return a, b


def split_diags(n):
    """Every diagonal: among them every tile boundary, whatever the kernel's
    tile size."""
    return np.arange(n + 1)


@pytest.mark.parametrize("shift", [0, 1])
@pytest.mark.parametrize("na,nb,key_hi", SPLIT_CASES)
def test_merge_split_plain_matches_jax_partition(na, nb, key_hi, shift):
    a, b = split_runs(na, nb, key_hi, shift, na * 31 + nb + shift)
    diags = split_diags(na + nb)
    got = merge_path.merge_split_plain(t(a) >> shift, t(b) >> shift, t(diags))
    assert got.dtype == torch.int64 and got.shape == diags.shape
    # The split the JAX reference merge implies: the a-elements among the
    # first d outputs of `ref.merge_ref` (values tag a as 1, b as 0). It
    # compares kv >> 1, so it gets the compared keys' dense ranks, doubled.
    _, rank = np.unique(np.concatenate([a >> shift, b >> shift]), return_inverse=True)
    kv = jnp.asarray((rank << 1).astype(np.int32))
    _, tags = jref.merge_ref(kv[:na], jnp.ones(na, jnp.int32), kv[na:], jnp.zeros(nb, jnp.int32))
    eq(got, np.concatenate([[0], np.cumsum(np.asarray(tags))])[diags])
    if na and nb:  # merge_partition indexes both runs
        eq(got, jmerge.merge_partition(jnp.asarray(a >> shift), jnp.asarray(b >> shift), jnp.asarray(diags)))


def test_merge_split_launcher_plain_on_cpu():
    """`merge_split` on CPU tensors is the plain split of the compared keys."""
    a, b = split_runs(300, 500, 20, 1, 0)
    diags = t(split_diags(800).astype(np.int64))
    eq(merge_path.merge_split(t(a), t(b), diags), merge_path.merge_split_plain(t(a) >> 1, t(b) >> 1, diags))
    eq(merge_path.merge_split(t(np.sort(a)), t(np.sort(b)), diags, compare_full=True),
       merge_path.merge_split_plain(t(np.sort(a)), t(np.sort(b)), diags))
