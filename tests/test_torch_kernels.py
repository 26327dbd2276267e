"""The port's kernel functions against the JAX reference, bit for bit.

On the CPU the wrappers run their plain versions; each is held against the
port's `ref` oracles, the JAX package's `ref`/`ops` (default "xla" backend)
at ragged lengths, and the Pallas kernels in interpret mode at shapes the
Pallas kernels accept. tests/test_torch_cuda.py holds the CUDA kernels
against the plain versions on a card.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import queries as jqueries
from repro.core import semantics as jsem
from repro.kernels import lsm_lookup as jlookup
from repro.kernels import merge_path as jmerge
from repro.kernels import ops as jops
from repro.kernels import ref as jref
from repro_torch.kernels import lsm_lookup, merge_path, ops, ref
from torch_cases import INT32_MAX, MERGE_CASES, QUERY_EDGES, eq, lookup_case, runs_np, sorted_run, t


# ---------------------------------------------------------------------------
# K-way merge
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("lengths,key_hi", MERGE_CASES)
def test_merge_cascade_matches_refs(lengths, key_hi):
    runs = runs_np(len(lengths) * 7 + key_hi, lengths, key_hi)
    kvs, vals = [t(kv) for kv, _ in runs], [t(v) for _, v in runs]
    got_kv, got_val = ops.merge_cascade(list(zip(kvs, vals)))
    exp_kv, exp_val = ref.merge_cascade_ref(kvs, vals)
    eq(got_kv, exp_kv)
    eq(got_val, exp_val)
    if len(lengths) > 5:
        return  # each JAX fold step compiles anew; the shorter cases hold ref to JAX
    jkv, jval = jref.merge_cascade_ref([jnp.asarray(kv) for kv, _ in runs], [jnp.asarray(v) for _, v in runs])
    eq(got_kv, jkv)
    eq(got_val, jval)


def test_merge_cascade_writes_out():
    runs = runs_np(3, [7, 9, 4], 6)
    total = 20
    out = (torch.full((total,), -5, dtype=torch.int32), torch.full((total,), -5, dtype=torch.int32))
    res = merge_path.merge_cascade_path([t(kv) for kv, _ in runs], [t(v) for _, v in runs], out=out)
    assert res[0] is out[0] and res[1] is out[1]
    exp = ref.merge_cascade_ref([t(kv) for kv, _ in runs], [t(v) for _, v in runs])
    eq(out[0], exp[0])
    eq(out[1], exp[1])


@pytest.mark.parametrize("lengths,key_hi", [([256, 512, 256], 8), ([1024, 256], 1 << 20)])
def test_merge_cascade_matches_pallas_interpret(lengths, key_hi):
    runs = runs_np(11 + key_hi, lengths, key_hi)
    got = merge_path.merge_cascade_path([t(kv) for kv, _ in runs], [t(v) for _, v in runs])
    exp = jmerge.merge_cascade_path(
        [jnp.asarray(kv) for kv, _ in runs], [jnp.asarray(v) for _, v in runs], interpret=True
    )
    eq(got[0], exp[0])
    eq(got[1], exp[1])


def test_merge_compare_full_matches_pallas_pairwise():
    # With K = 2 and shift 0 the K-way merge computes the pairwise merge_path too.
    rng = np.random.default_rng(5)
    a = np.sort(rng.integers(0, 100, 256)).astype(np.int32)
    b = np.sort(rng.integers(0, 100, 256)).astype(np.int32)
    av, bv = np.arange(256, dtype=np.int32), np.arange(256, dtype=np.int32) + 1000
    got = merge_path.merge_cascade_path([t(a), t(b)], [t(av), t(bv)], compare_full=True)
    exp = jmerge.merge_path(jnp.asarray(a), jnp.asarray(av), jnp.asarray(b), jnp.asarray(bv),
                            compare_full=True, interpret=True)
    eq(got[0], exp[0])
    eq(got[1], exp[1])


def test_merge_rejects_mismatched_lists():
    with pytest.raises(ValueError):
        merge_path.merge_cascade_path([t(np.zeros(3, np.int32))], [])


# ---------------------------------------------------------------------------
# lower / upper bound
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("n", [0, 1, 255, 2047, 4099])
@pytest.mark.parametrize("key_hi", [6, 1 << 29])
def test_bounds_match_jax(n, key_hi):
    rng = np.random.default_rng(n + key_hi)
    kv, _ = sorted_run(rng, n, key_hi, placebo_tail=n // 5)
    q = np.concatenate([rng.integers(0, key_hi + 2, 200), QUERY_EDGES]).astype(np.int32)
    orig = kv >> 1
    lo, hi = ops.lower_bound(t(kv), t(q)), ops.upper_bound(t(kv), t(q))
    assert lo.dtype == hi.dtype == torch.int32
    eq(lo, jops.lower_bound(jnp.asarray(orig), jnp.asarray(q)))
    eq(hi, jops.upper_bound(jnp.asarray(orig), jnp.asarray(q)))
    eq(lo, ref.lower_bound_ref(t(orig), t(q)))
    eq(hi, ref.upper_bound_ref(t(orig), t(q)))


def test_bound_full_key_shift():
    kv = np.sort(np.random.default_rng(2).integers(0, 50, 300)).astype(np.int32)
    q = np.arange(-2, 53, dtype=np.int32)
    for upper in (False, True):
        got = lsm_lookup.bound(t(kv), t(q), shift=0, upper=upper)
        eq(got, np.searchsorted(kv, q, side="right" if upper else "left"))


@pytest.mark.parametrize("key_hi", [40, 1 << 29])
def test_bounds_match_pallas_interpret(key_hi):
    rng = np.random.default_rng(key_hi)
    kv, _ = sorted_run(rng, 2048, key_hi, placebo_tail=100)
    q = np.concatenate([rng.integers(0, key_hi, 256 - len(QUERY_EDGES)), QUERY_EDGES]).astype(np.int32)
    orig = jnp.asarray(kv >> 1)
    lo = jlookup.lower_bound_streamed(orig, jnp.asarray(q), interpret=True)
    eq(ops.lower_bound(t(kv), t(q)), lo)
    # ops.upper_bound's Pallas route: lower_bound(k + 1), guarded at INT32_MAX.
    safe = q < INT32_MAX
    hi = jlookup.lower_bound_streamed(orig, jnp.asarray(np.where(safe, q + 1, q)), interpret=True)
    eq(ops.upper_bound(t(kv), t(q)), np.where(safe, np.asarray(hi), 2048))


# ---------------------------------------------------------------------------
# multi-run lookup
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("lengths,key_hi", [
    ([8], 10), ([8, 8, 16, 32, 64], 12), ([8, 8, 16, 32, 64, 128, 256], 1 << 20),
    ([0, 5, 3, 0, 11], 9),
])
def test_fused_lookup_matches_refs(lengths, key_hi):
    runs, q = lookup_case(sum(lengths) + key_hi, lengths, key_hi, 300)
    got_kv, got_val = lsm_lookup.fused_lookup_runs([t(kv) for kv, _ in runs], [t(v) for _, v in runs], t(q))
    flat_kv = np.concatenate([kv for kv, _ in runs])
    flat_val = np.concatenate([v for _, v in runs])
    exp_kv, exp_val = ref.fused_lookup_ref(t(flat_kv), t(flat_val), t(q))
    eq(got_kv, exp_kv)
    eq(got_val, exp_val)
    jkv, jval = jref.fused_lookup_ref(jnp.asarray(flat_kv), jnp.asarray(flat_val), jnp.asarray(q))
    eq(got_kv, jkv)
    eq(got_val, jval)


def test_fused_lookup_matches_pallas_interpret():
    runs, q = lookup_case(7, [256, 256, 512], 300, 256)
    flat_kv = np.concatenate([kv for kv, _ in runs])
    flat_val = np.concatenate([v for _, v in runs])
    got = lsm_lookup.fused_lookup_runs([t(kv) for kv, _ in runs], [t(v) for _, v in runs], t(q))
    exp = jlookup.fused_lookup_runs(jnp.asarray(flat_kv), jnp.asarray(flat_val), jnp.asarray(q), interpret=True)
    eq(got[0], exp[0])
    eq(got[1], exp[1])


@pytest.mark.parametrize("seed", [0, 1])
def test_fused_and_loop_paths_agree(seed):
    runs, q = lookup_case(seed, [8, 8, 16, 32, 64, 128], 40, 200)
    truns = [(t(kv), t(v)) for kv, v in runs]
    found, vals = ops.lookup_runs_fused(truns, t(q))
    # The per-run resolution loop over the bound kernel.
    resolved = torch.zeros(q.size, dtype=torch.bool)
    lfound = torch.zeros(q.size, dtype=torch.bool)
    lvals = torch.zeros(q.size, dtype=torch.int32)
    for kv, v in truns:
        hit, tomb, val = ops.lookup_level(kv, v, t(q))
        newly = hit & ~resolved
        lfound |= newly & ~tomb
        lvals = torch.where(newly & ~tomb, val, lvals)
        resolved |= newly
    eq(found, lfound)
    eq(vals, lvals)
    jfound, jvals = jqueries.lookup_runs([(jnp.asarray(kv), jnp.asarray(v)) for kv, v in runs], jnp.asarray(q))
    eq(found, jfound)
    eq(vals, jvals)


def test_lookup_level_matches_ref():
    runs, q = lookup_case(3, [64], 20, 100)
    kv, v = t(runs[0][0]), t(runs[0][1])
    for got, exp in zip(ops.lookup_level(kv, v, t(q)), ref.lookup_level_ref(kv, v, t(q))):
        eq(got, exp)


# ---------------------------------------------------------------------------
# recency sort (a PyTorch sort: no Pallas kernel)
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("n,key_hi", [(1, 4), (16, 4), (64, 30), (100, 1 << 29)])
def test_sort_pairs_recency_matches_jax(n, key_hi):
    rng = np.random.default_rng(n)
    kv = ((rng.integers(0, key_hi, n) << 1) | (rng.random(n) < 0.5)).astype(np.int32)
    kv[rng.random(n) < 0.2] = jsem.PLACEBO_KV
    val = rng.integers(-50, 50, n).astype(np.int32)
    got = ops.sort_pairs_recency(t(kv), t(val))
    exp = jops.sort_pairs_recency(jnp.asarray(kv), jnp.asarray(val))
    eq(got[0], exp[0])
    eq(got[1], exp[1])
