"""The multi-run LOOKUP of the port against the JAX reference, and the parts
of the lookup kernel's design that are computed in Python.

On the CPU, `lsm_lookup.fused_lookup_runs` and `ops.lookup_runs_fused` run
the plain version; each is held against `repro.kernels.ref.fused_lookup_ref`
and the interpret-mode Pallas `repro.kernels.lsm_lookup.fused_lookup_runs` on
the same seeded inputs. `sample_layout` (where the kernel keeps each run's
samples in shared memory) and `lookup_grid` (its persistent grid) are checked
for the properties the kernel relies on, and the design sweep's states
(`lookup_sweep.make_state`) for being valid lookup inputs. tests/test_torch_cuda.py holds the
kernel against the plain version on a card, on the same shapes.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import queries as jqueries
from repro.kernels import lsm_lookup as jlookup
from repro.kernels import ref as jref
from repro_torch.kernels import lookup_sweep, lsm_lookup, ops
from torch_cases import LOOKUP_CASES, PLACEBO_KV, eq, lookup_case, t

FUSED_CHUNK, FUSED_QUERY_BLOCK = 1024, 256  # the Pallas kernel's gates


def case_inputs(case, nq=300):
    lengths, key_hi = LOOKUP_CASES[case]
    return lookup_case(100 + case, lengths, key_hi, nq)


@pytest.mark.parametrize("case", range(len(LOOKUP_CASES)))
def test_lookup_plain_matches_jax_ref(case):
    runs, q = case_inputs(case)
    kvs, vals = [t(kv) for kv, _ in runs], [t(v) for _, v in runs]
    got = lsm_lookup.fused_lookup_plain(kvs, vals, t(q))
    for g, w in zip(lsm_lookup.fused_lookup_runs(kvs, vals, t(q)), got):  # the wrapper, on CPU tensors
        eq(g, w)
    flat_kv = np.concatenate([kv for kv, _ in runs])
    flat_val = np.concatenate([v for _, v in runs])
    exp = jref.fused_lookup_ref(jnp.asarray(flat_kv), jnp.asarray(flat_val), jnp.asarray(q))
    eq(got[0], exp[0])
    eq(got[1], exp[1])
    tomb_hits = ((np.asarray(got[0]) >> 1) == q) & ((np.asarray(got[0]) & 1) == 0)
    assert tomb_hits.any() or LOOKUP_CASES[case][1] > 1000  # wide key ranges hit few tombstones


@pytest.mark.parametrize("case", [0, 1, 3, 4])
def test_lookup_matches_pallas_interpret(case):
    runs, q = case_inputs(case, nq=256)
    flat_kv = np.concatenate([kv for kv, _ in runs])
    flat_val = np.concatenate([v for _, v in runs])
    pad = -flat_kv.size % FUSED_CHUNK  # placebos last: they match only the placebo key, as no match does
    pkv = np.concatenate([flat_kv, np.full(pad, PLACEBO_KV, np.int32)])
    pval = np.concatenate([flat_val, np.zeros(pad, np.int32)])
    assert q.size % FUSED_QUERY_BLOCK == 0
    exp = jlookup.fused_lookup_runs(jnp.asarray(pkv), jnp.asarray(pval), jnp.asarray(q), interpret=True)
    got = lsm_lookup.fused_lookup_runs([t(kv) for kv, _ in runs], [t(v) for _, v in runs], t(q))
    eq(got[0], exp[0])
    eq(got[1], exp[1])


@pytest.mark.parametrize("case", range(len(LOOKUP_CASES)))
def test_lookup_runs_fused_matches_jax_queries(case):
    runs, q = case_inputs(case)
    found, vals = ops.lookup_runs_fused([(t(kv), t(v)) for kv, v in runs], t(q))
    jruns = [(jnp.asarray(kv), jnp.asarray(v)) for kv, v in runs if kv.size]  # JAX's gather refuses an empty run
    jfound, jvals = jqueries.lookup_runs(jruns, jnp.asarray(q))
    eq(found, jfound)
    eq(vals, jvals)


# ---------------------------------------------------------------------------
# the sample layout and the grid
# ---------------------------------------------------------------------------

LAYOUT_LENGTHS = [case[0] for case in LOOKUP_CASES] + [
    [1 << 16] + [(1 << 16) << i for i in range(12)],  # the LSM of the main path, 2^28 slots
    [1 << 27],                                       # the sorted array of the main path
    [0], [1], [2], [511], [512], [513],
]


@pytest.mark.parametrize("budget", [64, 1000, lsm_lookup.SAMPLE_INTS, 1 << 15])
@pytest.mark.parametrize("lengths", LAYOUT_LENGTHS)
def test_sample_layout_fits_and_strides(lengths, budget):
    if budget // len(lengths) < 2:
        with pytest.raises(ValueError):
            lsm_lookup.sample_layout(lengths, budget)
        return
    lg, count, off, total = lsm_lookup.sample_layout(lengths, budget)
    per_run = 1 << ((budget // len(lengths)).bit_length() - 1)
    assert total <= budget and total == sum(count)
    assert off == list(np.cumsum([0] + count[:-1]))  # one run after the other from slot 0
    for n, shift, c in zip(lengths, lg, count):
        if n == 0:
            assert c == 0 and shift == 0
            continue
        # Keys at j << shift for j < ceil(n / 2^shift), then the last key.
        assert c == -(-n >> shift) + 1 <= per_run
        assert shift == 0 or -(-n >> (shift - 1)) + 1 > per_run  # the least stride that fits
        if n + 1 <= per_run:
            assert shift == 0  # a short run sits in shared memory whole


@pytest.mark.parametrize("case", range(len(LOOKUP_CASES)))
def test_sample_windows_bracket_the_lower_bound(case):
    """The search in the samples, a lower bound on the original key, leaves a
    window (position of slot J - 1, position of slot J] that holds the run's
    lower bound: the first element of an equal-key segment, however many
    sample boundaries the segment crosses. A query above the last key has no
    window (the lower bound is n)."""
    runs, q = case_inputs(case, nq=2000)
    lengths = [kv.size for kv, _ in runs]
    for budget in (64, lsm_lookup.SAMPLE_INTS):
        if budget // len(lengths) < 2:
            continue
        lg, count, _, _ = lsm_lookup.sample_layout(lengths, budget)
        for (kv, _), shift, c in zip(runs, lg, count):
            n = kv.size
            if n == 0:
                continue
            pos = np.minimum(np.arange(c) << shift, n - 1)
            pos[-1] = n - 1
            keys = kv >> 1
            lower = np.searchsorted(keys, q, side="left")
            j = np.searchsorted(keys[pos], q, side="left")
            above = j == c
            assert np.array_equal(above, lower == n)
            jj = j[~above]
            lo = np.where(jj > 0, pos[np.maximum(jj - 1, 0)] + 1, 0)
            assert np.all(lo <= lower[~above]) and np.all(lower[~above] <= pos[jj])
            assert np.all(pos[jj] - lo < 1 << shift)  # at most one stride to search in the run


@pytest.mark.parametrize("nq,threads,sms,expected", [
    (1 << 20, 512, 132, 264),    # two blocks an SM
    (1 << 20, 1024, 132, 264),
    (1 << 17, 512, 132, 256),    # the queries fill fewer
    (1000, 512, 132, 2),
    (5000, 1024, 132, 5),
    (0, 512, 132, 1),
])
def test_lookup_grid(nq, threads, sms, expected):
    assert lsm_lookup.lookup_grid(nq, threads, sms) == expected


@pytest.mark.parametrize("kind", lookup_sweep.STATES)
def test_sweep_states_are_lookup_inputs(kind):
    """The design sweep's states, at a small size: every run ascending in
    original key with a value per slot, the queries half drawn from keys
    present; after cleanup ("post") the levels hold disjoint slices of one
    key range, lower levels the lower keys."""
    gen = torch.Generator()
    gen.manual_seed(0)
    kvs, vals, pool = lookup_sweep.make_state(kind, torch.device("cpu"), gen, log2_b=3, levels=7, log2_sa=10)
    assert [v.shape for v in vals] == [kv.shape for kv in kvs]
    for kv in kvs:
        assert torch.all(kv[1:] >> 1 >= kv[:-1] >> 1)
    q = lookup_sweep.make_queries(pool, 256, gen)
    assert q.shape == (256,) and q.dtype == torch.int32
    found = (lsm_lookup.fused_lookup_plain(kvs, vals, q)[0] >> 1) == q
    assert int(found.sum()) >= (100 if kind == "tie" else 128)
    if kind == "post":
        live = torch.cat([kv[kv != PLACEBO_KV] >> 1 for kv in kvs])
        assert live.numel() == pool.numel() and torch.all(live[1:] > live[:-1])
