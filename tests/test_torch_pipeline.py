"""The port's data pipeline against repro.data.pipeline, on the CPU: the
same (seed, shard, step) batches, the document hash (tokens that wrap uint32
included), and dedup steps with their tokens, labels, duplicate counts and
LSM index state, equal in value and dtype."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.data import pipeline as jp
from repro_torch import convert
from repro_torch.data import pipeline as tp

SMALL = dict(vocab_size=128, seq_len=16, batch_per_shard=8, dedup_levels=6)


def configs(**kw):
    opts = dict(SMALL, **kw)
    return jp.PipelineConfig(**opts), tp.PipelineConfig(**opts, device="cpu")


def same(a, b, what):
    a = np.asarray(a)
    b = b.numpy() if isinstance(b, torch.Tensor) else np.asarray(b)
    assert a.dtype == b.dtype, f"{what}: {a.dtype} != {b.dtype}"
    np.testing.assert_array_equal(a, b, err_msg=what)


def same_index(jstate, tstate):
    exp = jax.device_get(jstate)._asdict()
    got = convert.lsm_state_to_numpy(tstate)
    for name, e in exp.items():
        if name in ("key_vars", "values"):
            for i, (x, y) in enumerate(zip(e, got[name])):
                same(x, y, f"{name}[{i}]")
        else:
            same(e, got[name], name)


@pytest.mark.parametrize("shard,step,seed", [(0, 0, 0), (1, 3, 0), (0, 3, 7)])
def test_make_batch_matches_reference(shard, step, seed):
    jc, tc = configs(seed=seed)
    jb, tb = jp.make_batch(jc, shard, step), tp.make_batch(tc, shard, step)
    for name in ("tokens", "labels"):
        same(jb[name], tb[name], name)
    assert tb["tokens"].shape == (8, 16)


@pytest.mark.parametrize("low,high,seq_len", [
    (0, 128, 16),                    # token ids of a real batch
    (-(1 << 31), 1 << 31, 37),       # every int32: negatives wrap uint32
    ((1 << 31) - 8, 1 << 31, 300),   # near INT32_MAX, longer rows
    (0, 1, 1),
])
def test_doc_hash_matches_reference(low, high, seq_len):
    tokens = np.random.default_rng(seq_len).integers(low, high, (9, seq_len)).astype(np.int32)
    same(jp._doc_hash(jnp.asarray(tokens)), tp._doc_hash(torch.from_numpy(tokens)), "hash")


def test_dedup_steps_match_reference():
    """Three fresh steps, then step 0's batch replayed twice: every document
    of the replay is a duplicate, and the retry samples replace them."""
    jc, tc = configs()
    js, ts = jp.pipeline_init(jc), tp.pipeline_init(tc)
    same_index(js.dedup_index, ts.dedup_index)
    dups = []
    for step in (0, 1, 2, 0, 0):
        jb, tb = jp.make_batch(jc, 0, step), tp.make_batch(tc, 0, step)
        js, jo, jn = jp.dedup_batch(jc, js, jb, 0, step)
        ts, to, tn = tp.dedup_batch(tc, ts, tb, 0, step)
        for name in ("tokens", "labels"):
            same(jo[name], to[name], f"step {step} {name}")
        same(jn, tn, "n_dup")
        same(js.duplicates_seen, ts.duplicates_seen, "duplicates_seen")
        same_index(js.dedup_index, ts.dedup_index)
        dups.append(int(tn))
    assert dups == [0, 0, 0, 8, 8]


def test_dedup_off_passes_the_batch_through():
    jc, tc = configs(dedup=False)
    ts = tp.pipeline_init(tc)
    batch = tp.make_batch(tc, 0, 0)
    ts2, out, n = tp.dedup_batch(tc, ts, batch, 0, 0)
    _, _, jn = jp.dedup_batch(jc, jp.pipeline_init(jc), jp.make_batch(jc, 0, 0), 0, 0)
    same(jn, n, "n_dup")
    assert out is batch and ts2 is ts and ts.dedup_index.r == 0


def test_pipeline_defaults_to_the_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    _, tc = configs()
    with pytest.raises(RuntimeError, match="CUDA"):
        tp.pipeline_init(tp.PipelineConfig(vocab_size=8, seq_len=4, batch_per_shard=8))
    assert tp.pipeline_init(tc).duplicates_seen.device == torch.device("cpu")
