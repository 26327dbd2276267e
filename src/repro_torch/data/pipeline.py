"""Synthetic, shard-aware training data pipeline with LSM-backed dedup
(PyTorch counterpart of repro.data.pipeline).

Deterministic generation keyed by (seed, shard, step): every data-parallel
host can regenerate its stream on its own. The dedup index is the paper's
dictionary: each document's rolling hash is bulk-looked-up; hits are
replaced by fresh samples (one retry round), and the batch of new hashes is
inserted as one direct LSM batch (a streaming-ingest workload).
"""

from __future__ import annotations

import dataclasses
from typing import NamedTuple, Optional

import numpy as np
import torch

from repro_torch.api.dictionary import resolve_device
from repro_torch.core import semantics as sem
from repro_torch.core.lsm import LSMConfig, LSMState, lsm_init, lsm_update
from repro_torch.core.queries import lsm_lookup

_U32 = 0xFFFFFFFF


@dataclasses.dataclass(frozen=True)
class PipelineConfig:
    vocab_size: int
    seq_len: int
    batch_per_shard: int
    seed: int = 0
    dedup: bool = True
    dedup_levels: int = 16
    device: Optional[object] = None  # None: the card


class PipelineState(NamedTuple):
    dedup_index: LSMState
    duplicates_seen: torch.Tensor  # int32[]


def _dedup_cfg(cfg: PipelineConfig) -> LSMConfig:
    return LSMConfig(batch_size=cfg.batch_per_shard, num_levels=cfg.dedup_levels)


def pipeline_init(cfg: PipelineConfig) -> PipelineState:
    device = resolve_device(cfg.device)
    return PipelineState(
        dedup_index=lsm_init(_dedup_cfg(cfg), device),
        duplicates_seen=torch.zeros((), dtype=torch.int32, device=device),
    )


def _doc_hash(tokens: torch.Tensor) -> torch.Tensor:
    """Rolling polynomial hash -> 30-bit user key space.

    The reference folds h = h * 31 + tok over the columns in uint32. Here it
    is the closed form sum_j tok_j * 31^(L-1-j) mod 2^32, one pass over the
    tokens: each product is taken mod 2^32 from two 16-bit halves of the
    power, so no int64 operation overflows, and the sum of L terms below 2^32
    stays exact in int64."""
    length = tokens.shape[1]
    powers = [pow(31, length - 1 - j, 1 << 32) for j in range(length)]
    p = torch.tensor(powers, dtype=torch.int64, device=tokens.device)
    t = tokens.to(torch.int64) & _U32  # uint32(token), negatives wrap
    low = t * (p & 0xFFFF)
    high = ((t * (p >> 16)) & 0xFFFF) << 16
    h = ((low + high) & _U32).sum(1) & _U32
    return (h % sem.MAX_USER_KEY).to(torch.int32)


def make_batch(cfg: PipelineConfig, shard: int, step: int):
    """Deterministic {tokens, labels} for (shard, step): numpy on the host (the
    reference's generator), then int32 tensors on the config's device."""
    rng = np.random.default_rng((cfg.seed, shard, step))
    # Zipfian-ish token ids so duplicates actually occur across steps.
    toks = rng.zipf(1.3, size=(cfg.batch_per_shard, cfg.seq_len + 1)) % cfg.vocab_size
    toks = torch.from_numpy(toks.astype(np.int32)).to(resolve_device(cfg.device))
    return {"tokens": toks[:, :-1], "labels": toks[:, 1:]}


def dedup_batch(cfg: PipelineConfig, state: PipelineState, batch, shard: int, step: int):
    """Replace duplicate documents (by hash) with retry samples; update index.

    Returns (state, batch, num_dups). One retry round: a document that is a
    duplicate twice in a row passes through. The index is updated in place
    (the returned state holds it), as every LSM mutator of this package is.
    """
    if not cfg.dedup:
        return state, batch, torch.zeros((), dtype=torch.int32, device=state.duplicates_seen.device)
    dcfg = _dedup_cfg(cfg)
    h = _doc_hash(batch["tokens"])
    found, _ = lsm_lookup(dcfg, state.dedup_index, h)
    tokens, labels, h_new = batch["tokens"], batch["labels"], h
    # With no duplicate every row keeps its document, so the retry sample is
    # not drawn (the reference draws it and selects none of it).
    if bool(found.any()):
        retry = make_batch(cfg, shard, step + (1 << 20))
        mask = found[:, None]
        tokens = torch.where(mask, retry["tokens"], tokens)
        labels = torch.where(mask, retry["labels"], labels)
        h_new = torch.where(found, _doc_hash(tokens), h)
    index = lsm_update(dcfg, state.dedup_index, sem.encode_insert(h_new),
                       torch.full_like(h_new, step % (1 << 30)))
    n_dup = found.sum(dtype=torch.int32)
    return (
        PipelineState(index, state.duplicates_seen + n_dup),
        {"tokens": tokens, "labels": labels},
        n_dup,
    )
