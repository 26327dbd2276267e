"""Assigned input shapes (4 per architecture = 40 dry-run cells).

Shape kinds:
  train_4k    — training step, seq 4096, global batch 256
  prefill_32k — inference prefill, seq 32768, global batch 32
  decode_32k  — one-token decode against a 32768-token KV cache, batch 128
  long_500k   — one-token decode at 524288 context, batch 1; requires
                sub-quadratic sequence mixing (SSM/hybrid only — pure
                full-attention archs SKIP this cell, see DESIGN.md §5)
"""

from __future__ import annotations

import dataclasses

from repro_torch.configs.base import ModelConfig


@dataclasses.dataclass(frozen=True)
class InputShape:
    name: str
    kind: str           # "train" | "prefill" | "decode"
    seq_len: int
    global_batch: int


TRAIN_4K = InputShape("train_4k", "train", 4096, 256)
PREFILL_32K = InputShape("prefill_32k", "prefill", 32768, 32)
DECODE_32K = InputShape("decode_32k", "decode", 32768, 128)
LONG_500K = InputShape("long_500k", "decode", 524288, 1)

ALL_SHAPES = (TRAIN_4K, PREFILL_32K, DECODE_32K, LONG_500K)


def shapes_for(cfg: ModelConfig):
    """The shape cells this architecture runs (long_500k gated on family)."""
    out = [TRAIN_4K, PREFILL_32K, DECODE_32K]
    if cfg.supports_long_context():
        out.append(LONG_500K)
    return tuple(out)


def get_shape(name: str) -> InputShape:
    for s in ALL_SHAPES:
        if s.name == name:
            return s
    raise KeyError(f"unknown shape {name!r}")
