"""Top-level model API: init / train / prefill / decode for every arch family
(PyTorch counterpart of repro.models.model_zoo).

The model is one `nn.Module` (`Model`) whose submodules carry the
reference's parameter names; the entry points are functions of
(cfg, model, batch) with the reference's names and returns.

Batch dicts ("extra" inputs are the modality stubs):
  train   : tokens [B,St] int, labels [B,St] int
            (+ patch_embeds [B,P,D] for vlm; frames [B,Se,D] for audio)
  prefill : tokens [B,S] (+ stubs)
  decode  : token [B,1], caches (from prefill), cache_len (a host int)
"""

from __future__ import annotations

import functools
from typing import Optional

import torch
from torch import nn

from repro_torch.api.dictionary import resolve_device
from repro_torch.checkpoint.checkpoint import TensorSpec, tree_map
from repro_torch.configs.base import ModelConfig
from repro_torch.configs.shapes import InputShape
from repro_torch.models import layers as L
from repro_torch.models import transformer as T
from repro_torch.train.options import PerfOptions, resolve as resolve_options

# Encoder frame count for the audio (enc-dec) architecture, all shapes.
AUDIO_ENC_LEN = 4096
# The audio encoder's one group of units.
_ENC_DESCS = [("attn", "mlp")]


# ---------------------------------------------------------------------------
# init
# ---------------------------------------------------------------------------


class Model(nn.Module):
    """embed [V, D], final_norm, lm_head [D, V], groups (one `nn.ModuleList`
    of units per decoder group), and the stubs' parameters where the config
    has them (vision_proj; enc_groups and enc_final_norm)."""

    def __init__(self, cfg: ModelConfig, init: L.Init):
        super().__init__()
        self.embed = init.normal((cfg.vocab_size, cfg.d_model))
        self.final_norm = L.RMSNorm(init, cfg.d_model)
        self.lm_head = init.normal((cfg.d_model, cfg.vocab_size))
        self.groups = nn.ModuleList(
            T.group_init(init, cfg, count, descs, cross=cfg.is_encoder_decoder)
            for count, descs in T.decoder_plan(cfg)
        )
        self.vision_proj = L.Dense(init, cfg.d_model, cfg.d_model) if cfg.has_vision_stub else None
        self.enc_groups = self.enc_final_norm = None
        if cfg.is_encoder_decoder:
            self.enc_groups = nn.ModuleList([T.group_init(init, cfg, cfg.num_encoder_layers, _ENC_DESCS)])
            self.enc_final_norm = L.RMSNorm(init, cfg.d_model)


def init_params(cfg: ModelConfig, seed: int = 0, *, device=None, dtype: torch.dtype = L.DTYPE) -> Model:
    """A `Model` with the reference's shapes and per-leaf dtypes (dtype for
    every weight, fp32 for Mamba's A_log / D / dt_bias): weights N(0, 0.02²)
    (Mamba's conv 0.1²), biases 0, norm scales 1, drawn from a
    `torch.Generator` on the device seeded with `seed`, so they are not the
    reference's values; convert.model_params_from_jax carries those over.
    device: None means the card; "meta" allocates nothing."""
    dev = resolve_device(device)
    generator = None if dev.type == "meta" else torch.Generator(device=dev).manual_seed(seed)
    with torch.no_grad():
        return Model(cfg, L.Init(dev, dtype, generator))


# ---------------------------------------------------------------------------
# shared pieces
# ---------------------------------------------------------------------------


def _encode(cfg, params: Model, frames, options: Optional[PerfOptions] = None):
    """Audio encoder over stub frame embeddings (bidirectional). The frames
    enter in bf16 whatever the parameters' dtype, as in the reference."""
    opts = resolve_options(options)
    x = frames.to(L.DTYPE)
    positions = torch.arange(x.shape[1], device=x.device)
    for group in params.enc_groups:
        x, _ = T.group_apply_train(cfg, group, _ENC_DESCS, x, positions, causal=False,
                                   remat_policy=opts.remat_policy)
    return L.rms_norm(params.enc_final_norm, x, cfg.norm_eps)


def _embed_inputs(cfg, params: Model, tokens, batch):
    """Token embeddings (+ prepended projected patch embeddings for vlm)."""
    x = params.embed[tokens]
    n_prefix = 0
    if cfg.has_vision_stub:
        pe = L.dense(params.vision_proj, batch["patch_embeds"].to(L.DTYPE))
        x = torch.cat([pe, x], dim=1)
        n_prefix = pe.shape[1]
    return x, n_prefix


def _head(cfg, params: Model, x):
    x = L.rms_norm(params.final_norm, x, cfg.norm_eps)
    return L._mm(x, params.lm_head)


# ---------------------------------------------------------------------------
# train / prefill / decode
# ---------------------------------------------------------------------------


def apply_train(cfg: ModelConfig, params: Model, batch, options: Optional[PerfOptions] = None):
    """Returns (logits [B,St,V], aux_loss scalar). Of `options` only
    `remat_policy` acts on one device: under autograd each unit (and each
    audio encoder unit) is rematerialised by it."""
    opts = resolve_options(options)
    enc_out = _encode(cfg, params, batch["frames"], opts) if cfg.is_encoder_decoder else None
    x, n_prefix = _embed_inputs(cfg, params, batch["tokens"], batch)
    positions = torch.arange(x.shape[1], device=x.device)
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    for group, (count, descs) in zip(params.groups, T.decoder_plan(cfg)):
        x, a = T.group_apply_train(cfg, group, descs, x, positions, enc_out=enc_out,
                                   remat_policy=opts.remat_policy)
        aux = aux + a
    if n_prefix:
        x = x[:, n_prefix:]
    return _head(cfg, params, x), aux


def apply_prefill(cfg: ModelConfig, params: Model, batch, cache_pad_to=0,
                  options: Optional[PerfOptions] = None):
    """Returns (last-position logits [B,V], caches: one list of per-unit
    cache dicts per group).

    cache_pad_to reserves cache room for decode appends beyond the prompt."""
    del options
    enc_out = _encode(cfg, params, batch["frames"]) if cfg.is_encoder_decoder else None
    x, _ = _embed_inputs(cfg, params, batch["tokens"], batch)
    positions = torch.arange(x.shape[1], device=x.device)
    caches = []
    for group, (count, descs) in zip(params.groups, T.decoder_plan(cfg)):
        x, c = T.group_apply_prefill(cfg, group, descs, x, positions, enc_out=enc_out,
                                     cache_pad_to=cache_pad_to)
        caches.append(c)
    logits = _head(cfg, params, x[:, -1:])[:, 0]
    return logits, caches


def apply_decode(cfg: ModelConfig, params: Model, token, caches, cache_len: int,
                 options: Optional[PerfOptions] = None):
    """One-token step at position cache_len (a host int). Returns (logits
    [B,V], new caches); the caches passed in are left as they were."""
    del options
    x = params.embed[token]  # [B, 1, D]
    new_caches = []
    for group, c, (count, descs) in zip(params.groups, caches, T.decoder_plan(cfg)):
        x, nc = T.group_apply_decode(cfg, group, descs, x, c, int(cache_len))
        new_caches.append(nc)
    return _head(cfg, params, x)[:, 0], new_caches


# ---------------------------------------------------------------------------
# input specs (TensorSpec stand-ins on the meta device; no allocation)
# ---------------------------------------------------------------------------


def _sds(shape, dtype) -> TensorSpec:
    return TensorSpec(tuple(shape), dtype, torch.device("meta"))


def _prefill_batch(cfg: ModelConfig, b: int, s: int) -> dict:
    st = s - cfg.num_patches if cfg.has_vision_stub else s
    batch = {"tokens": _sds((b, st), torch.int32)}
    if cfg.has_vision_stub:
        batch["patch_embeds"] = _sds((b, cfg.num_patches, cfg.d_model), L.DTYPE)
    if cfg.is_encoder_decoder:
        batch["frames"] = _sds((b, AUDIO_ENC_LEN, cfg.d_model), L.DTYPE)
    return batch


def input_specs(cfg: ModelConfig, shape: InputShape) -> dict:
    """Abstract inputs for one (arch x shape) dry-run cell, in the
    reference's layout: {"batch"} for train and prefill, {"token", "caches",
    "cache_len"} for decode."""
    b, s = shape.global_batch, shape.seq_len
    if shape.kind == "train":
        batch = _prefill_batch(cfg, b, s)
        batch["labels"] = _sds(batch["tokens"].shape, torch.int32)
        return {"batch": batch}
    if shape.kind == "prefill":
        return {"batch": _prefill_batch(cfg, b, s)}
    if shape.kind == "decode":
        return {"token": _sds((b, 1), torch.int32), "caches": cache_specs(cfg, b, s),
                "cache_len": _sds((), torch.int32)}
    raise ValueError(shape.kind)


def cache_specs(cfg: ModelConfig, batch: int, s_max: int):
    """Abstract KV/state caches for a decode step with context s_max, in the
    port's layout (one list of per-unit dicts per group).

    They are what a "meta"-device `apply_prefill` of a "meta"-device
    `init_params` returns, so they cannot drift from what prefill returns."""
    return tree_map(lambda spec: spec, _cache_specs(cfg, batch, s_max))  # a fresh tree over the cached specs


@functools.lru_cache(maxsize=64)
def _cache_specs(cfg: ModelConfig, batch: int, s_max: int):
    inputs = {k: torch.empty(v.shape, dtype=v.dtype, device="meta")
              for k, v in _prefill_batch(cfg, batch, s_max).items()}
    with torch.no_grad():
        _, caches = apply_prefill(cfg, init_params(cfg, device="meta"), inputs)
    return tree_map(TensorSpec.of, caches)


# ---------------------------------------------------------------------------
# analytic parameter / FLOP model
# ---------------------------------------------------------------------------


def count_params_analytic(cfg: ModelConfig, active_only=False):
    """Parameter count from a model built on the "meta" device (no allocation).

    active_only: routed-expert weights scaled by (top_k / num_experts), the
    per-token active parameter count used for MoE MODEL_FLOPS. The scaling
    is applied to each routed-expert tensor stacked over its group's units
    (the reference's [units, E, ...] leaf), so the integer rounding matches.
    """
    model = init_params(cfg, device="meta")
    total = 0
    for group in model.groups:
        for name, leaf in group[0].named_parameters():
            size = leaf.numel() * len(group)
            if active_only and "moe" in name and leaf.ndim == 3:
                size = int(size * cfg.num_experts_per_tok / cfg.num_experts)
            total += size
    for name, leaf in model.named_parameters():
        if not name.startswith("groups."):
            total += leaf.numel()
    return total


def count_embedding_params(cfg: ModelConfig):
    return cfg.vocab_size * cfg.d_model * 2  # embed + lm_head


def model_flops(cfg: ModelConfig, shape: InputShape) -> float:
    """Useful MODEL_FLOPS for one step (6*N*T train / 2*N*T inference
    + quadratic attention term). MoE uses active params."""
    n_active = count_params_analytic(cfg, active_only=True) - count_embedding_params(cfg)
    n_active += cfg.d_model * cfg.vocab_size  # lm_head matmul is real work
    b, s = shape.global_batch, shape.seq_len

    n_attn_layers = sum(1 for i in range(cfg.num_layers) if cfg.is_attn_layer(i))
    hd = cfg.resolved_head_dim if not cfg.use_mla else (cfg.qk_nope_head_dim + cfg.qk_rope_head_dim)
    h = cfg.num_heads

    if shape.kind == "train":
        tok = b * s
        attn = 3 * 2 * 2 * b * (s * s / 2) * h * hd * n_attn_layers  # bwd x (QK^T + PV), causal
        return 6.0 * n_active * tok + attn
    if shape.kind == "prefill":
        tok = b * s
        attn = 2 * 2 * b * (s * s / 2) * h * hd * n_attn_layers
        return 2.0 * n_active * tok + attn
    # decode: one token against an s-long context
    attn = 2 * 2 * b * s * h * hd * n_attn_layers
    ssm_layers = sum(1 for i in range(cfg.num_layers) if not cfg.is_attn_layer(i)) if cfg.family in ("ssm", "hybrid") else 0
    ssm = 2 * b * cfg.ssm_heads * cfg.ssm_head_dim * cfg.ssm_state_dim * ssm_layers * 3 if ssm_layers else 0
    return 2.0 * n_active * b + attn + ssm
