"""Multi-head Latent Attention (DeepSeek-V2/V3, arXiv:2412.19437), PyTorch
counterpart of repro.models.mla.

Train/prefill use the naive (decompressed) formulation; decode uses the
weight-absorbed formulation, attending directly over the cached latent
(c_kv [B, S, kv_lora] + k_pe [B, S, rope_dim]) without materializing per-head
K/V for the full context: the decode KV stream is (kv_lora + rope) values per
token instead of H*(nope+v).
"""

from __future__ import annotations

import math

import torch
from torch import nn

from repro_torch.models.layers import (
    NEG_INF, Dense, Init, RMSNorm, _einsum, _pad_seq, dense, rms_norm, rope, write_slot,
)


class MLA(nn.Module):
    def __init__(self, init: Init, cfg):
        super().__init__()
        d, h = cfg.d_model, cfg.num_heads
        qk_nope, qk_rope, v_dim = cfg.qk_nope_head_dim, cfg.qk_rope_head_dim, cfg.v_head_dim
        self.wq_a = Dense(init, d, cfg.q_lora_rank)
        self.q_norm = RMSNorm(init, cfg.q_lora_rank)
        self.wq_b = Dense(init, cfg.q_lora_rank, h * (qk_nope + qk_rope))
        self.wkv_a = Dense(init, d, cfg.kv_lora_rank + qk_rope)
        self.kv_norm = RMSNorm(init, cfg.kv_lora_rank)
        self.w_uk = init.normal((cfg.kv_lora_rank, h, qk_nope))
        self.w_uv = init.normal((cfg.kv_lora_rank, h, v_dim))
        self.wo = Dense(init, h * v_dim, d)


def _project_latent(p: MLA, x, positions, cfg):
    """Shared front half: q heads + latent (c_kv, k_pe)."""
    b, s, _ = x.shape
    h = cfg.num_heads
    qk_nope, qk_rope = cfg.qk_nope_head_dim, cfg.qk_rope_head_dim
    q = dense(p.wq_b, rms_norm(p.q_norm, dense(p.wq_a, x), cfg.norm_eps))
    q = q.reshape(b, s, h, qk_nope + qk_rope)
    q_nope, q_pe = q[..., :qk_nope], q[..., qk_nope:]
    q_pe = rope(q_pe, positions, cfg.rope_theta)

    kv = dense(p.wkv_a, x)
    c_kv = rms_norm(p.kv_norm, kv[..., :cfg.kv_lora_rank], cfg.norm_eps)
    k_pe = kv[..., cfg.kv_lora_rank:].reshape(b, s, 1, qk_rope)
    k_pe = rope(k_pe, positions, cfg.rope_theta)[:, :, 0]
    return q_nope, q_pe, c_kv, k_pe


def mla_attention(p: MLA, x, positions, cfg, *, causal=True, return_cache=False, cache_pad_to=0):
    """Naive (decompressed) MLA for train/prefill."""
    b, s, _ = x.shape
    h = cfg.num_heads
    scale = 1.0 / math.sqrt(cfg.qk_nope_head_dim + cfg.qk_rope_head_dim)
    q_nope, q_pe, c_kv, k_pe = _project_latent(p, x, positions, cfg)

    k_nope = _einsum("bsl,lhn->bshn", c_kv, p.w_uk)
    v = _einsum("bsl,lhv->bshv", c_kv, p.w_uv)

    scores = (_einsum("bqhn,bshn->bhqs", q_nope, k_nope)
              + _einsum("bqhr,bsr->bhqs", q_pe, k_pe)).float() * scale
    if causal:
        idx = torch.arange(s, device=x.device)
        mask = idx[None, :] <= idx[:, None]
        scores = torch.where(mask[None, None], scores, NEG_INF)
    probs = torch.softmax(scores, dim=-1).to(x.dtype)
    out = _einsum("bhqs,bshv->bqhv", probs, v)
    y = dense(p.wo, out.reshape(b, s, h * cfg.v_head_dim))
    if return_cache:
        return y, {"c_kv": _pad_seq(c_kv, cache_pad_to), "k_pe": _pad_seq(k_pe, cache_pad_to)}
    return y


def mla_decode(p: MLA, x, cache, cache_len: int, cfg):
    """Weight-absorbed single-token decode over the latent cache.

    scores = q_nope' c_kv^T + q_pe k_pe^T   with q_nope' = q_nope W_uk
    out    = (probs c_kv) W_uv              (no per-head K/V)
    """
    b = x.shape[0]
    h = cfg.num_heads
    s_max = cache["c_kv"].shape[1]
    scale = 1.0 / math.sqrt(cfg.qk_nope_head_dim + cfg.qk_rope_head_dim)
    pos = torch.full((1,), int(cache_len), dtype=torch.int64, device=x.device)
    q_nope, q_pe, c_kv_new, k_pe_new = _project_latent(p, x, pos, cfg)

    c_kv = write_slot(cache["c_kv"], c_kv_new, cache_len)
    k_pe = write_slot(cache["k_pe"], k_pe_new, cache_len)

    q_abs = _einsum("bqhn,lhn->bqhl", q_nope, p.w_uk)  # [B,1,H,kv_lora]
    scores = (_einsum("bqhl,bsl->bhqs", q_abs, c_kv)
              + _einsum("bqhr,bsr->bhqs", q_pe, k_pe)).float() * scale
    mask = torch.arange(s_max, device=x.device)[None, None, None, :] <= cache_len
    scores = torch.where(mask, scores, NEG_INF)
    probs = torch.softmax(scores, dim=-1).to(x.dtype)
    out_latent = _einsum("bhqs,bsl->bqhl", probs, c_kv)
    out = _einsum("bqhl,lhv->bqhv", out_latent, p.w_uv)
    y = dense(p.wo, out.reshape(b, 1, h * cfg.v_head_dim))
    return y, {"c_kv": c_kv, "k_pe": k_pe}
