"""Generic decoder-only LM covering dense / GQA / MLA / MoE / SSM / hybrid
(PyTorch counterpart of repro.models.transformer).

A model is a sequence of *groups*. Each group is `count` identical units; a
unit is a short list of sublayer descriptors (mixer, ffn):

  dense/moe/vlm : [ (attn|mla, mlp|moe) ] x num_layers      (1 group, or 2 for
                   deepseek's first-k-dense prefix)
  ssm           : [ (mamba, none) ] x num_layers
  hybrid(jamba) : one unit = 8 sublayers  [m,m,m,m,a,m,m,m] with moe on odd
                   positions, repeated num_layers/8 times

The reference stacks a group's unit parameters on a leading axis and runs
`lax.scan` over them; here a group is an `nn.ModuleList` of units and the
scan is a loop; training rematerialises each unit as the reference's
jax.checkpoint does (`remat_policy`). Caches follow: a group's cache is a
list of one dict per unit, {"sub{j}": {mixer: {...}, "cross": {...}}}.
"""

from __future__ import annotations

import functools
from typing import Any

import torch
from torch import nn
from torch.utils.checkpoint import CheckpointPolicy, checkpoint, create_selective_checkpoint_contexts

from repro_torch.configs.base import ModelConfig
from repro_torch.models import layers as L
from repro_torch.models import mamba2, mla

# ---------------------------------------------------------------------------
# plans
# ---------------------------------------------------------------------------


def decoder_plan(cfg: ModelConfig):
    """[(count, [(mixer, ffn), ...]), ...] — the decoder's groups."""
    if cfg.family == "hybrid":
        period = cfg.attn_layer_period
        if cfg.num_layers % period:
            raise ValueError(f"num_layers {cfg.num_layers} is not a multiple of the period {period}")
        descs = []
        for j in range(period):
            mixer = "attn" if j == cfg.attn_layer_offset else "mamba"
            ffn = "moe" if cfg.is_moe_layer(j) else "mlp"
            descs.append((mixer, ffn))
        return [(cfg.num_layers // period, descs)]
    if cfg.family == "ssm":
        return [(cfg.num_layers, [("mamba", "none")])]
    mixer = "mla" if cfg.use_mla else "attn"
    groups = []
    if cfg.first_k_dense:
        groups.append((cfg.first_k_dense, [(mixer, "mlp")]))
    ffn = "moe" if cfg.num_experts else "mlp"
    groups.append((cfg.num_layers - cfg.first_k_dense, [(mixer, ffn)]))
    return groups


# ---------------------------------------------------------------------------
# sublayers
# ---------------------------------------------------------------------------


class Sublayer(nn.Module):
    """One (mixer, ffn) sublayer; absent parts are None. Attribute names are
    the reference's parameter keys."""

    def __init__(self, init: L.Init, cfg: ModelConfig, mixer: str, ffn: str, cross: bool = False):
        super().__init__()
        self.ln1 = L.RMSNorm(init, cfg.d_model)
        self.attn = self.mla = self.mamba = None
        if mixer == "attn":
            self.attn = L.Attention(init, cfg.d_model, cfg.num_heads, cfg.num_kv_heads,
                                    cfg.resolved_head_dim, qkv_bias=cfg.qkv_bias)
        elif mixer == "mla":
            self.mla = mla.MLA(init, cfg)
        elif mixer == "mamba":
            self.mamba = mamba2.Mamba2(init, cfg)
        else:
            raise ValueError(mixer)
        self.ln_cross = self.cross = None
        if cross:
            self.ln_cross = L.RMSNorm(init, cfg.d_model)
            self.cross = L.Attention(init, cfg.d_model, cfg.num_heads, cfg.num_kv_heads,
                                     cfg.resolved_head_dim)
        self.ln2 = self.moe = self.mlp = None
        if ffn != "none":
            self.ln2 = L.RMSNorm(init, cfg.d_model)
            if ffn == "moe":
                self.moe = L.MoE(init, cfg.d_model, cfg.num_experts, cfg.moe_d_ff,
                                 num_shared=cfg.num_shared_experts, shared_d_ff=cfg.moe_d_ff)
            else:
                self.mlp = L.MLP(init, cfg.d_model, cfg.d_ff, cfg.act)


def _attn_kwargs(cfg: ModelConfig):
    return dict(
        num_heads=cfg.num_heads,
        num_kv_heads=cfg.num_kv_heads,
        head_dim=cfg.resolved_head_dim,
        theta=cfg.rope_theta,
    )


def _cross_kv(cfg, p: L.Attention, enc_out):
    """Per-layer cross-attention K/V from the encoder output."""
    b, se, _ = enc_out.shape
    hd = cfg.resolved_head_dim
    k = L.dense(p.wk, enc_out).reshape(b, se, cfg.num_kv_heads, hd)
    v = L.dense(p.wv, enc_out).reshape(b, se, cfg.num_kv_heads, hd)
    return {"k": k, "v": v}


def _cross_attention(cfg, p: L.Attention, x, kv):
    """Cross-attention over (cached) encoder K/V — bidirectional, no RoPE."""
    b, s, _ = x.shape
    hd = cfg.resolved_head_dim
    q = L.dense(p.wq, x).reshape(b, s, cfg.num_heads, hd)
    mask = torch.ones((1, 1, s, kv["k"].shape[1]), dtype=torch.bool, device=x.device)
    out = L._sdpa(q, kv["k"], kv["v"], mask)
    return L.dense(p.wo, out.reshape(b, s, cfg.num_heads * hd))


def sublayer_apply(cfg: ModelConfig, p: Sublayer, x, positions, mode, cache=None,
                   cache_len=None, enc_out=None, causal=True, cache_pad_to=0):
    """Returns (x, new_cache, aux).

    enc_out: encoder output for cross-attention sublayers (train/prefill);
    at decode the per-layer cross K/V come from the cache instead.
    """
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    h = L.rms_norm(p.ln1, x, cfg.norm_eps)
    new_cache: dict[str, Any] = {}
    if p.attn is not None:
        kw = _attn_kwargs(cfg)
        if mode == "train":
            a = L.attention(p.attn, h, positions, causal=causal, **kw)
        elif mode == "prefill":
            a, new_cache["attn"] = L.attention_prefill(p.attn, h, positions, cache_pad_to=cache_pad_to, **kw)
        else:
            s_max = cache["attn"]["k"].shape[1]
            window = cfg.sliding_window if (cfg.sliding_window and s_max > 100_000) else 0
            a, new_cache["attn"] = L.attention_decode(p.attn, h, cache["attn"], cache_len, window=window, **kw)
    elif p.mla is not None:
        if mode == "train":
            a = mla.mla_attention(p.mla, h, positions, cfg)
        elif mode == "prefill":
            a, new_cache["mla"] = mla.mla_attention(p.mla, h, positions, cfg, return_cache=True,
                                                    cache_pad_to=cache_pad_to)
        else:
            a, new_cache["mla"] = mla.mla_decode(p.mla, h, cache["mla"], cache_len, cfg)
    else:
        if mode == "train":
            a = mamba2.mamba2_forward(p.mamba, h, cfg)
        elif mode == "prefill":
            a, new_cache["mamba"] = mamba2.mamba2_forward(p.mamba, h, cfg, return_cache=True)
        else:
            a, new_cache["mamba"] = mamba2.mamba2_decode(p.mamba, h, cache["mamba"], cfg)
    x = x + a

    if p.cross is not None:
        hc = L.rms_norm(p.ln_cross, x, cfg.norm_eps)
        kv = cache["cross"] if mode == "decode" else _cross_kv(cfg, p.cross, enc_out)
        if mode != "train":
            new_cache["cross"] = kv
        x = x + _cross_attention(cfg, p.cross, hc, kv)

    if p.ln2 is not None:
        h2 = L.rms_norm(p.ln2, x, cfg.norm_eps)
        if p.moe is not None:
            y, aux = L.moe(p.moe, h2, num_experts=cfg.num_experts, top_k=cfg.num_experts_per_tok,
                           capacity_factor=cfg.moe_capacity_factor)
        else:
            y = L.mlp(p.mlp, h2, cfg.act)
        x = x + y
    return x, new_cache, aux


# ---------------------------------------------------------------------------
# groups
# ---------------------------------------------------------------------------


def group_init(init: L.Init, cfg: ModelConfig, count: int, descs, cross: bool = False) -> nn.ModuleList:
    """`count` units, each {"sub{j}": Sublayer}."""
    return nn.ModuleList(
        nn.ModuleDict({f"sub{j}": Sublayer(init, cfg, m, f, cross=cross) for j, (m, f) in enumerate(descs)})
        for _ in range(count)
    )


def _save_plain_products(ctx, op, *args, **kwargs):
    """The "dots" policy: keep the outputs of 2-D matrix products (jax's
    dots_with_no_batch_dims_saveable), recompute everything else."""
    if op in (torch.ops.aten.mm.default, torch.ops.aten.addmm.default):
        return CheckpointPolicy.MUST_SAVE
    return CheckpointPolicy.PREFER_RECOMPUTE


def _remat(remat_policy: str):
    """How a training unit runs under autograd: "full" keeps only its inputs
    and recomputes it in the backward pass, "dots" also keeps its plain
    matrix products, "none" keeps every activation."""
    if remat_policy == "full":
        return functools.partial(checkpoint, use_reentrant=False, preserve_rng_state=False)
    if remat_policy == "dots":
        return functools.partial(
            checkpoint, use_reentrant=False, preserve_rng_state=False,
            context_fn=functools.partial(create_selective_checkpoint_contexts, _save_plain_products))
    if remat_policy == "none":
        return None
    raise ValueError(remat_policy)


def group_apply_train(cfg, group, descs, x, positions, enc_out=None, causal=True, remat_policy="full"):
    """The group's units in order. Under autograd each unit is
    rematerialised by `remat_policy`, as the reference wraps its scan body in
    jax.checkpoint; with gradients off (prefill, serving) it runs as it is.
    The forward draws no random numbers, so no RNG state is stashed."""
    remat = _remat(remat_policy)

    def body(unit, x, aux):
        for j in range(len(descs)):
            x, _, a = sublayer_apply(cfg, unit[f"sub{j}"], x, positions, "train", enc_out=enc_out, causal=causal)
            aux = aux + a
        return x, aux

    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    for unit in group:
        if remat is not None and torch.is_grad_enabled():
            x, aux = remat(body, unit, x, aux)
        else:
            x, aux = body(unit, x, aux)
    return x, aux


def group_apply_prefill(cfg, group, descs, x, positions, enc_out=None, cache_pad_to=0):
    caches = []
    for unit in group:
        c_unit = {}
        for j in range(len(descs)):
            x, c_unit[f"sub{j}"], _ = sublayer_apply(cfg, unit[f"sub{j}"], x, positions, "prefill",
                                                     enc_out=enc_out, cache_pad_to=cache_pad_to)
        caches.append(c_unit)
    return x, caches


def group_apply_decode(cfg, group, descs, x, caches, cache_len: int):
    new_caches = []
    for unit, cache in zip(group, caches):
        c_unit = {}
        for j in range(len(descs)):
            x, c_unit[f"sub{j}"], _ = sublayer_apply(cfg, unit[f"sub{j}"], x, None, "decode",
                                                     cache=cache[f"sub{j}"], cache_len=cache_len)
        new_caches.append(c_unit)
    return x, new_caches
