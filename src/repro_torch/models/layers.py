"""Shared model layers: norms, RoPE, attention (GQA, blocked, cached), MLP, MoE
(PyTorch counterpart of repro.models.layers).

Conventions:
  * parameters live in `nn.Module`s whose attribute names and layouts are the
    reference's pytree keys and shapes (a dense weight is `w` [d_in, d_out],
    applied as x @ w), so a JAX parameter tree converts leaf by leaf
    (repro_torch.convert). Each layer is a module plus a plain apply function
    of (module, inputs) with the reference's name and arguments.
  * compute dtype is the parameters' (bf16 by default); reductions that need
    it (softmax, norms, router) run in fp32, with the reference's casts.
  * jnp promotes mixed operand types in a matrix product, torch refuses
    them: `_mm` / `_einsum` promote to the common type first.
  * attention KV caches are dicts {"k": [B, S_max, KV, hd], "v": ...};
    `cache_len` is a host int. Decode returns new cache tensors and leaves
    the caller's untouched, as the reference's functional update does.
"""

from __future__ import annotations

import functools
import math
from typing import Optional

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

DTYPE = torch.bfloat16
NEG_INF = -1e30
# Sequence length above which causal attention switches to the Q-blocked
# form (bounds the scores buffer to Q_BLOCK rows). Read at call time.
BLOCKED_ATTN_THRESHOLD = 8192
Q_BLOCK = 1024


# ---------------------------------------------------------------------------
# parameter creation
# ---------------------------------------------------------------------------


class Init:
    """Where and how parameters are made: the device, the compute dtype and a
    `torch.Generator` on that device. On the "meta" device nothing is
    allocated (shapes and dtypes only), so the generator is not used."""

    def __init__(self, device, dtype: torch.dtype = DTYPE, generator: Optional[torch.Generator] = None):
        self.device = torch.device(device)
        self.dtype = dtype
        self.generator = generator

    def _empty(self, shape, dtype):
        return torch.empty(shape, device=self.device, dtype=dtype or self.dtype)

    def normal(self, shape, scale: float = 0.02, dtype=None) -> nn.Parameter:
        if self.device.type == "meta":
            return nn.Parameter(self._empty(shape, dtype))
        x = torch.randn(shape, generator=self.generator, device=self.device, dtype=torch.float32)
        return nn.Parameter(x.mul_(scale).to(dtype or self.dtype))

    def full(self, shape, value: float, dtype=None) -> nn.Parameter:
        x = self._empty(shape, dtype)
        return nn.Parameter(x if self.device.type == "meta" else x.fill_(value))


# ---------------------------------------------------------------------------
# primitives
# ---------------------------------------------------------------------------


def _common(*ops):
    dt = functools.reduce(torch.promote_types, (o.dtype for o in ops))
    return [o.to(dt) for o in ops]


def _mm(x, w):
    x, w = _common(x, w)
    return x @ w


def _einsum(eq, *ops):
    return torch.einsum(eq, *_common(*ops))


class Dense(nn.Module):
    def __init__(self, init: Init, d_in, d_out, bias=False, scale=0.02):
        super().__init__()
        self.w = init.normal((d_in, d_out), scale)
        self.b = init.full((d_out,), 0.0) if bias else None


def dense(p: Dense, x):
    y = _mm(x, p.w)
    if p.b is not None:
        y = y + p.b
    return y


class RMSNorm(nn.Module):
    def __init__(self, init: Init, d):
        super().__init__()
        self.scale = init.full((d,), 1.0)


def rms_norm(p: RMSNorm, x, eps=1e-5):
    xf = x.float()
    var = torch.mean(xf * xf, dim=-1, keepdim=True)
    y = xf * torch.rsqrt(var + eps)
    return (y * p.scale.float()).to(x.dtype)


@functools.lru_cache(maxsize=64)
def _rope_freqs(half: int, theta: float, device: torch.device) -> torch.Tensor:
    # numpy in float32, as the reference computes them: a float64 theta ** e
    # rounded down differs in the last bit, which large positions magnify.
    freqs = 1.0 / (theta ** (np.arange(0, half, dtype=np.float32) / half))
    return torch.from_numpy(np.asarray(freqs, np.float32)).to(device)


def rope(x, positions, theta):
    """Rotary embedding. x: [..., S, H, hd]; positions: [S] or [B, S]."""
    hd = x.shape[-1]
    half = hd // 2
    freqs = _rope_freqs(half, float(theta), x.device)
    angles = positions[..., None].to(torch.float32) * freqs  # [..., S, half]
    cos = torch.cos(angles)[..., None, :]  # [..., S, 1, half]
    sin = torch.sin(angles)[..., None, :]
    xf1, xf2 = x[..., :half].float(), x[..., half:].float()
    return torch.cat([xf1 * cos - xf2 * sin, xf2 * cos + xf1 * sin], dim=-1).to(x.dtype)


def silu(x):
    """x * sigmoid(x) written as jax.nn.silu is, op by op: in bf16 each of
    the four operations rounds, as XLA's (F.silu rounds once, which moves a
    third of bf16 outputs by one unit and can flip an MoE router's choice)."""
    return x * (1 / (1 + torch.exp(-x)))


def _as(dtype, c: float) -> float:
    """The constant c rounded to dtype (jnp casts a constant to the array's type)."""
    return torch.tensor(c, dtype=dtype).item()


def gelu(x):
    """The tanh approximation, which jax.nn.gelu defaults to, written op by
    op as jax writes it (constants in x's dtype, x**3 as x * (x * x))."""
    c = _as(x.dtype, math.sqrt(2 / math.pi))
    cdf = 0.5 * (1.0 + torch.tanh(c * (x + _as(x.dtype, 0.044715) * (x * (x * x)))))
    return x * cdf


def _act(name, x):
    if name == "silu":
        return silu(x)
    if name == "gelu":
        return gelu(x)
    raise ValueError(name)


# ---------------------------------------------------------------------------
# MLP (GLU for silu, plain for gelu)
# ---------------------------------------------------------------------------


class MLP(nn.Module):
    def __init__(self, init: Init, d_model, d_ff, act="silu"):
        super().__init__()
        self.w_gate = Dense(init, d_model, d_ff) if act == "silu" else None  # SwiGLU
        self.w_up = Dense(init, d_model, d_ff)
        self.w_down = Dense(init, d_ff, d_model)


def mlp(p: MLP, x, act="silu"):
    if p.w_gate is not None:
        h = _act("silu", dense(p.w_gate, x)) * dense(p.w_up, x)
    else:
        h = _act(act, dense(p.w_up, x))
    return dense(p.w_down, h)


# ---------------------------------------------------------------------------
# attention
# ---------------------------------------------------------------------------


class Attention(nn.Module):
    def __init__(self, init: Init, d_model, num_heads, num_kv_heads, head_dim, qkv_bias=False):
        super().__init__()
        self.wq = Dense(init, d_model, num_heads * head_dim, bias=qkv_bias)
        self.wk = Dense(init, d_model, num_kv_heads * head_dim, bias=qkv_bias)
        self.wv = Dense(init, d_model, num_kv_heads * head_dim, bias=qkv_bias)
        self.wo = Dense(init, num_heads * head_dim, d_model)


def _sdpa(q, k, v, mask):
    """q: [B,Sq,H,hd]; k,v: [B,Sk,KV,hd]; mask: broadcastable [B,1,Sq,Sk].

    Query head h reads KV head h // groups (q split as [KV, groups])."""
    b, sq, h, hd = q.shape
    kv_heads = k.shape[2]
    groups = h // kv_heads
    qg = q.reshape(b, sq, kv_heads, groups, hd)
    scores = _einsum("bqkgh,bskh->bkgqs", qg, k).float()
    scores = scores / math.sqrt(hd)
    scores = torch.where(mask[:, :, None] if mask.ndim == 4 else mask, scores, NEG_INF)
    probs = torch.softmax(scores, dim=-1).to(q.dtype)
    out = _einsum("bkgqs,bskh->bqkgh", probs, v)
    return out.reshape(b, sq, h, hd)


def _causal_mask(sq, sk, q_offset=0, window=0, device=None):
    qi = torch.arange(sq, device=device)[:, None] + q_offset
    ki = torch.arange(sk, device=device)[None, :]
    m = ki <= qi
    if window:
        m = m & (ki > qi - window)
    return m[None, None]  # [1,1,Sq,Sk]


def attention(p: Attention, x, positions, *, num_heads, num_kv_heads, head_dim, theta,
              causal=True, window=0):
    """Full (or Q-blocked) self-attention for train/prefill."""
    b, s, _ = x.shape
    q = dense(p.wq, x).reshape(b, s, num_heads, head_dim)
    k = dense(p.wk, x).reshape(b, s, num_kv_heads, head_dim)
    v = dense(p.wv, x).reshape(b, s, num_kv_heads, head_dim)
    q = rope(q, positions, theta)
    k = rope(k, positions, theta)

    # On the meta device (shapes only) the blocks would cost time and bound nothing.
    if causal and s > BLOCKED_ATTN_THRESHOLD and s % Q_BLOCK == 0 and not x.is_meta:
        # Q-blocked attention: bounds the score buffer to [B, H, Q_BLOCK, S].
        blocks = []
        for qi in range(s // Q_BLOCK):
            q_blk = q[:, qi * Q_BLOCK:(qi + 1) * Q_BLOCK]
            mask = _causal_mask(Q_BLOCK, s, q_offset=qi * Q_BLOCK, window=window, device=x.device)
            blocks.append(_sdpa(q_blk, k, v, mask))
        out = torch.cat(blocks, dim=1)
    else:
        mask = (_causal_mask(s, s, window=window, device=x.device) if causal
                else torch.ones((1, 1, s, s), dtype=torch.bool, device=x.device))
        out = _sdpa(q, k, v, mask)
    return dense(p.wo, out.reshape(b, s, num_heads * head_dim))


def _pad_seq(t, to):
    """Zero-pad axis 1 of t up to length `to` (no-op when it is not longer)."""
    pad = to - t.shape[1]
    if pad <= 0:
        return t
    return F.pad(t, (0, 0) * (t.ndim - 2) + (0, pad))


def attention_prefill(p: Attention, x, positions, *, num_heads, num_kv_heads, head_dim, theta,
                      window=0, cache_pad_to=0):
    """Prefill: same as attention() but also returns the populated KV cache.

    cache_pad_to > s reserves room in the cache for subsequent decode appends.
    """
    b, s, _ = x.shape
    k = rope(dense(p.wk, x).reshape(b, s, num_kv_heads, head_dim), positions, theta)
    v = dense(p.wv, x).reshape(b, s, num_kv_heads, head_dim)
    y = attention(p, x, positions, num_heads=num_heads, num_kv_heads=num_kv_heads,
                  head_dim=head_dim, theta=theta, causal=True, window=window)
    return y, {"k": _pad_seq(k, cache_pad_to), "v": _pad_seq(v, cache_pad_to)}


def write_slot(cache, new, cache_len: int):
    """A copy of `cache` with `new` ([B, 1, ...]) written at position
    cache_len of axis 1. Like lax.dynamic_update_slice, the start is clamped
    into the cache: at or past a full cache the last slot is overwritten."""
    at = min(max(int(cache_len), 0), cache.shape[1] - 1)
    out = cache.clone()
    out[:, at:at + 1] = new.to(cache.dtype)
    return out


def attention_decode(p: Attention, x, cache, cache_len: int, *, num_heads, num_kv_heads, head_dim,
                     theta, window=0):
    """One-token decode against a KV cache.

    x: [B, 1, D]; cache: {"k","v"}: [B, S_max, KV, hd]; cache_len: host int —
    number of valid positions already in the cache.
    """
    b = x.shape[0]
    s_max = cache["k"].shape[1]
    pos = torch.full((1,), int(cache_len), dtype=torch.int64, device=x.device)
    q = rope(dense(p.wq, x).reshape(b, 1, num_heads, head_dim), pos, theta)
    k_new = rope(dense(p.wk, x).reshape(b, 1, num_kv_heads, head_dim), pos, theta)
    v_new = dense(p.wv, x).reshape(b, 1, num_kv_heads, head_dim)
    k = write_slot(cache["k"], k_new, cache_len)
    v = write_slot(cache["v"], v_new, cache_len)

    ki = torch.arange(s_max, device=x.device)[None, :]
    mask = ki <= cache_len
    if window:
        mask = mask & (ki > cache_len - window)
    out = _sdpa(q, k, v, mask[:, None, None, :])
    y = dense(p.wo, out.reshape(b, 1, num_heads * head_dim))
    return y, {"k": k, "v": v}


# ---------------------------------------------------------------------------
# MoE (sort-based ragged dispatch with static capacity)
# ---------------------------------------------------------------------------


class MoE(nn.Module):
    def __init__(self, init: Init, d_model, num_experts, d_ff, num_shared=0, shared_d_ff=0):
        super().__init__()
        self.router = Dense(init, d_model, num_experts)
        self.w_gate = init.normal((num_experts, d_model, d_ff))
        self.w_up = init.normal((num_experts, d_model, d_ff))
        self.w_down = init.normal((num_experts, d_ff, d_model))
        self.shared = MLP(init, d_model, shared_d_ff or d_ff) if num_shared else None


def moe(p: MoE, x, *, num_experts, top_k, capacity_factor=1.25):
    """Token-choice top-k MoE with static capacity; returns (y, aux).

    (expert, token) assignments are sorted by expert (stable), each expert
    takes a fixed-capacity contiguous slice (overflow assignments are
    dropped) and the expert FFNs run as one batched product [E, C, D] x
    [E, D, F]. The aux value is the Switch load-balance loss.
    """
    b, s, d = x.shape
    n = b * s
    dev = x.device
    xt = x.reshape(n, d)
    m = n * top_k
    capacity = int(np.ceil(m / num_experts * capacity_factor))
    # Keep the expert product well-formed even for tiny smoke configs.
    capacity = max(capacity, 8)

    logits = _mm(xt, p.router.w.float()).float()  # [N, E]
    gates_all = torch.softmax(logits, dim=-1)
    # lax.top_k breaks ties toward the lower index; a stable descending sort does too.
    expert_ids = torch.sort(logits, dim=-1, descending=True, stable=True).indices[:, :top_k]  # [N, K]
    sel_onehot = F.one_hot(expert_ids, num_experts).float()  # [N,K,E]
    gate_vals = torch.einsum("ne,nke->nk", gates_all, sel_onehot)
    gate_vals = gate_vals / gate_vals.sum(-1, keepdim=True).clamp_min(1e-9)

    flat_expert = expert_ids.reshape(m)
    flat_token = torch.arange(n, device=dev).repeat_interleave(top_k)
    sort_e, sort_a = torch.sort(flat_expert, stable=True)
    sort_t = flat_token[sort_a]
    sort_g = gate_vals.reshape(m)[sort_a]
    group_start = torch.searchsorted(sort_e, torch.arange(num_experts, device=dev), side="left")
    pos_in_group = torch.arange(m, device=dev) - group_start[sort_e]
    valid = pos_in_group < capacity
    drop = num_experts * capacity
    slot = torch.where(valid, sort_e * capacity + pos_in_group, drop)

    # Row `drop` takes the assignments over capacity, then is cut off.
    buf = xt.new_zeros((drop + 1, d))
    buf[slot] = xt[sort_t]
    buf = buf[:drop].reshape(num_experts, capacity, d)

    h = silu(_einsum("ecd,edf->ecf", buf, p.w_gate)) * _einsum("ecd,edf->ecf", buf, p.w_up)
    out = _einsum("ecf,efd->ecd", h, p.w_down).reshape(drop, d)

    slot_c = slot.clamp_max(drop - 1)
    contrib = out[slot_c] * (sort_g * valid).to(out.dtype)[:, None]
    y = out.new_zeros((n, d)).index_add_(0, sort_t, contrib)

    if p.shared is not None:
        y = y + mlp(p.shared, xt)

    me = gates_all.mean(dim=0)
    ce = sel_onehot.sum(dim=(0, 1)) / m
    aux = num_experts * torch.sum(me * ce)
    return y.reshape(b, s, d).to(x.dtype), aux
