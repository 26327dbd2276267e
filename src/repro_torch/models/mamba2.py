"""Mamba-2 SSD block (arXiv:2405.21060), chunked matmul form + decode
recurrence (PyTorch counterpart of repro.models.mamba2).

Train/prefill run the chunk-parallel SSD algorithm: intra-chunk blocks are
dense einsums, and the state entering each chunk is carried from chunk to
chunk (the reference's associative scan over chunks, here a loop over the
chunks with the same exclusive "state entering chunk z"). Every dtype cast
of the reference is kept, so bf16 runs round where it rounds.

Decode is the O(1) recurrence over the (conv_state, ssm_state) cache.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from repro_torch.models.layers import Dense, Init, RMSNorm, _einsum, dense, rms_norm, silu


class Mamba2(nn.Module):
    def __init__(self, init: Init, cfg):
        super().__init__()
        d, d_inner, h = cfg.d_model, cfg.d_inner, cfg.ssm_heads
        g, n = cfg.ssm_n_groups, cfg.ssm_state_dim
        conv_dim = d_inner + 2 * g * n
        # in_proj order: [z (d_inner), x (d_inner), B (g*n), C (g*n), dt (h)]
        self.in_proj = Dense(init, d, 2 * d_inner + 2 * g * n + h)
        self.conv_w = init.normal((cfg.conv_kernel, conv_dim), scale=0.1)
        self.conv_b = init.full((conv_dim,), 0.0)
        # fp32 leaves whatever the compute dtype.
        self.A_log = init.full((h,), 0.0, dtype=torch.float32)
        self.D = init.full((h,), 1.0, dtype=torch.float32)
        self.dt_bias = init.full((h,), -2.0, dtype=torch.float32)
        self.norm = RMSNorm(init, d_inner)
        self.out_proj = Dense(init, d_inner, d)


def _split_proj(cfg, zxbcdt):
    d_inner = cfg.d_inner
    g, n = cfg.ssm_n_groups, cfg.ssm_state_dim
    z = zxbcdt[..., :d_inner]
    xbc = zxbcdt[..., d_inner:2 * d_inner + 2 * g * n]
    dt = zxbcdt[..., 2 * d_inner + 2 * g * n:]
    return z, xbc, dt


def _causal_conv(w, b, xbc):
    """Depthwise causal conv1d, kernel k. xbc: [B, S, C]."""
    k = w.shape[0]
    pad = F.pad(xbc, (0, 0, k - 1, 0))
    out = sum(pad[:, i:i + xbc.shape[1], :] * w[i] for i in range(k))
    return silu(out + b)


def _ssd_chunked(x, dt, A, B, C, chunk):
    """SSD Algorithm 1. x:[b,s,h,p] dt:[b,s,h] A:[h] B,C:[b,s,n] (groups=1).

    Returns (y:[b,s,h,p], final_state:[b,h,p,n]).
    """
    b, s, h, p = x.shape
    n = B.shape[-1]
    if s % chunk:
        raise ValueError(f"sequence {s} is not a multiple of the chunk {chunk}")
    z = s // chunk
    xc = x.reshape(b, z, chunk, h, p)
    dtc = dt.reshape(b, z, chunk, h)
    Bc = B.reshape(b, z, chunk, n)
    Cc = C.reshape(b, z, chunk, n)

    dtA = dtc * A[None, None, None, :]              # [b,z,c,h], negative
    cum = torch.cumsum(dtA, dim=2)                  # within-chunk cumulative

    # Intra-chunk (diagonal) blocks.
    seg = cum[:, :, :, None, :] - cum[:, :, None, :, :]       # [b,z,i,j,h]
    ar = torch.arange(chunk, device=x.device)
    ij_mask = (ar[:, None] >= ar[None, :])[None, None, :, :, None]
    L = torch.where(ij_mask, torch.exp(seg), 0.0)             # [b,z,i,j,h]
    cb = _einsum("bzin,bzjn->bzij", Cc, Bc)                   # [b,z,i,j]
    w = cb[..., None] * L * dtc[:, :, None, :, :]             # [b,z,i,j,h]
    y_diag = _einsum("bzijh,bzjhp->bzihp", w.to(x.dtype), xc)

    # Per-chunk end states.
    decay_states = torch.exp(cum[:, :, -1:, :] - cum)         # [b,z,c,h]
    states = _einsum("bzcn,bzch,bzchp->bzhpn", Bc, (decay_states * dtc).to(x.dtype), xc)

    # Inter-chunk recurrence state_z = decay_z * state_{z-1} + states_z, kept
    # exclusive: prev[z] is the state entering chunk z.
    chunk_decay = torch.exp(cum[:, :, -1, :])                 # [b,z,h]
    if x.is_meta:  # shapes only: the recurrence keeps the states' shape and dtype
        prev, final_state = torch.empty_like(states), torch.empty_like(states[:, 0])
    else:
        carry = torch.zeros_like(states[:, 0])
        prev = []
        for zi in range(z):
            prev.append(carry)
            carry = carry * chunk_decay[:, zi, :, None, None].to(carry.dtype) + states[:, zi]
        final_state = carry                                   # [b,h,p,n]
        prev = torch.stack(prev, dim=1)

    y_off = _einsum("bzin,bzhpn,bzih->bzihp", Cc, prev, torch.exp(cum).to(x.dtype))
    y = (y_diag + y_off).reshape(b, s, h, p)
    return y, final_state


def mamba2_forward(p: Mamba2, x, cfg, *, return_cache=False):
    """Train/prefill. x: [B, S, d_model].

    Sequences that are not a multiple of ssm_chunk are padded with dt=0 steps:
    exp(0*A)=1 and dt*B(x)x=0, so padding neither decays nor perturbs the
    state: the returned final_state is exact for the true length.
    """
    b, s, _ = x.shape
    h, pdim, n, g = cfg.ssm_heads, cfg.ssm_head_dim, cfg.ssm_state_dim, cfg.ssm_n_groups
    z, xbc_raw, dt_raw = _split_proj(cfg, dense(p.in_proj, x))
    xbc = _causal_conv(p.conv_w, p.conv_b, xbc_raw)
    sp = s + (-s) % cfg.ssm_chunk
    pad = sp - s
    xbc_p = F.pad(xbc, (0, 0, 0, pad))
    dt_raw_p = F.pad(dt_raw, (0, 0, 0, pad))
    xs = xbc_p[..., :cfg.d_inner].reshape(b, sp, h, pdim)
    Bm = xbc_p[..., cfg.d_inner:cfg.d_inner + g * n].reshape(b, sp, n)
    Cm = xbc_p[..., cfg.d_inner + g * n:].reshape(b, sp, n)
    dt = F.softplus(dt_raw_p.float() + p.dt_bias)
    if pad:
        dt = dt * (torch.arange(sp, device=x.device) < s)[None, :, None]
    A = -torch.exp(p.A_log)

    y, final_state = _ssd_chunked(xs, dt, A, Bm, Cm, cfg.ssm_chunk)
    y = y + p.D[None, None, :, None].to(y.dtype) * xs
    y = y.reshape(b, sp, cfg.d_inner)[:, :s]
    y = rms_norm(p.norm, y * silu(z), cfg.norm_eps)
    out = dense(p.out_proj, y)
    if return_cache:
        # The last k-1 pre-activation conv inputs (zeros before the start).
        k = cfg.conv_kernel
        conv_state = F.pad(xbc_raw, (0, 0, k - 1, 0))[:, s:s + k - 1]
        return out, {"conv": conv_state, "ssm": final_state}
    return out


def mamba2_decode(p: Mamba2, x, cache, cfg):
    """One-token recurrence. x: [B, 1, d_model]; cache: {"conv","ssm"}."""
    b = x.shape[0]
    h, pdim, n, g = cfg.ssm_heads, cfg.ssm_head_dim, cfg.ssm_state_dim, cfg.ssm_n_groups
    z, xbc_new, dt_raw = _split_proj(cfg, dense(p.in_proj, x))

    # conv cache: [B, k-1, conv_dim] of pre-activation inputs.
    window = torch.cat([cache["conv"], xbc_new], dim=1)  # [B, k, conv_dim]
    conv_out = silu(_einsum("bkc,kc->bc", window, p.conv_w) + p.conv_b)[:, None, :]
    new_conv = window[:, 1:]

    xs = conv_out[..., :cfg.d_inner].reshape(b, h, pdim)
    Bm = conv_out[..., cfg.d_inner:cfg.d_inner + g * n].reshape(b, n)
    Cm = conv_out[..., cfg.d_inner + g * n:].reshape(b, n)
    dt = F.softplus(dt_raw[:, 0].float() + p.dt_bias)  # [B, h]
    A = -torch.exp(p.A_log)

    dA = torch.exp(dt * A[None, :])                                # [B, h]
    state = cache["ssm"] * dA[..., None, None].to(cache["ssm"].dtype)
    state = state + _einsum("bn,bh,bhp->bhpn", Bm, dt.to(x.dtype), xs)
    y = _einsum("bn,bhpn->bhp", Cm, state)
    y = y + p.D[None, :, None].to(y.dtype) * xs
    y = y.reshape(b, 1, cfg.d_inner)
    y = rms_norm(p.norm, y * silu(z), cfg.norm_eps)
    return dense(p.out_proj, y), {"conv": new_conv, "ssm": state}

