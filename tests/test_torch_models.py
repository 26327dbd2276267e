"""The port's LM stack (repro_torch.configs, repro_torch.models) against
repro's, on the CPU.

Parameters are the reference's tree (its init's shapes and dtypes) filled
from a numpy seed, converted to the port by `convert.model_params_from_jax`;
inputs come from numpy. fp32 runs upcast the parameters in both packages and
hold at rtol 1e-4 / atol 1e-5; bf16 runs hold at the reference's own
smoke-test tolerance, 2e-2 / 2e-2. Each hazard of the port (RoPE in float32,
GQA grouping, the Q-blocked form, clamped cache writes, tanh gelu, MoE
routing, ties and drops, MLA, the SSD chunk recurrence, Mamba padding and
caches) has a case of its own against the reference function.
"""

import dataclasses
import os
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from model_cases import BF16, F32, close, f32, ref_params, to_port, upcast
from repro.configs import base as ref_base
from repro.configs import shapes as ref_shapes
from repro.models import layers as RL
from repro.models import mamba2 as RMB
from repro.models import mla as RM
from repro.models import model_zoo as RZ
from repro.models import transformer as RT
from repro_torch import convert
from repro_torch.configs import base as port_base
from repro_torch.configs import shapes as port_shapes
from repro_torch.models import layers as PL
from repro_torch.models import mamba2 as PMB
from repro_torch.models import mla as PM
from repro_torch.models import model_zoo as PZ
from repro_torch.models import transformer as PT

ROOT = Path(__file__).resolve().parent.parent
ARCHS = ref_base.ARCH_IDS
B, S = 2, 32


@pytest.fixture(autouse=True)
def _no_grad():
    with torch.no_grad():
        yield


def t(a, dtype=None) -> torch.Tensor:
    """numpy / jax array -> CPU tensor (bf16 through float32, exactly)."""
    a = np.asarray(jnp.asarray(a).astype(jnp.float32) if str(np.asarray(a).dtype) == "bfloat16" else a)
    x = torch.from_numpy(np.array(a))
    return x if dtype is None else x.to(dtype)


# ---------------------------------------------------------------------------
# configs
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("arch", ARCHS)
def test_configs_equal_reference(arch):
    for get in ("get_config", "get_smoke_config"):
        ref, port = getattr(ref_base, get)(arch), getattr(port_base, get)(arch)
        assert dataclasses.asdict(port) == dataclasses.asdict(ref), (arch, get)
        assert PT.decoder_plan(port) == RT.decoder_plan(ref)
    full = port_base.get_config(arch)
    assert [s.name for s in port_shapes.shapes_for(full)] == [
        s.name for s in ref_shapes.shapes_for(ref_base.get_config(arch))]
    assert [dataclasses.astuple(s) for s in port_shapes.ALL_SHAPES] == [
        dataclasses.astuple(s) for s in ref_shapes.ALL_SHAPES]


def test_registry_loads_no_reference_module():
    """The registry names modules by string, which the AST import check cannot see."""
    code = (
        "import sys; from repro_torch.configs import base;"
        "[base.get_config(a) for a in base.ARCH_IDS]; [base.get_smoke_config(a) for a in base.ARCH_IDS];"
        "base.get_config('qwen2-7b').param_count();"
        "bad = sorted(m for m in sys.modules if m.split('.')[0] in ('jax', 'jaxlib', 'repro'));"
        "print(bad); sys.exit(1 if bad else 0)"
    )
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    res = subprocess.run([sys.executable, "-c", code], env=env, capture_output=True, text=True, timeout=120)
    assert res.returncode == 0, res.stdout + res.stderr


@pytest.mark.parametrize("arch", ARCHS)
def test_param_count_and_flops_equal_reference(arch):
    """Full configs, on the meta device (nothing is allocated)."""
    ref, port = ref_base.get_config(arch), port_base.get_config(arch)
    for active in (False, True):
        n = PZ.count_params_analytic(port, active_only=active)
        assert type(n) is int and n == RZ.count_params_analytic(ref, active_only=active), active
    assert port.param_count() == ref.param_count()
    assert PZ.count_embedding_params(port) == RZ.count_embedding_params(ref)
    for shape in ref_shapes.ALL_SHAPES:
        assert PZ.model_flops(port, shape) == RZ.model_flops(ref, shape), shape.name


def test_init_params_shapes_dtypes_and_values():
    cfg = port_base.get_smoke_config("jamba-v0.1-52b")
    ref = jax.device_get(ref_params(ref_base.get_smoke_config("jamba-v0.1-52b")))
    model = PZ.init_params(cfg, seed=3, device="cpu")
    again = PZ.init_params(cfg, seed=3, device="cpu")
    conv = convert.model_params_from_jax(cfg, ref, "cpu")
    got = dict(model.named_parameters())
    for name, p in conv.named_parameters():
        assert got[name].shape == p.shape and got[name].dtype == p.dtype, name
        assert torch.equal(got[name], dict(again.named_parameters())[name]), name
    assert got["groups.0.0.sub0.mamba.A_log"].dtype == torch.float32
    assert got["groups.0.0.sub0.ln1.scale"].dtype == torch.bfloat16
    assert torch.all(got["groups.0.0.sub0.mamba.dt_bias"] == -2.0)
    w = got["embed"].float()
    assert abs(w.std().item() - 0.02) < 1e-3 and abs(w.mean().item()) < 1e-3
    assert sum(p.numel() for p in model.parameters()) == PZ.count_params_analytic(cfg)


# ---------------------------------------------------------------------------
# every arch: train, prefill (logits and caches), decode
# ---------------------------------------------------------------------------


def batch_np(cfg):
    rng = np.random.default_rng(0)
    st = S - cfg.num_patches if cfg.has_vision_stub else S
    b = {"tokens": rng.integers(0, cfg.vocab_size, (B, st)).astype(np.int32)}
    if cfg.has_vision_stub:
        b["patch_embeds"] = rng.normal(size=(B, cfg.num_patches, cfg.d_model)).astype(np.float32)
    if cfg.is_encoder_decoder:
        b["frames"] = rng.normal(size=(B, 16, cfg.d_model)).astype(np.float32)
    return b


def exact(fn, *args):
    """fn compiled with every bf16 rounding the source writes (XLA may
    otherwise keep fused intermediates in fp32)."""
    return jax.jit(fn).lower(*args).compile(compiler_options={"xla_allow_excess_precision": False})(*args)


def run_reference(cfg, params, bn):
    """train forward, prefill(S-1) with the cache padded for one more token,
    one decode step with the last token: the reference smoke test's protocol."""
    rb = {k: jnp.asarray(v) for k, v in bn.items()}
    n_prefix = cfg.num_patches if cfg.has_vision_stub else 0
    st = bn["tokens"].shape[1]
    logits, aux = exact(lambda p, b: RZ.apply_train(cfg, p, b), params, rb)
    pre = dict(rb, tokens=rb["tokens"][:, :st - 1])
    pre_logits, caches = exact(lambda p, b: RZ.apply_prefill(cfg, p, b, cache_pad_to=st + n_prefix), params, pre)
    dec, _ = exact(lambda p, t, c, n: RZ.apply_decode(cfg, p, t, c, n), params, rb["tokens"][:, st - 1:], caches,
                   jnp.asarray(st - 1 + n_prefix, jnp.int32))
    return jax.device_get(dict(train=logits, aux=aux, prefill=pre_logits, caches=caches, decode=dec))


def run_port(cfg, model, bn):
    pb = {k: torch.from_numpy(v) for k, v in bn.items()}
    n_prefix = cfg.num_patches if cfg.has_vision_stub else 0
    st = bn["tokens"].shape[1]
    logits, aux = PZ.apply_train(cfg, model, pb)
    pre_logits, caches = PZ.apply_prefill(cfg, model, dict(pb, tokens=pb["tokens"][:, :st - 1]),
                                          cache_pad_to=st + n_prefix)
    dec, _ = PZ.apply_decode(cfg, model, pb["tokens"][:, st - 1:], caches, st - 1 + n_prefix)
    return dict(train=logits, aux=aux, prefill=pre_logits, caches=convert.caches_to_numpy(caches), decode=dec)


@pytest.mark.parametrize("dtype", ["fp32", "bf16"])
@pytest.mark.parametrize("arch", ARCHS)
def test_arch_matches_reference(arch, dtype):
    ref_cfg, cfg = ref_base.get_smoke_config(arch), port_base.get_smoke_config(arch)
    params = ref_params(ref_cfg)
    if dtype == "fp32":
        params = upcast(params)
    tol = F32 if dtype == "fp32" else BF16
    bn = batch_np(cfg)
    exp = run_reference(ref_cfg, params, bn)
    got = run_port(cfg, to_port(cfg, params), bn)
    for key in ("train", "aux", "prefill", "decode"):
        assert got[key].dtype == (torch.float32 if dtype == "fp32" or key == "aux" else torch.bfloat16), key
        close(got[key], exp[key], tol, f"{arch} {dtype} {key}")
    exp_leaves = jax.tree_util.tree_leaves_with_path(exp["caches"])
    got_leaves = jax.tree_util.tree_leaves_with_path(got["caches"])
    assert [p for p, _ in got_leaves] == [p for p, _ in exp_leaves]
    for (path, g), (_, e) in zip(got_leaves, exp_leaves):
        assert g.shape == e.shape, path
        close(g, e, tol, f"{arch} {dtype} cache {jax.tree_util.keystr(path)}")
    # decode from the reference's own caches, carried over
    ref_caches = convert.caches_from_jax(exp["caches"], "cpu")
    assert all(np.array_equal(f32(a), f32(b)) for a, b in zip(
        jax.tree_util.tree_leaves(convert.caches_to_numpy(ref_caches)), jax.tree_util.tree_leaves(exp["caches"])))
    n_prefix = cfg.num_patches if cfg.has_vision_stub else 0
    st = bn["tokens"].shape[1]
    dec, _ = PZ.apply_decode(cfg, to_port(cfg, params), torch.from_numpy(bn["tokens"][:, st - 1:]), ref_caches,
                             st - 1 + n_prefix)
    close(dec, exp["decode"], tol, f"{arch} {dtype} decode from the reference's caches")


def test_fp32_audio_encoder_runs_where_the_reference_raises():
    """The reference's _encode casts the frames to bf16; with fp32 encoder
    weights its first sublayer returns fp32 and lax.scan rejects the carry.
    The port's loop has no carry type and runs (fp32 parity above keeps
    that encoder in bf16 in both)."""
    ref_cfg, cfg = ref_base.get_smoke_config("seamless-m4t-medium"), port_base.get_smoke_config("seamless-m4t-medium")
    tree = jax.tree.map(lambda a: a.astype(jnp.float32), ref_params(ref_cfg))
    bn = batch_np(cfg)
    with pytest.raises(TypeError, match="carry"):
        RZ.apply_train(ref_cfg, tree, {k: jnp.asarray(v) for k, v in bn.items()})
    logits, _ = PZ.apply_train(cfg, to_port(cfg, tree), {k: torch.from_numpy(v) for k, v in bn.items()})
    assert logits.dtype == torch.float32 and bool(torch.isfinite(logits).all())


# ---------------------------------------------------------------------------
# the hazards, function by function (fp32)
# ---------------------------------------------------------------------------


def jit(fn):
    """The reference function compiled once (eager dispatch compiles op by op)."""
    return jax.jit(fn)


def rnd(seed, *shape, scale=1.0):
    return (np.random.default_rng(seed).standard_normal(shape) * scale).astype(np.float32)


@pytest.fixture(scope="module")
def units():
    """fp32 reference parameters and the converted port model, per smoke arch."""
    cache = {}

    def get(arch):
        if arch not in cache:
            ref_cfg, cfg = ref_base.get_smoke_config(arch), port_base.get_smoke_config(arch)
            tree = upcast(ref_params(ref_cfg, seed=1))
            cache[arch] = (ref_cfg, cfg, tree, to_port(cfg, tree))
        return cache[arch]

    return get


def ref_sub(tree, group, unit, sub):
    return jax.tree.map(lambda a: a[unit], tree["groups"][group])[sub]


@pytest.mark.parametrize("theta", [1e4, 1e6])
def test_rope_matches_reference_at_large_positions(theta):
    """freqs in numpy float32: a float64 theta ** e rounded to float32 moves
    the last bit of some freqs, and positions near 2^19 magnify that."""
    x = rnd(0, 2, 9, 3, 128)
    pos = np.array([0, 1, 7, 4095, 65539, (1 << 19) - 7, (1 << 19) - 1, 1 << 19, (1 << 19) + 5], np.int32)
    ref = jit(lambda x, p: RL.rope(x, p, theta))
    close(PL.rope(t(x), t(pos), theta), ref(x, pos), F32)
    pos2 = np.stack([pos, pos[::-1]])  # [B, S] positions
    close(PL.rope(t(x), t(pos2), theta), ref(x, pos2), F32)


@pytest.mark.parametrize("kv", [1, 2, 4, 8])
def test_sdpa_grouped_query_attention(kv):
    """Query head h reads KV head h // (H / KV): repeat_interleave, not repeat."""
    q, k, v = rnd(1, 2, 5, 8, 16), rnd(2, 2, 7, kv, 16), rnd(3, 2, 7, kv, 16)
    mask = np.random.default_rng(4).random((2, 1, 5, 7)) < 0.7
    mask[..., 0] = True
    close(PL._sdpa(t(q), t(k), t(v), t(mask)), jit(RL._sdpa)(q, k, v, mask), F32)


@pytest.mark.parametrize("window", [0, 5])
def test_q_blocked_attention(monkeypatch, window, units):
    """The Q-blocked form (s > threshold, s % Q_BLOCK == 0) with both
    packages' threshold and block made small."""
    for mod in (RL, PL):
        monkeypatch.setattr(mod, "BLOCKED_ATTN_THRESHOLD", 16)
        monkeypatch.setattr(mod, "Q_BLOCK", 8)
    ref_cfg, cfg, tree, model = units("qwen2-7b")
    x = rnd(5, 2, 32, cfg.d_model)
    kw = dict(num_heads=cfg.num_heads, num_kv_heads=cfg.num_kv_heads, head_dim=cfg.resolved_head_dim,
              theta=cfg.rope_theta, window=window)
    got = PL.attention(model.groups[0][1]["sub0"].attn, t(x), torch.arange(32), **kw)
    exp = jit(lambda p, x: RL.attention(p, x, jnp.arange(32), **kw))(ref_sub(tree, 0, 1, "sub0")["attn"], x)
    close(got, exp, F32)


@pytest.mark.parametrize("window", [0, 3])
@pytest.mark.parametrize("cache_len", [0, 5, 7, 8, 11])
def test_attention_decode_clamps_the_cache_write(cache_len, window, units):
    """s_max = 8: at cache_len >= 8 the write lands in the last slot (the
    reference's dynamic_update_slice clamps) while the mask admits all."""
    ref_cfg, cfg, tree, model = units("qwen2-7b")
    kw = dict(num_heads=cfg.num_heads, num_kv_heads=cfg.num_kv_heads, head_dim=cfg.resolved_head_dim,
              theta=cfg.rope_theta, window=window)
    x = rnd(6, 2, 1, cfg.d_model)
    cache = {"k": rnd(7, 2, 8, cfg.num_kv_heads, 16), "v": rnd(8, 2, 8, cfg.num_kv_heads, 16)}
    got, got_c = PL.attention_decode(model.groups[0][0]["sub0"].attn, t(x), {n: t(a) for n, a in cache.items()},
                                     cache_len, **kw)
    exp, exp_c = jit(lambda p, x, c, n: RL.attention_decode(p, x, c, n, **kw))(
        ref_sub(tree, 0, 0, "sub0")["attn"], x, cache, np.int32(cache_len))
    close(got, exp, F32)
    for n in ("k", "v"):
        close(got_c[n], exp_c[n], F32, n)


@pytest.mark.parametrize("s_max", [200, 100_001])
def test_decode_sliding_window_only_past_100k_slots(s_max, units):
    """jamba's attention sublayer (window 64) at decode: the window applies
    only to a cache of more than 100_000 slots."""
    ref_cfg, cfg, tree, model = units("jamba-v0.1-52b")
    x = rnd(31, 1, 1, cfg.d_model)
    cache = {"attn": {"k": rnd(32, 1, s_max, cfg.num_kv_heads, 16), "v": rnd(33, 1, s_max, cfg.num_kv_heads, 16)}}
    got, got_c, _ = PT.sublayer_apply(cfg, model.groups[0][0]["sub4"], t(x), None, "decode",
                                      cache={"attn": {n: t(a) for n, a in cache["attn"].items()}}, cache_len=150)
    exp, exp_c, _ = jit(lambda p, x, c, n: RT.sublayer_apply(ref_cfg, p, x, None, "decode", cache=c, cache_len=n))(
        ref_sub(tree, 0, 0, "sub4"), x, cache, np.int32(150))
    close(got, exp, F32)
    close(got_c["attn"]["k"][:, 140:160], exp_c["attn"]["k"][:, 140:160], F32)


@pytest.mark.parametrize("act", ["silu", "gelu"])
def test_mlp_activations(act):
    """gelu is jax.nn.gelu's default, the tanh approximation."""
    d, f = 16, 32
    w = {"w_up": rnd(9, d, f, scale=0.5), "w_down": rnd(10, f, d, scale=0.5)}
    if act == "silu":
        w["w_gate"] = rnd(11, d, f, scale=0.5)
    ref = {n: {"w": jnp.asarray(a)} for n, a in w.items()}
    port = PL.MLP(PL.Init("cpu", torch.float32, torch.Generator().manual_seed(0)), d, f, act)
    for n, a in w.items():
        getattr(port, n).w.data = t(a)
    x = rnd(12, 3, 4, d, scale=2.0)
    close(PL.mlp(port, t(x), act), jit(lambda p, x: RL.mlp(p, x, act))(ref, x), F32)


@pytest.mark.parametrize("act", ["silu", "gelu"])
def test_activations_round_like_the_reference_in_bf16(act):
    """In bf16 each operation of jax.nn.silu and jax.nn.gelu rounds (the
    reference compiled as written); the port's are written op by op and
    agree bit for bit, where F.silu and F.gelu round once."""
    xb = jnp.asarray(rnd(40, 1 << 14, scale=3.0), jnp.bfloat16)
    exp = exact(jax.nn.silu if act == "silu" else jax.nn.gelu, xb)
    got = (PL.silu if act == "silu" else PL.gelu)(t(xb, torch.bfloat16))
    np.testing.assert_array_equal(f32(got), f32(exp))


def moe_case(kind, d=16, e=4):
    """Router, experts and tokens for one MoE case."""
    router = rnd(13, d, e, scale=0.3)
    if kind == "ties":
        # Two zero columns and two live ones: many tokens tie at logit 0,
        # where lax.top_k takes the lower index.
        router[:, [0, 2]] = 0.0
    return dict(router=router, w_gate=rnd(14, e, d, 8, scale=0.3), w_up=rnd(15, e, d, 8, scale=0.3),
                w_down=rnd(16, e, 8, d, scale=0.3), x=rnd(17, 2, 32, d))


@pytest.mark.parametrize("kind,top_k,cf,shared", [  # cf 0.25 at top-1: capacity 4, floored at 8
    ("dropless", 2, 4.0, False), ("dropping", 2, 0.5, False), ("dropping", 3, 0.25, True),
    ("dropping", 1, 0.25, False), ("ties", 2, 4.0, False), ("ties", 1, 0.5, True)])
def test_moe_routing_dispatch_and_aux(kind, top_k, cf, shared):
    c = moe_case(kind)
    d, e = c["router"].shape
    port = PL.MoE(PL.Init("cpu", torch.float32, torch.Generator().manual_seed(0)), d, e, 8,
                  num_shared=int(shared), shared_d_ff=8)
    ref = {"router": {"w": jnp.asarray(c["router"])},
           **{n: jnp.asarray(c[n]) for n in ("w_gate", "w_up", "w_down")}}
    port.router.w.data = t(c["router"])
    for n in ("w_gate", "w_up", "w_down"):
        getattr(port, n).data = t(c[n])
    if shared:
        ref["shared"] = {n: {"w": jnp.asarray(getattr(port.shared, n).w.numpy())}
                         for n in ("w_gate", "w_up", "w_down")}
    got, got_aux = PL.moe(port, t(c["x"]), num_experts=e, top_k=top_k, capacity_factor=cf)
    exp, exp_aux = jit(lambda p, x: RL.moe(p, x, num_experts=e, top_k=top_k, capacity_factor=cf))(ref, c["x"])
    close(got, exp, F32)
    close(got_aux, exp_aux, F32, "aux")


@pytest.mark.parametrize("cache_len", [None, 5, 7, 8, 10])
def test_mla_prefill_and_absorbed_decode(cache_len, units):
    """None: the naive prefill with its padded latent cache; else one
    absorbed decode step over an 8-slot latent cache (clamped write at >= 8)."""
    ref_cfg, cfg, tree, model = units("deepseek-v3-671b")
    pm, rm = model.groups[1][0]["sub0"].mla, ref_sub(tree, 1, 0, "sub0")["mla"]
    if cache_len is None:
        x = rnd(18, 2, 6, cfg.d_model)
        got, got_c = PM.mla_attention(pm, t(x), torch.arange(6), cfg, return_cache=True, cache_pad_to=9)
        (exp, exp_c), exp_train = jit(lambda p, x: (
            RM.mla_attention(p, x, jnp.arange(6), ref_cfg, return_cache=True, cache_pad_to=9),
            RM.mla_attention(p, x, jnp.arange(6), ref_cfg)))(rm, x)
        close(PM.mla_attention(pm, t(x), torch.arange(6), cfg), exp_train, F32, "train")
    else:
        x = rnd(19, 2, 1, cfg.d_model)
        cache = {"c_kv": rnd(20, 2, 8, cfg.kv_lora_rank), "k_pe": rnd(21, 2, 8, cfg.qk_rope_head_dim)}
        got, got_c = PM.mla_decode(pm, t(x), {n: t(a) for n, a in cache.items()}, cache_len, cfg)
        exp, exp_c = jit(lambda p, x, c, n: RM.mla_decode(p, x, c, n, ref_cfg))(rm, x, cache, np.int32(cache_len))
    close(got, exp, F32)
    for n in ("c_kv", "k_pe"):
        close(got_c[n], exp_c[n], F32, n)


@pytest.mark.parametrize("s,chunk", [(64, 16), (48, 48)])
def test_ssd_chunked(s, chunk):
    """Four chunks carry the state from chunk to chunk; one chunk carries none."""
    x, b_, c_ = rnd(22, 2, s, 4, 8), rnd(23, 2, s, 16, scale=0.5), rnd(24, 2, s, 16, scale=0.5)
    dt = np.abs(rnd(25, 2, s, 4, scale=0.3))
    a = -np.exp(rnd(26, 4, scale=0.5))
    got_y, got_s = PMB._ssd_chunked(t(x), t(dt), t(a), t(b_), t(c_), chunk)
    exp_y, exp_s = jit(lambda *a: RMB._ssd_chunked(*a, chunk))(x, dt, a, b_, c_)
    close(got_y, exp_y, F32, "y")
    close(got_s, exp_s, F32, "state")


@pytest.mark.parametrize("s", [2, 21, 32, 45])
def test_mamba2_forward_padding_and_cache(s, units):
    """chunk 32: s = 21 and 45 pad with dt = 0 steps; s = 2 < k - 1 leaves
    zeros in the conv state."""
    ref_cfg, cfg, tree, model = units("mamba2-780m")
    pm, rm = model.groups[0][1]["sub0"].mamba, ref_sub(tree, 0, 1, "sub0")["mamba"]
    x = rnd(27, 2, s, cfg.d_model)
    got, got_c = PMB.mamba2_forward(pm, t(x), cfg, return_cache=True)
    exp, exp_c = jit(lambda p, x: RMB.mamba2_forward(p, x, ref_cfg, return_cache=True))(rm, x)
    close(got, exp, F32)
    for n in ("conv", "ssm"):
        close(got_c[n], exp_c[n], F32, n)


def test_mamba2_decode_recurrence(units):
    ref_cfg, cfg, tree, model = units("mamba2-780m")
    pm, rm = model.groups[0][0]["sub0"].mamba, ref_sub(tree, 0, 0, "sub0")["mamba"]
    conv_dim = cfg.d_inner + 2 * cfg.ssm_n_groups * cfg.ssm_state_dim
    x = rnd(28, 2, 1, cfg.d_model)
    cache = {"conv": rnd(29, 2, cfg.conv_kernel - 1, conv_dim),
             "ssm": rnd(30, 2, cfg.ssm_heads, cfg.ssm_head_dim, cfg.ssm_state_dim, scale=0.3)}
    got, got_c = PMB.mamba2_decode(pm, t(x), {n: t(a) for n, a in cache.items()}, cfg)
    exp, exp_c = jit(lambda p, x, c: RMB.mamba2_decode(p, x, c, ref_cfg))(rm, x, cache)
    close(got, exp, F32)
    for n in ("conv", "ssm"):
        close(got_c[n], exp_c[n], F32, n)
