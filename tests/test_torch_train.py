"""The port's training path (repro_torch.optim, repro_torch.train.steps,
rematerialisation, repro_torch.launch.train) against repro's, on the CPU.

Parameters are the reference's tree filled from a numpy seed
(tests/model_cases.py), converted to the port; inputs, gradients and
moments come from numpy. Tolerances:

* fp32: the step's metrics at rtol 1e-5; every updated parameter and both
  moments at 1e-4 of the leaf's largest magnitude (max |port - ref| <=
  1e-4 max |ref|). The step's AdamConfig has eps = 1e-6: with the default
  1e-8, an element whose gradient is at fp32 noise (~1e-9 here) has an update
  g / (|g| + eps) of either sign, which moves one parameter by 2 lr. The
  audio encoder's leaves stay bf16 (model_cases.KEEP_BF16) and are held at
  the bf16 tolerance.
* bf16 (one dense, one MoE, one hybrid SSM, one MLA arch): metrics at rtol
  2e-2, every leaf at model_cases.BF16 (rtol 2e-2, atol 2e-2), the
  reference's own smoke-test tolerance.
* AdamW alone, on numpy trees: grad_norm at rtol 1e-5 (sums of ~1e5
  squares in two orders), lr at 1e-7, every leaf at 1e-5 of its magnitude
  (the clip factor carries grad_norm's error), bf16 leaves one rounding
  apart.

The reference's steps are compiled with xla_allow_excess_precision=False,
as test_torch_models.py compiles them.
"""

import functools
import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode

from model_cases import BF16, KEEP_BF16, f32, one_device_mesh, ref_params, to_port, upcast
from repro.configs import base as ref_base
from repro.launch import train as ref_train
from repro.models import model_zoo as RZ
from repro.optim import adam as RA
from repro.train import steps as RS
from repro_torch import convert
from repro_torch.configs import base as port_base
from repro_torch.launch import train as port_train
from repro_torch.models import model_zoo as PZ
from repro_torch.optim import adam as PA
from repro_torch.train import steps as PS
from repro_torch.train.options import PerfOptions

ARCHS = ref_base.ARCH_IDS
BF16_ARCHS = ("stablelm-1.6b", "olmoe-1b-7b", "jamba-v0.1-52b", "deepseek-v3-671b")
B, S = 2, 32
STEP_CFG = dict(lr=1e-3, eps=1e-6, warmup_steps=2, total_steps=10)


def exact(fn, *args):
    return jax.jit(fn).lower(*args).compile(compiler_options={"xla_allow_excess_precision": False})(*args)


def leaves(tree):
    """keystr -> (leaf as float32 numpy, whether the leaf is bf16)."""
    return {jax.tree_util.keystr(p): (np.asarray(f32(x)), str(np.asarray(x).dtype) == "bfloat16")
            for p, x in jax.tree_util.tree_leaves_with_path(tree)}


def assert_trees_close(got, exp, what, tol, bf16_tol):
    """Leaf by leaf. A float tolerance is relative to the leaf's largest
    magnitude (max |got - exp| <= tol * max |exp|), a dict is elementwise
    (assert_allclose). Leaves that are bf16 in `exp`, and every leaf of the
    audio encoder (bf16 whatever the run, model_cases.KEEP_BF16; its moments
    follow its bf16 gradients), are held at `bf16_tol`."""
    g, e = leaves(got), leaves(exp)
    assert sorted(g) == sorted(e), what
    for k, (x, is_bf16) in e.items():
        t = bf16_tol if is_bf16 or any(k.startswith(f"['{kb}']") for kb in KEEP_BF16) else tol
        if isinstance(t, dict):
            np.testing.assert_allclose(g[k][0], x, err_msg=f"{what} {k}", **t)
        else:
            err = np.abs(g[k][0] - x).max() if x.size else 0.0
            assert err <= t * np.abs(x).max(), f"{what} {k}: max err {err} > {t} x {np.abs(x).max()}"


# grad_norm: fp32 sums of ~1e5 squares, reduced in XLA's order and in torch's.
GNORM_RTOL = 1e-5
# One bf16 rounding apart: an ulp is at most 2^-7 of the leaf's largest magnitude.
ONE_ROUNDING = 2.0 ** -7


# ---------------------------------------------------------------------------
# AdamW
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("arch", ARCHS)
def test_decay_rule_follows_reference_rank(arch):
    """A leaf decays iff its stacked reference leaf has rank >= 2: every
    parameter inside a group (norm scales, biases, A_log, D, dt_bias), and of
    the top-level ones only the matrices (not final_norm / enc_final_norm /
    vision_proj's bias)."""
    ref_cfg, cfg = ref_base.get_smoke_config(arch), port_base.get_smoke_config(arch)
    shapes = jax.eval_shape(lambda k: RZ.init_params(ref_cfg, k), jax.random.PRNGKey(0))
    model = PZ.init_params(cfg, device="meta")
    kinds = set()
    for name, p in model.named_parameters():
        key, _ = PA.stacked_key(name)
        ref_leaf = functools.reduce(lambda node, k: node[k], key, shapes)
        assert PA.decays(name, p) == (ref_leaf.ndim >= 2), name
        kinds.add((key[-1], PA.decays(name, p)))
    assert ("scale", True) in kinds and ("scale", False) in kinds
    if cfg.family in ("ssm", "hybrid"):
        assert {("A_log", True), ("D", True), ("dt_bias", True)} <= kinds


def numpy_tree(rng, like, scale):
    return jax.tree.map(lambda s: (scale * rng.standard_normal(s.shape)).astype(s.dtype), like)


ADAM_CASES = {
    # warmup from zero moments; small gradients (no clipping)
    "warmup": dict(cfg=dict(warmup_steps=4, total_steps=8), step0=0, grad_scale=1e-4, moments=jnp.float32),
    # from random moments at step 5: cosine decay, clipped gradients
    "cosine_clip": dict(cfg=dict(warmup_steps=4, total_steps=8), step0=5, grad_scale=1.0, moments=jnp.float32),
    "cosine_clip_bf16_moments": dict(cfg=dict(warmup_steps=4, total_steps=8), step0=5, grad_scale=1.0,
                                     moments=jnp.bfloat16),
}


@functools.lru_cache(maxsize=None)
def _ref_adam(cfg):
    return jax.jit(functools.partial(RA.adam_update, cfg))


@pytest.mark.parametrize("case", list(ADAM_CASES))
@pytest.mark.parametrize("arch", ARCHS)
def test_adam_update_matches_reference(arch, case):
    """Two AdamW steps on the arch's parameter tree (every leaf kind) from
    numpy-seeded moments and gradients: parameters, both moments, the step,
    grad_norm and lr."""
    c = ADAM_CASES[case]
    ref_cfg, cfg = ref_base.get_smoke_config(arch), port_base.get_smoke_config(arch)
    rcfg = RA.AdamConfig(moment_dtype=c["moments"], **c["cfg"])
    pcfg = PA.AdamConfig(moment_dtype=torch.bfloat16 if c["moments"] == jnp.bfloat16 else torch.float32, **c["cfg"])
    params = ref_params(ref_cfg)
    rng = np.random.default_rng(7)
    mom = jax.tree.map(lambda p: jax.ShapeDtypeStruct(p.shape, c["moments"]), params)
    state = RA.AdamState(
        m=numpy_tree(rng, mom, 1e-3 if c["step0"] else 0.0),
        v=jax.tree.map(lambda a: np.abs(a) * 1e-3, numpy_tree(rng, mom, 1e-3 if c["step0"] else 0.0)),
        step=np.int32(c["step0"]))
    grads = [numpy_tree(rng, params, c["grad_scale"]) for _ in range(2)]

    model = to_port(cfg, params)
    pstate = convert.adam_state_from_jax(cfg, jax.device_get(state), "cpu")
    metrics = []
    for g in grads:
        params, state, rm = _ref_adam(rcfg)(params, g, state)
        pg = PA.named(to_port(cfg, g))  # the gradients by parameter name
        model, pstate, pm = PA.adam_update(pcfg, model, pg, pstate)
        metrics.append((rm, pm))
    for rm, pm in metrics:
        np.testing.assert_allclose(float(pm["grad_norm"]), float(rm["grad_norm"]), rtol=GNORM_RTOL)
        np.testing.assert_allclose(float(pm["lr"]), float(rm["lr"]), rtol=1e-7)
    if c["grad_scale"] == 1.0:
        assert float(metrics[0][1]["grad_norm"]) > pcfg.grad_clip  # clipping is active
    got = convert.adam_state_to_numpy(pstate)
    assert int(got["step"]) == int(state.step) == c["step0"] + 2
    # The clip factor carries grad_norm's error: v moves with its square.
    assert_trees_close(convert.model_params_to_numpy(model), params, "params", 1e-5, ONE_ROUNDING)
    for k in ("m", "v"):
        assert_trees_close(got[k], getattr(state, k), k, 1e-5, ONE_ROUNDING)
    assert all(t.dtype == pcfg.moment_dtype for t in pstate.m.values())


def test_schedule_and_global_norm_match_reference():
    for kw in (dict(), dict(warmup_steps=4, total_steps=8), dict(warmup_steps=0, total_steps=1), dict(lr=1e-2)):
        rcfg, pcfg = RA.AdamConfig(**kw), PA.AdamConfig(**kw)
        for step in (0, 1, 3, 4, 5, 7, 8, 9, 100, 5000, 10_000, 20_000):
            exp = np.float32(RA.schedule(rcfg, jnp.int32(step)))
            got = PA.schedule(pcfg, torch.tensor(step, dtype=torch.int32))
            assert got.dtype == torch.float32
            np.testing.assert_allclose(got.item(), exp, rtol=1e-7, err_msg=f"{kw} step {step}")
    cfg = ref_base.get_smoke_config("jamba-v0.1-52b")
    grads = numpy_tree(np.random.default_rng(3), ref_params(cfg), 1.0)
    model = to_port(port_base.get_smoke_config("jamba-v0.1-52b"), grads)
    np.testing.assert_allclose(PA.global_norm(model).item(), float(RA.global_norm(grads)), rtol=GNORM_RTOL)


# ---------------------------------------------------------------------------
# the loss
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("sharded", [False, True])
def test_softmax_xent_matches_reference(sharded):
    """Both forms, on bf16 logits (cast to fp32 inside), value and gradient;
    and the two forms agree with each other (the reference's equivalence test)."""
    rng = np.random.default_rng(0)
    logits = rng.normal(size=(4, 16, 97)).astype(np.float32) * 4
    labels = rng.integers(0, 97, (4, 16)).astype(np.int32)
    rl = jnp.asarray(logits, jnp.bfloat16)
    exp, exp_g = jax.value_and_grad(lambda x: RS.softmax_xent(x, jnp.asarray(labels), sharded=sharded))(rl)
    x = torch.from_numpy(np.asarray(rl.astype(jnp.float32))).to(torch.bfloat16).requires_grad_()
    got = PS.softmax_xent(x, torch.from_numpy(labels), sharded=sharded)
    got.backward()
    assert got.dtype == torch.float32
    np.testing.assert_allclose(got.item(), float(exp), rtol=1e-6)
    np.testing.assert_allclose(f32(x.grad), f32(exp_g), **BF16)
    lf = torch.from_numpy(logits)
    a = PS.softmax_xent(lf, torch.from_numpy(labels), sharded=False)
    b = PS.softmax_xent(lf, torch.from_numpy(labels), sharded=True)
    np.testing.assert_allclose(a.item(), b.item(), rtol=1e-6)


# ---------------------------------------------------------------------------
# one train step, every arch
# ---------------------------------------------------------------------------


def train_batch(cfg):
    rng = np.random.default_rng(0)
    st = S - cfg.num_patches if cfg.has_vision_stub else S
    b = {"tokens": rng.integers(0, cfg.vocab_size, (B, st)).astype(np.int32),
         "labels": rng.integers(0, cfg.vocab_size, (B, st)).astype(np.int32)}
    if cfg.has_vision_stub:
        b["patch_embeds"] = rng.normal(size=(B, cfg.num_patches, cfg.d_model)).astype(np.float32)
    if cfg.is_encoder_decoder:
        b["frames"] = rng.normal(size=(B, 16, cfg.d_model)).astype(np.float32)
    return b


@functools.lru_cache(maxsize=None)
def reference_step(arch, dtype):
    """The reference's jitted train step, run once per (arch, dtype) and
    shared: (its input parameters, the batch, its outputs)."""
    cfg = ref_base.get_smoke_config(arch)
    params = ref_params(cfg)
    if dtype == "fp32":
        params = upcast(params)
    ocfg = RA.AdamConfig(**STEP_CFG)
    bn = train_batch(cfg)
    rb = {k: jnp.asarray(v) for k, v in bn.items()}
    out = exact(RS.make_train_step(cfg, ocfg), params, RA.adam_init(ocfg, params), rb)
    return jax.device_get(params), bn, jax.device_get(out)


def port_step(arch, params, bn, options=None):
    cfg = port_base.get_smoke_config(arch)
    model = convert.model_params_from_jax(cfg, params, "cpu")
    ocfg = PA.AdamConfig(**STEP_CFG)
    step = PS.make_train_step(cfg, ocfg, options)
    model, opt, metrics = step(model, PA.adam_init(ocfg, model), {k: torch.from_numpy(v) for k, v in bn.items()})
    return model, opt, metrics


@pytest.mark.parametrize("arch,dtype", [(a, "fp32") for a in ARCHS] + [(a, "bf16") for a in BF16_ARCHS])
def test_train_step_matches_reference(arch, dtype):
    params, bn, (exp_p, exp_opt, exp_m) = reference_step(arch, dtype)
    model, opt, metrics = port_step(arch, params, bn)
    rtol = 1e-5 if dtype == "fp32" else 2e-2
    for k in ("loss", "aux_loss", "grad_norm", "lr"):
        assert metrics[k].dtype == torch.float32 and metrics[k].shape == ()
        np.testing.assert_allclose(metrics[k].item(), float(exp_m[k]), rtol=rtol, atol=1e-7, err_msg=k)
    got = convert.adam_state_to_numpy(opt)
    assert int(got["step"]) == int(exp_opt.step) == 1
    tol = 1e-4 if dtype == "fp32" else BF16
    assert_trees_close(convert.model_params_to_numpy(model), exp_p, f"{arch} params", tol, BF16)
    for k in ("m", "v"):  # the encoder's moments are fp32 but follow its bf16 gradients
        assert_trees_close(got[k], getattr(exp_opt, k), f"{arch} {k}", tol, BF16)
    dtypes = {n: p.dtype for n, p in to_port(port_base.get_smoke_config(arch), params).named_parameters()}
    assert {n: p.dtype for n, p in model.named_parameters()} == dtypes


def test_serving_steps_and_init_train_state_match_reference():
    """make_prefill_step / make_decode_step against the reference's (fp32,
    one arch: they wrap apply_prefill / apply_decode, which
    test_torch_models.py holds for every arch), the decode step's
    cache_len + 1, and init_train_state's zero moments at step 0."""
    arch = "qwen2-7b"
    ref_cfg, cfg = ref_base.get_smoke_config(arch), port_base.get_smoke_config(arch)
    params = upcast(ref_params(ref_cfg))
    tokens = train_batch(cfg)["tokens"]
    s = tokens.shape[1]
    exp_pre, caches = exact(RS.make_prefill_step(ref_cfg), params, {"tokens": jnp.asarray(tokens[:, :-1])})
    exp_dec, _, exp_len = exact(RS.make_decode_step(ref_cfg), params, jnp.asarray(tokens[:, -1:]), caches,
                                jnp.asarray(s - 1, jnp.int32))
    model = to_port(cfg, params)
    with torch.no_grad():
        pre, pcaches = PS.make_prefill_step(cfg)(model, {"tokens": torch.from_numpy(tokens[:, :-1])})
        dec, _, n = PS.make_decode_step(cfg)(model, torch.from_numpy(tokens[:, -1:]), pcaches, s - 1)
    np.testing.assert_allclose(f32(pre), f32(exp_pre), rtol=1e-4, atol=1e-5)
    np.testing.assert_allclose(f32(dec), f32(exp_dec), rtol=1e-4, atol=1e-5)
    assert n == int(exp_len) == s
    model, opt = PS.init_train_state(cfg, PA.AdamConfig(moment_dtype=torch.bfloat16), seed=3, device="cpu")
    assert int(opt.step) == 0 and opt.step.dtype == torch.int32
    for name, p in model.named_parameters():
        for moments in (opt.m, opt.v):
            assert moments[name].shape == p.shape and moments[name].dtype == torch.bfloat16
            assert not moments[name].any(), name


# ---------------------------------------------------------------------------
# rematerialisation
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("arch", ARCHS)
def test_remat_policies_give_bit_equal_gradients(arch):
    """"full", "dots" and "none" recompute the same arithmetic: the loss and
    every gradient are bit for bit equal (fp32 and bf16 leaves as the
    reference init makes them)."""
    cfg = port_base.get_smoke_config(arch)
    bn = {k: torch.from_numpy(v) for k, v in train_batch(cfg).items()}
    model = PZ.init_params(cfg, seed=1, device="cpu")
    names, params = zip(*model.named_parameters())
    out = {}
    for policy in ("none", "full", "dots"):
        logits, aux = PZ.apply_train(cfg, model, bn, options=PerfOptions(remat_policy=policy))
        loss = PS.softmax_xent(logits, bn["labels"]) + 0.01 * aux
        out[policy] = (loss, torch.autograd.grad(loss, params, materialize_grads=True))
    for policy in ("full", "dots"):
        assert torch.equal(out[policy][0], out["none"][0]), policy
        for name, g, g0 in zip(names, out[policy][1], out["none"][1]):
            assert torch.equal(g, g0), f"{policy} {name}"


class _CountMM(TorchDispatchMode):
    def __init__(self):
        super().__init__()
        self.mm = 0

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        self.mm += func in (torch.ops.aten.mm.default, torch.ops.aten.addmm.default)
        return func(*args, **(kwargs or {}))


def test_remat_policies_keep_and_recompute_what_they_say():
    """"full" keeps fewer activations for the backward pass than "none" and
    recomputes every unit's matrix products there; "dots" keeps them (its
    backward runs no more products than "none"'s); an unknown policy raises
    ValueError, with or without gradients."""
    cfg = port_base.get_smoke_config("stablelm-1.6b")
    bn = {k: torch.from_numpy(v) for k, v in train_batch(cfg).items()}
    model = PZ.init_params(cfg, seed=1, device="cpu")
    saved, backward_mm = {}, {}
    for policy in ("none", "dots", "full"):
        n = [0]

        def pack(t, n=n):
            n[0] += t.numel() * t.element_size()
            return t

        with torch.autograd.graph.saved_tensors_hooks(pack, lambda t: t):
            logits, _ = PZ.apply_train(cfg, model, bn, options=PerfOptions(remat_policy=policy))
        saved[policy] = n[0]
        with _CountMM() as count:
            logits.float().sum().backward()
        backward_mm[policy] = count.mm
    assert saved["full"] < saved["none"], saved
    assert backward_mm["dots"] == backward_mm["none"] < backward_mm["full"], backward_mm
    for grad in (True, False):
        with torch.set_grad_enabled(grad), pytest.raises(ValueError):
            PZ.apply_train(cfg, model, bn, options=PerfOptions(remat_policy="everything"))


# ---------------------------------------------------------------------------
# the driver
# ---------------------------------------------------------------------------

STEP_LINE = re.compile(r"step\s+(\d+) loss (\S+) gnorm (\S+) lr (\S+) dups (\d+)")


def run_reference_driver(monkeypatch, capsys, params, argv):
    monkeypatch.setattr(RZ, "init_params", lambda cfg, key: jax.tree.map(jnp.asarray, params))
    monkeypatch.setattr(ref_train, "best_fit_mesh", one_device_mesh)
    losses = ref_train.main(argv)
    lines = [STEP_LINE.search(ln) for ln in capsys.readouterr().out.splitlines()]
    return losses, [(int(m.group(1)), int(m.group(5))) for m in lines if m]


@pytest.mark.parametrize("batch,seq", [(2, 16), (8, 1)])
def test_driver_matches_reference(monkeypatch, capsys, tmp_path, batch, seq):
    """Both drivers on the same parameters, each on one device: the logged
    losses within bf16's 2e-2 and every step's duplicate count equal. With 8 documents of one
    token a step, documents repeat, so the dedup index's lookups hit and the
    retry samples replace them."""
    cfg = ref_base.get_smoke_config("stablelm-1.6b")
    params = jax.device_get(ref_params(cfg))
    argv = ["--smoke", "--steps", "4", "--batch", str(batch), "--seq", str(seq), "--log-every", "1"]
    exp_losses, exp_dups = run_reference_driver(monkeypatch, capsys, params,
                                                argv + ["--ckpt-dir", str(tmp_path / "ref")])
    args = port_train.parse_args(argv + ["--ckpt-dir", str(tmp_path / "port"), "--device", "cpu"])
    out = port_train.train(args, port_base.get_smoke_config("stablelm-1.6b"),
                           convert.model_params_from_jax(port_base.get_smoke_config("stablelm-1.6b"), params, "cpu"))
    np.testing.assert_allclose(out["losses"], exp_losses, **BF16)
    assert [(r["step"], r["dups"]) for r in out["log"]] == exp_dups
    if seq == 1:
        assert sum(d for _, d in exp_dups) > 0, exp_dups


def test_entry_point_runs_on_the_card_unless_told_otherwise(tmp_path):
    argv = ["--smoke", "--steps", "2", "--batch", "2", "--seq", "8", "--log-every", "1",
            "--ckpt-dir", str(tmp_path)]
    assert port_train.parse_args(argv).device == "cuda"
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            port_train.main(argv)
    losses = port_train.main(argv + ["--device", "cpu"])
    assert len(losses) == 2 and all(np.isfinite(losses))
