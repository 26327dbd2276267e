"""LM training driver: the train step with remat, the LSM-dedup data
pipeline, and the fault-tolerant supervised loop with checkpoint/restart
(PyTorch counterpart of repro.launch.train).

  python -m repro_torch.launch.train --arch stablelm-1.6b --batch 8 --seq 2048   # full width, on the card
  python -m repro_torch.launch.train --arch stablelm-1.6b --smoke --steps 6 --device cpu

Each step makes a batch on the host (`make_batch`), dedups it against the
LSM of document hashes on the device (`dedup_batch`: the dictionary's
lookup, batch sort and cascade merge), and runs one train step (the loss's
gradient by autograd, every unit rematerialised, then AdamW). The parameters,
the moments and the dedup index live on --device and are updated in place.
The state is laid out by the reference's sharding plan over
`best_fit_mesh` of the driver's one device (`dist.sharding`: every leaf
whole on that device), and `--resume` restores through that plan. The loop
runs under `TrainSupervisor`: every --save-every steps the state
{"params", "opt", "pipe"} is checkpointed (async), and a failing step
(--fail-at injects one) restarts from the newest checkpoint, or from the
state the run started with. `--resume` restores the whole state, the dedup
index included, so a resumed run dedups as an unbroken one.

It prints the reference's lines, each step's time and the peak device
memory; `run` returns them.
"""

from __future__ import annotations

import argparse
import os
import tempfile
import time

import torch

from repro_torch.checkpoint.checkpoint import CheckpointManager, TensorSpec, tree_map
from repro_torch.configs.base import ARCH_IDS, get_config, get_smoke_config
from repro_torch.data.pipeline import PipelineConfig, dedup_batch, make_batch, pipeline_init
from repro_torch.dist import sharding as shd
from repro_torch.dist.fault_tolerance import StragglerMonitor, TrainSupervisor
from repro_torch.launch.mesh import Mesh, make_mesh
from repro_torch.models import model_zoo as zoo
from repro_torch.optim.adam import AdamConfig, AdamState, adam_init
from repro_torch.train.steps import make_train_step


def best_fit_mesh(devices) -> Mesh:
    """The data x model mesh over `devices`: model is the largest of 16, 8,
    4, 2, 1 that divides their count, data the rest (the reference's rule
    over the devices its runtime exposes). The driver is given one device."""
    n = len(devices)
    model = next(m for m in (16, 8, 4, 2, 1) if n % m == 0)
    return make_mesh((n // model, model), ("data", "model"), devices)


def parse_args(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--arch", choices=ARCH_IDS, default="stablelm-1.6b")
    ap.add_argument("--smoke", action="store_true", help="reduced config (CPU-friendly)")
    ap.add_argument("--steps", type=int, default=200)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--ckpt-dir", default=os.path.join(tempfile.gettempdir(), "repro_ckpt"))
    ap.add_argument("--save-every", type=int, default=50)
    ap.add_argument("--log-every", type=int, default=10)
    ap.add_argument("--resume", action="store_true")
    ap.add_argument("--no-dedup", action="store_true")
    ap.add_argument("--fail-at", type=int, default=-1,
                    help="inject a worker failure at this step (FT demo)")
    ap.add_argument("--device", default="cuda",
                    help="where the parameters, the moments and the dedup index live (default: the card; "
                         "'cpu' runs the plain PyTorch versions)")
    return ap.parse_args(argv)


def _sync(device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def _load(model, params) -> None:
    """Make `params` (name -> tensor) the model's values: a copy, unless they
    are its own parameters already (the state a restart hands back is new)."""
    with torch.no_grad():
        for name, p in model.named_parameters():
            if params[name] is not p:
                p.copy_(params[name])


def train(args, cfg, params) -> dict:
    """Train `params` (a `model_zoo.Model`, on the device it names, updated
    in place) for `args.steps` steps. Returns {"losses", "log" (one dict per
    logged step: step, loss, grad_norm, lr, dups, tok_s, step_s), "done",
    "supervisor_log", "state" ({"params", "opt", "pipe"}), "model",
    "train_step", "pipe_cfg", "peak_mem_bytes" (the run's peak device memory; None on the CPU)}."""
    device = params.embed.device
    if device.type == "cuda":
        torch.cuda.reset_peak_memory_stats(device)
    mesh = best_fit_mesh([device])
    print(f"[train] arch={cfg.name} mesh={mesh.shape} devices={mesh.size} ({device})")
    ocfg = AdamConfig(lr=args.lr, total_steps=args.steps, warmup_steps=max(10, args.steps // 20))
    n_params = sum(p.numel() for p in params.parameters())
    print(f"[train] params: {n_params/1e6:.1f}M")
    opt_state = adam_init(ocfg, params)
    params_sh = shd.params_shardings(cfg, params, mesh)
    opt_sh = AdamState(m=shd.params_shardings(cfg, opt_state.m, mesh),
                       v=shd.params_shardings(cfg, opt_state.v, mesh), step=shd.replicated(mesh))
    # One device: the plan places every leaf where it already is.
    _load(params, shd.place(dict(params.named_parameters()), params_sh))
    opt_state = shd.place(opt_state, opt_sh)
    train_step = make_train_step(cfg, ocfg)
    pcfg = PipelineConfig(vocab_size=cfg.vocab_size, seq_len=args.seq, batch_per_shard=args.batch,
                          dedup=not args.no_dedup, device=device)
    state = {"params": dict(params.named_parameters()), "opt": opt_state, "pipe": pipeline_init(pcfg)}
    batch_sh = shd.batch_shardings(make_batch(pcfg, 0, 0), mesh)

    ckpt = CheckpointManager(args.ckpt_dir, keep=3, async_save=True)
    sup = TrainSupervisor(ckpt, save_every=args.save_every, monitor=StragglerMonitor())
    start_step = 0
    if args.resume and ckpt.latest_step() is not None:
        start_step = ckpt.latest_step()
        state = ckpt.restore(start_step, tree_map(TensorSpec.of, state),
                             shardings={"params": params_sh, "opt": opt_sh})
        print(f"[train] resumed from step {start_step}")

    losses, log = [], []
    fail_at = {args.fail_at} if args.fail_at >= 0 else set()
    t_start = time.time()

    def step_fn(state, step):
        if step in fail_at:
            fail_at.clear()
            raise RuntimeError("injected failure (FT demo)")
        t0 = time.perf_counter()
        batch = shd.place(make_batch(pcfg, 0, step), batch_sh)
        pipe, batch, n_dup = dedup_batch(pcfg, state["pipe"], batch, 0, step)
        _load(params, state["params"])
        _, opt, metrics = train_step(params, state["opt"], batch)
        _sync(device)
        step_s = time.perf_counter() - t0
        if step % args.log_every == 0:
            rec = dict(step=step, loss=float(metrics["loss"]), grad_norm=float(metrics["grad_norm"]),
                       lr=float(metrics["lr"]), dups=int(n_dup), step_s=step_s,
                       tok_s=(step - start_step + 1) * args.batch * args.seq / max(time.time() - t_start, 1e-9))
            losses.append(rec["loss"])
            log.append(rec)
            print(f"  step {step:5d} loss {rec['loss']:.4f} gnorm {rec['grad_norm']:.3f} lr {rec['lr']:.2e} "
                  f"dups {rec['dups']} tok/s {rec['tok_s']:,.0f} step_ms {step_s * 1e3:.1f}", flush=True)
        return {"params": dict(params.named_parameters()), "opt": opt, "pipe": pipe}

    state, done = sup.run(state, step_fn, num_steps=args.steps, start_step=start_step)
    _load(params, state["params"])
    ckpt.wait()
    if sup.log:
        print("[train] supervisor log:")
        for line in sup.log:
            print("   ", line)
    print(f"[train] finished at step {done}; last losses: {[round(v, 3) for v in losses[-5:]]}")
    if len(losses) >= 2 and losses[-1] < losses[0]:
        print("[train] loss decreased ✓")
    peak = torch.cuda.max_memory_allocated(device) if device.type == "cuda" else None
    if peak is not None:
        print(f"[train] peak device memory {peak / 2**30:.2f} GiB")
    return dict(losses=losses, log=log, done=done, supervisor_log=sup.log,
                state=dict(state, params=dict(params.named_parameters())), model=params,
                train_step=train_step, pipe_cfg=pcfg, peak_mem_bytes=peak)


def run(argv=None) -> dict:
    """The command line: `train` with random parameters made on --device
    (the card unless "cpu" is asked for; no fallback) by a generator seeded 0."""
    args = parse_args(argv)
    device = torch.device(args.device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("--device cuda: no CUDA device is available (pass --device cpu to train on the CPU)")
    cfg = get_smoke_config(args.arch) if args.smoke else get_config(args.arch)
    return train(args, cfg, zoo.init_params(cfg, device=device))


def main(argv=None):
    """Returns the logged losses, as the reference's main does."""
    return run(argv)["losses"]


if __name__ == "__main__":
    main()
