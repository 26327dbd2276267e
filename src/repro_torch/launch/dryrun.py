"""Multi-pod dry run as a plan check (PyTorch counterpart of
repro.launch.dryrun): every (arch x shape x mesh) cell's per-device memory
under the sharding plan, on the "meta" device, over the production meshes.

  python -m repro_torch.launch.dryrun --arch qwen2-7b --shape train_4k
  python -m repro_torch.launch.dryrun --arch qwen2-7b --shape train_4k --multi-pod
  python -m repro_torch.launch.dryrun --all --out results/dryrun

The reference lowers and compiles each cell with explicit shardings on 512
forced host devices and reads XLA's compiled artifact: `memory_analysis`,
`cost_analysis`, the collective bytes parsed from the partitioned HLO
(`collective_stats`) and a `scan_unroll` extrapolation of the per-layer
costs. None of these has an analogue here (no compiler partitions a
program over a mesh that is not there), and none is imitated. What this
module checks is the plan itself: for each cell it builds the model on the
"meta" device, lays every leaf out by `dist.sharding` over
`make_production_mesh`, and reports per device

* the bytes of the parameters, the gradients (the parameters' dtype), and
  AdamW's moments (fp32; bf16 for deepseek-v3-671b, as the reference's
  `build_cell` has it) with their step, for train cells;
* the bytes of the batch, and of the logits a prefill or decode returns;
* the bytes of the caches a prefill returns or a decode takes
  (`model_zoo.cache_specs`). The reference's prefill and decode cells call
  `sharding.cache_shardings`, which its `dist/sharding.py` does not define,
  so they raise there; no cache plan is invented here: the caches are
  reported replicated (`"cache_plan": "replicated"`);
* the largest per-device leaf, and `model_flops` globally and per chip.

The bound is the H100's own (989 TFLOP/s dense bf16, 3.35 TB/s of HBM): the
per-chip model FLOPs at peak, and the bytes the cell holds per device read
once. The TPU figures of the reference's roofline are not carried over.
One JSON per cell is written to --out; the run prints "done; N failures".
"""

from __future__ import annotations

import argparse
import functools
import json
import math
import os
import time
import traceback

import torch

from repro_torch.checkpoint.checkpoint import TensorSpec, tree_flatten_with_path, tree_map
from repro_torch.configs.base import ARCH_IDS, get_config
from repro_torch.configs.shapes import get_shape, shapes_for
from repro_torch.dist import sharding as shd
from repro_torch.launch.mesh import make_production_mesh
from repro_torch.models import model_zoo as zoo
from repro_torch.train.options import PerfOptions

# H100 SXM: dense bf16 tensor-core peak and HBM3 bandwidth (NVIDIA's datasheet).
PEAK_FLOPS = 989e12
HBM_BW = 3.35e12


@functools.lru_cache(maxsize=None)
def _param_specs(cfg):
    """Parameter name -> TensorSpec of the full model, built on "meta"."""
    return {n: TensorSpec.of(p) for n, p in zoo.init_params(cfg, device="meta").named_parameters()}


def _per_device(category, tree, plan):
    """[(leaf name, per-device bytes, per-device shape, spec)] of a tree under its plan."""
    rows = []
    for (path, spec), (_, pl) in zip(tree_flatten_with_path(tree)[0], tree_flatten_with_path(plan)[0]):
        local = pl.local_shape(spec.shape)
        rows.append((f"{category}{path}", math.prod(local) * spec.dtype.itemsize, local, pl.spec))
    return rows


def plan_cell(arch: str, shape_name: str, mesh, options=None) -> dict:
    """The per-device footprint of one cell under the plan, by category."""
    options = options or PerfOptions()
    cfg = get_config(arch)
    shape = get_shape(shape_name)
    if shape.name == "long_500k" and not cfg.supports_long_context():
        raise ValueError(f"{arch} skips long_500k (full attention; DESIGN.md §5)")
    params = _param_specs(cfg)
    serve = options.serve_sharding and shape.kind in ("prefill", "decode")
    params_sh = shd.params_shardings(cfg, params, mesh, serve=serve)
    specs = zoo.input_specs(cfg, shape)
    b = shape.global_batch
    rows = {"params": _per_device("params", params, params_sh)}
    rec = {}
    if shape.kind == "train":
        mdt = torch.bfloat16 if arch == "deepseek-v3-671b" else torch.float32
        moments = {n: TensorSpec(s.shape, mdt, s.device) for n, s in params.items()}
        step = TensorSpec((), torch.int32, torch.device("meta"))
        rows["grads"] = _per_device("grads", params, params_sh)
        rows["moments"] = _per_device(
            "moments", {"m": moments, "v": moments, "step": step},
            {"m": shd.params_shardings(cfg, moments, mesh), "v": shd.params_shardings(cfg, moments, mesh),
             "step": shd.replicated(mesh)})
        rows["batch"] = _per_device("batch", specs["batch"], shd.batch_shardings(specs["batch"], mesh))
        rec["moment_dtype"] = str(mdt).removeprefix("torch.")
    else:
        if shape.kind == "prefill":
            batch, caches = specs["batch"], zoo.cache_specs(cfg, b, shape.seq_len)
        else:
            batch, caches = {"token": specs["token"], "cache_len": specs["cache_len"]}, specs["caches"]
        logits = TensorSpec((b, cfg.vocab_size), torch.float32, torch.device("meta"))
        rows["batch"] = _per_device("batch", batch, shd.batch_shardings(batch, mesh))
        rows["logits"] = _per_device("logits", logits, shd.batch_shardings(logits, mesh))
        rows["caches"] = _per_device("caches", caches, tree_map(lambda _: shd.replicated(mesh), caches))
        rec["cache_plan"] = "replicated"
    per_device = {k: sum(r[1] for r in v) for k, v in rows.items()}
    per_device["total"] = sum(per_device.values())
    name, nbytes, local, spec = max((r for v in rows.values() for r in v), key=lambda r: r[1])
    rec.update(per_device_bytes=per_device,
               largest_leaf={"name": name, "bytes": nbytes, "local_shape": list(local), "spec": list(spec)},
               model_flops_global=zoo.model_flops(cfg, shape))
    return rec


def run_cell(arch: str, shape_name: str, multi_pod: bool, options=None) -> dict:
    """One cell's record."""
    options = options or PerfOptions()
    mesh = make_production_mesh(multi_pod=multi_pod)
    chips = mesh.size
    t0 = time.perf_counter()
    plan = plan_cell(arch, shape_name, mesh, options)
    mf = plan["model_flops_global"]
    return {
        "arch": arch,
        "shape": shape_name,
        "mesh": "2x16x16" if multi_pod else "16x16",
        "chips": chips,
        "options": {
            "sharded_loss": options.sharded_loss,
            "remat_policy": options.remat_policy,
            "zero3_gather": options.zero3_gather,
            "serve_sharding": options.serve_sharding,
            "attn_seq_shard": options.attn_seq_shard,
        },
        "status": "ok",
        "plan_s": time.perf_counter() - t0,
        **plan,
        "model_flops_per_chip": mf / chips,
        "h100_bound": {
            "compute_s": mf / chips / PEAK_FLOPS,
            "memory_s": plan["per_device_bytes"]["total"] / HBM_BW,
        },
    }


def _options(args, arch) -> PerfOptions:
    if args.opt:
        cfg = get_config(arch)
        seq_shard = bool(cfg.num_heads) and (
            cfg.num_heads % 16 != 0 or cfg.num_kv_heads % 16 != 0) and not cfg.use_mla
        return PerfOptions(sharded_loss=True, zero3_gather=True, remat_policy="dots", attn_seq_shard=seq_shard)
    return PerfOptions(sharded_loss=args.sharded_loss, remat_policy=args.remat, zero3_gather=args.zero3_gather,
                       serve_sharding=args.serve_sharding, attn_seq_shard=args.attn_seq_shard)


def parse_args(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--arch", choices=ARCH_IDS)
    ap.add_argument("--shape")
    ap.add_argument("--multi-pod", action="store_true")
    ap.add_argument("--all", action="store_true", help="run every cell (both meshes)")
    ap.add_argument("--out", default="results/dryrun")
    ap.add_argument("--sharded-loss", action="store_true")
    ap.add_argument("--zero3-gather", action="store_true")
    ap.add_argument("--serve-sharding", action="store_true")
    ap.add_argument("--attn-seq-shard", action="store_true")
    ap.add_argument("--opt", action="store_true",
                    help="the reference's per-arch optimized recipe (recorded; the plan is the same)")
    ap.add_argument("--remat", default="full", choices=("full", "dots", "none"))
    ap.add_argument("--force", action="store_true", help="overwrite existing JSONs")
    return ap.parse_args(argv)


def run(argv=None) -> list:
    """The command line; returns the records of the cells it ran."""
    args = parse_args(argv)
    os.makedirs(args.out, exist_ok=True)
    if args.all:
        cells = [(arch, shape.name, mp) for arch in ARCH_IDS for shape in shapes_for(get_config(arch))
                 for mp in (False, True)]
    else:
        cells = [(args.arch, args.shape, args.multi_pod)]
    records = []
    for arch, shape_name, mp in cells:
        tag = f"{arch}__{shape_name}__{'2x16x16' if mp else '16x16'}"
        out_path = os.path.join(args.out, tag + ".json")
        if os.path.exists(out_path) and not args.force:
            print(f"[skip] {tag} (exists)")
            continue
        print(f"[dryrun] {tag} ...", flush=True)
        try:
            rec = run_cell(arch, shape_name, mp, options=_options(args, arch))
            pd, leaf = rec["per_device_bytes"], rec["largest_leaf"]
            print(f"  ok: per device {pd['total'] / 2**30:.3f} GiB ("
                  + ", ".join(f"{k} {v / 2**30:.3f}" for k, v in pd.items() if k != "total")
                  + f"), largest leaf {leaf['name']} {leaf['bytes'] / 2**20:.1f} MiB, model_flops/chip "
                  f"{rec['model_flops_per_chip']:.3e} (plan {rec['plan_s']:.2f} s)", flush=True)
        except Exception as e:  # noqa: BLE001 — record and continue
            rec = {
                "arch": arch, "shape": shape_name,
                "mesh": "2x16x16" if mp else "16x16",
                "status": "error", "error": f"{type(e).__name__}: {e}",
                "traceback": traceback.format_exc()[-4000:],
            }
            print(f"  FAILED: {type(e).__name__}: {str(e)[:300]}", flush=True)
        with open(out_path, "w") as f:
            json.dump(rec, f, indent=2)
        records.append(rec)
    failures = sum(r["status"] != "ok" for r in records)
    print(f"done; {failures} failures")
    return records


def main(argv=None) -> int:
    return 1 if any(r["status"] != "ok" for r in run(argv)) else 0


if __name__ == "__main__":
    raise SystemExit(main())
