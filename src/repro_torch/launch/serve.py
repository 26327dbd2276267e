"""LM serving: batched prefill + greedy decode with the LSM-backed page
index (PyTorch counterpart of repro.launch.serve).

  python -m repro_torch.launch.serve --arch qwen2-7b                 # full width, on the card
  python -m repro_torch.launch.serve --arch qwen2-7b --smoke --device cpu --requests 8

Each wave of `--batch` requests is prefilled (`apply_prefill`), admitted to
the page table (prompt_len // page_size pages a sequence), decoded greedily
for `--gen-tokens` steps (`apply_decode`, cache_len a host int), counted and
evicted. The page table is driven through the continuous-batching
`DictionaryServer` (repro_torch.serve): admissions, evictions and
per-sequence page counts are submitted as ragged tenant ops and coalesce
into shared device steps, so they run the LSM's kernels (the staged
inserts' cascade merge, the counts' bound search, the evictions' lookup).
`--direct` drives the standalone `pt_*` page table instead, one padded call
per op. Parameters are random (bf16, from a seeded `torch.Generator` on the
device); prompts come from numpy's generator seeded 0, as in the reference,
so both packages see the same tokens.

It prints the reference's lines (per wave pages/seq and free; tokens/s and
the index's r; the server's stats) and returns them in a dict.
"""

from __future__ import annotations

import argparse
import functools
import time

import numpy as np
import torch

from repro_torch.configs.base import ARCH_IDS, get_config, get_smoke_config
from repro_torch.models import model_zoo as zoo
from repro_torch.serve.kvcache import (
    PageTableConfig, ServerPageTable, pt_allocate, pt_compact, pt_evict, pt_init, pt_seq_page_count,
)
from repro_torch.serve.server import DictionaryServer, ServerConfig


def _sync(device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


class _Clock:
    """Seconds spent in prefill and in decode (the device synchronised at
    each boundary, so the times are the device's, not the enqueue's)."""

    def __init__(self, device):
        self.device = device
        self.prefill_s = 0.0
        self.decode_s = 0.0

    def timed(self, field, fn):
        _sync(self.device)
        t0 = time.perf_counter()
        out = fn()
        _sync(self.device)
        setattr(self, field, getattr(self, field) + time.perf_counter() - t0)
        return out


def _greedy(logits):
    return torch.argmax(logits, dim=-1)[:, None]


def _decode_wave(args, params, decode, token, caches, cache_len):
    for _ in range(args.gen_tokens):
        logits, caches = decode(params, token, caches, cache_len)
        token = _greedy(logits)
        cache_len += 1
    return token


def _prefill_wave(args, cfg, params, rng, wave, device, clock, prompts):
    seq_ids = (np.arange(args.batch) + wave * args.batch).astype(np.int32)
    tokens = rng.integers(0, cfg.vocab_size, (args.batch, args.prompt_len))
    prompts.append(tokens)
    batch = {"tokens": torch.as_tensor(tokens, device=device)}
    n_prefix = cfg.num_patches if cfg.has_vision_stub else 0
    if cfg.has_vision_stub:
        batch["patch_embeds"] = torch.zeros((args.batch, cfg.num_patches, cfg.d_model),
                                            dtype=torch.bfloat16, device=device)
    logits, caches = clock.timed("prefill_s", lambda: zoo.apply_prefill(
        cfg, params, batch, cache_pad_to=args.prompt_len + args.gen_tokens + n_prefix))
    n_pages = max(1, args.prompt_len // args.page_size)
    seqs = np.repeat(seq_ids, n_pages)
    pages = np.tile(np.arange(n_pages, dtype=np.int32), args.batch)
    return seq_ids, seqs, pages, _greedy(logits), caches, args.prompt_len + n_prefix


def _run_direct(args, cfg, params, decode, rng, device, clock, out):
    """Standalone pt_* path: one padded device call per page-table op."""
    pt_cfg = PageTableConfig(num_pages=1024, update_batch=64, num_levels=10, device=device)
    table = pt_init(pt_cfg)
    total_tokens = 0
    t0 = time.perf_counter()
    n_waves = (args.requests + args.batch - 1) // args.batch
    for wave in range(n_waves):
        seq_ids, seqs, pages, token, caches, cache_len = _prefill_wave(
            args, cfg, params, rng, wave, device, clock, out["prompts"])
        b = pt_cfg.update_batch
        table, _ = pt_allocate(pt_cfg, table, np.resize(seqs, b), np.resize(pages, b), np.arange(b) < len(seqs))
        clock.timed("decode_s", lambda: _decode_wave(args, params, decode, token, caches, cache_len))
        total_tokens += args.gen_tokens * args.batch
        counts, _ = pt_seq_page_count(pt_cfg, table, seq_ids, 256)
        _wave_line(out, wave, args, counts.cpu().numpy().tolist(), int(table.free_count))
        table = pt_evict(pt_cfg, table, np.resize(seqs, b), np.resize(pages, b), np.arange(b) < len(seqs))
    table = pt_compact(pt_cfg, table)
    _sync(device)
    _served_line(out, args, total_tokens, time.perf_counter() - t0, int(table.lsm.r))
    out["live_pages"] = int(table.index.size())


def _run_server(args, cfg, params, decode, rng, device, clock, out):
    """Server path: the page table is a tenant; ragged ops coalesce."""
    srv = DictionaryServer(ServerConfig(
        backend="lsm", batch_size=64, num_levels=10, maintenance_budget=128, device=device))
    pt = ServerPageTable(srv, num_pages=1024, num_seqs=max(256, args.requests))
    total_tokens = 0
    t0 = time.perf_counter()
    n_waves = (args.requests + args.batch - 1) // args.batch
    for wave in range(n_waves):
        seq_ids, seqs, pages, token, caches, cache_len = _prefill_wave(
            args, cfg, params, rng, wave, device, clock, out["prompts"])
        # Ragged admission: no resize-to-batch padding; the server buckets.
        pt.allocate(seqs, pages)
        count_ticket = pt.seq_page_count(seq_ids)
        clock.timed("decode_s", lambda: _decode_wave(args, params, decode, token, caches, cache_len))
        total_tokens += args.gen_tokens * args.batch
        counts, _ = count_ticket.result()   # steps the server loop
        _wave_line(out, wave, args, np.asarray(counts).tolist(), pt.free_count)
        pt.evict(seqs, pages)
    stats = srv.drain()          # queued evict tombstones land first...
    srv.cleanup()                # ...then the stop-the-world compaction
    _sync(device)
    _served_line(out, args, total_tokens, time.perf_counter() - t0, int(srv.dictionary.state.r))
    out["live_pages"] = int(srv.dictionary.size())
    out["stats"] = stats.as_dict()
    print(f"server: {stats.submitted} ops in {stats.device_steps} device steps "
          f"({stats.ops_per_device_step:.2f} ops/step), "
          f"flushes={stats.flushes} maintains={stats.maintains} "
          f"lanes={stats.lanes_by_kind}")


def _wave_line(out, wave, args, counts, free):
    out["waves"].append({"pages_per_seq": counts, "free": free})
    print(f"wave {wave}: generated {args.gen_tokens} tok/seq; pages/seq={counts} free={free}")


def _served_line(out, args, total_tokens, dt, r):
    out.update(tokens=total_tokens, seconds=dt, tokens_per_s=total_tokens / dt, r=r)
    print(f"served {args.requests} requests, {total_tokens} tokens in {dt:.1f}s "
          f"({total_tokens/dt:.1f} tok/s); index compacted to r={r}")


def parse_args(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--arch", choices=ARCH_IDS, default="qwen2-7b")
    ap.add_argument("--smoke", action="store_true")
    ap.add_argument("--requests", type=int, default=8)
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=16)
    ap.add_argument("--gen-tokens", type=int, default=32)
    ap.add_argument("--page-size", type=int, default=8)
    ap.add_argument("--direct", action="store_true",
                    help="standalone pt_* path (no server coalescing)")
    ap.add_argument("--device", default="cuda",
                    help="where the model and the page index live (default: the card; 'cpu' runs "
                         "the plain PyTorch versions)")
    return ap.parse_args(argv)


def serve(args, cfg, params, decode=None) -> dict:
    """Serve `args.requests` requests with `params` (a `model_zoo.Model` on
    the device it names) and return what was printed: {"waves":
    [{"pages_per_seq", "free"}], "tokens", "seconds", "tokens_per_s", "r",
    "live_pages", ("stats" on the server path), "prefill_s", "decode_s",
    "prompts" (one [batch, prompt_len] array a wave)}. `decode` replaces
    `zoo.apply_decode(cfg, ...)` (the same arguments without cfg), for a
    caller that observes or steers the decode steps."""
    device = params.embed.device
    decode = decode or functools.partial(zoo.apply_decode, cfg)
    rng = np.random.default_rng(0)
    clock = _Clock(device)
    out = {"waves": [], "prompts": []}
    with torch.inference_mode():
        (_run_direct if args.direct else _run_server)(args, cfg, params, decode, rng, device, clock, out)
    out.update(prefill_s=clock.prefill_s, decode_s=clock.decode_s)
    return out


def main(argv=None) -> dict:
    """The command line: `serve` with random parameters made on --device
    (the card unless "cpu" is asked for; no fallback) by a generator
    seeded 0. The result also
    holds the "cfg" and the "model" served and its "params_count"."""
    args = parse_args(argv)
    device = torch.device(args.device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("--device cuda: no CUDA device is available (pass --device cpu to serve on the CPU)")
    cfg = get_smoke_config(args.arch) if args.smoke else get_config(args.arch)
    if cfg.is_encoder_decoder:
        raise SystemExit("enc-dec serving path: use examples/dictionary_serving.py patterns")
    params = zoo.init_params(cfg, device=device)
    out = serve(args, cfg, params)
    out.update(cfg=cfg, model=params, params_count=sum(p.numel() for p in params.parameters()))
    return out


if __name__ == "__main__":
    main()
