"""COUNT and RANGE after stage 1: each window's candidates, survivors, count
and (RANGE) row of survivors in key order (paper §4.3-4.4, stages 2-5).

On CUDA tensors `count_windows` and `range_windows` launch
`csrc/window_select.cu` once a call: one warp a window finds its
candidates in the runs' [low, high) slices and tests each by binary searches
in the newer runs' slices, with no [nq, max_candidates] tile and no sort.
On CPU tensors they run the plain version below, the five-stage pipeline of
`repro.core.queries` written over all windows at once:
  2. per-window candidate offsets by prefix sums;
  3. a gather into a [num_windows, max_candidates] placebo-filled tile;
  4. a row-wise stable sort by original key (stability keeps recency);
  5. mask arithmetic: count/emit the first element of each equal-key segment
     iff it is regular (docs/DESIGN.md §8).
The kernel returns what the plain version returns, bit for bit, `ok=False`
windows included. The JAX package has no Pallas kernel here (its stages are
jnp and `lax.sort`).
"""

from __future__ import annotations

import torch

from repro_torch import obs
from repro_torch.core import semantics as sem
from repro_torch.kernels._build import I32, I64, P, Kernel, check_cuda_int32, run_pointers, sm_count

SELECT_KERNEL = Kernel(
    "window_select.cu", "repro_window_select",
    # kv[], val[], n[], k, lows, highs, nq, m, r, range, scratch, scratch_warps, counts, ok, keys, vals, stream
    [P, P, P, I32, P, P, I64, I32, I32, I32, P, I64, P, P, P, P, P],
)

# Resident warps an SM (2048 threads): the most buffers worth a scratch array
# when a window's buffer does not fit in shared memory.
WARPS_PER_SM = 64
# Most int32 slots of that scratch array (256 MB); fewer warps walk the
# windows beyond it.
SCRATCH_INTS = 1 << 26


def _tile_plain(runs, lows, highs, max_candidates: int, flat=None):
    """Stages 2-4 -> (orig, kv, val, total, ok): orig/kv/val are
    [nq, max_candidates], row-sorted by original key and stable in recency,
    placebo-padded; total is each window's exact candidate count; ok is
    total <= max_candidates.

    `flat`, if given, is the newest-first concatenation of `runs` (the LSM
    arena), which spares the copy."""
    nq = lows.shape[1]
    device = lows.device
    with obs.span("queries.tile"):
        counts_m = (highs - lows).clamp(min=0)
        offsets = (torch.cumsum(counts_m, 0) - counts_m).to(torch.int32)
        total = counts_m.sum(0).to(torch.int32)
        ok = total <= max_candidates

        slots = torch.arange(max_candidates, dtype=torch.int64, device=device)[None, :]
        gather_idx = torch.zeros((nq, max_candidates), dtype=torch.int64, device=device)
        valid_slot = torch.zeros((nq, max_candidates), dtype=torch.bool, device=device)
        start = 0
        for r, (kv, _) in enumerate(runs):
            off = offsets[r][:, None]
            sel = (slots >= off) & (slots < off + counts_m[r][:, None])
            idx = start + lows[r][:, None] + (slots - off)
            gather_idx = torch.where(sel, idx, gather_idx)
            valid_slot |= sel
            start += kv.shape[0]

        if flat is None:
            flat = (torch.cat([kv for kv, _ in runs]), torch.cat([v for _, v in runs]))
        cand_kv = torch.where(valid_slot, flat[0][gather_idx], sem.PLACEBO_KV)
        cand_val = torch.where(valid_slot, flat[1][gather_idx], sem.EMPTY_VALUE)
    obs.count("queries.tile_slots", nq * max_candidates)
    if obs.enabled():
        obs.count_device("queries.candidates", total.clamp(max=max_candidates))

    # Stage 4: rows were filled newest run first, so a stable sort by
    # original key keeps the newest element first in each equal-key segment.
    with obs.span("queries.row_sort"):
        orig_s, perm = torch.sort(sem.original_key(cand_kv), dim=1, stable=True)
        return orig_s, cand_kv.gather(1, perm), cand_val.gather(1, perm), total, ok


def _validate(orig_s, kv_s):
    """Stage 5: the first element of each equal-key segment, iff regular."""
    prev = torch.cat([torch.full_like(orig_s[:, :1], -1), orig_s[:, :-1]], dim=1)
    return (orig_s != prev) & ~sem.is_tombstone(kv_s) & (orig_s != sem.PLACEBO_KEY)


def count_plain(runs, lows, highs, max_candidates: int, flat=None):
    """COUNT from stage 1's bounds -> (counts: int32[nq], ok: bool[nq])."""
    orig_s, kv_s, _, _, ok = _tile_plain(runs, lows, highs, max_candidates, flat)
    with obs.span("queries.select"):
        return _validate(orig_s, kv_s).sum(1).to(torch.int32), ok


def range_plain(runs, lows, highs, max_candidates: int, max_results: int, flat=None):
    """RANGE from stage 1's bounds -> (keys [nq, max_results], values,
    counts, ok); rows are padded with PLACEBO_KEY / EMPTY_VALUE beyond
    counts."""
    orig_s, kv_s, val_s, _, ok = _tile_plain(runs, lows, highs, max_candidates, flat)
    with obs.span("queries.select"):
        valid = _validate(orig_s, kv_s)
        counts = valid.sum(1).to(torch.int32)
        ok = ok & (counts <= max_results)

        nq = orig_s.shape[0]
        tgt = torch.cumsum(valid, 1) - 1
        # Column max_results is a drop slot for non-survivors and overflow.
        tgt = torch.where(valid & (tgt < max_results), tgt, max_results)
        out_keys = torch.full((nq, max_results + 1), sem.PLACEBO_KEY, dtype=torch.int32, device=lows.device)
        out_vals = torch.full((nq, max_results + 1), sem.EMPTY_VALUE, dtype=torch.int32, device=lows.device)
        out_keys.scatter_(1, tgt, orig_s)
        out_vals.scatter_(1, tgt, val_s)
        return out_keys[:, :max_results], out_vals[:, :max_results], counts, ok


def buffer_ints(max_candidates: int, ranged: bool) -> int:
    """The kernel's buffer of one window, in int32 slots: the candidates'
    key variables, and for RANGE a survivor mask word and a survivor count
    for each 32 of them."""
    return max_candidates + (2 * (-(-max_candidates // 32)) if ranged else 0)


def scratch_warps(nq: int, per_warp: int, warps: int, shared_bytes: int, sms: int) -> int:
    """Buffers of the kernel's scratch array: 0 when a block's `warps`
    buffers fit in its shared memory; else one for each warp of the grid
    that walks the windows: as many as the windows fill, at most
    WARPS_PER_SM a SM and SCRATCH_INTS slots in all, and a block's worth at
    least."""
    if per_warp * warps * 4 <= shared_bytes:
        return 0
    blocks = min(-(-nq // warps), WARPS_PER_SM * sms // warps, SCRATCH_INTS // (per_warp * warps))
    return warps * max(1, blocks)


def _select(runs, lows, highs, max_candidates: int, max_results):
    """Launch the kernel: COUNT when `max_results` is None, else RANGE."""
    kvs, vals = [kv for kv, _ in runs], [v for _, v in runs]
    k, nq = len(runs), lows.shape[-1]
    if lows.shape != (k, nq) or highs.shape != (k, nq):
        raise ValueError(f"window_select: lows and highs must be [{k}, nq], got {tuple(lows.shape)} "
                         f"and {tuple(highs.shape)}")
    ranged = max_results is not None
    r = max_results if ranged else 0
    if not (0 <= max_candidates < 1 << 31 and 0 <= r < 1 << 31):
        raise ValueError(f"window_select: max_candidates {max_candidates} and max_results {r} must fit int32")
    device = check_cuda_int32("window_select", lows.view(-1), highs.view(-1), *kvs, *vals)
    kvp, valp, n = run_pointers(kvs, vals)
    if max(n) >= 1 << 31:
        raise ValueError("window_select takes int32 positions; a run of 2^31 elements or more is too long")
    per_warp = buffer_ints(max_candidates, ranged)
    warps = SELECT_KERNEL.constant("repro_select_warps")
    n_buffers = scratch_warps(nq, per_warp, warps, SELECT_KERNEL.constant("repro_select_shared_bytes"),
                              sm_count(device.index))
    scratch = torch.empty(n_buffers * per_warp, dtype=torch.int32, device=device) if n_buffers else None
    counts = torch.empty(nq, dtype=torch.int32, device=device)
    ok = torch.empty(nq, dtype=torch.bool, device=device)
    rows = torch.empty((2, nq, r), dtype=torch.int32, device=device) if ranged else None
    with obs.span("queries.tile"):
        SELECT_KERNEL.launch(device, kvp, valp, n, k, lows.data_ptr(), highs.data_ptr(), nq, max_candidates, r,
                             int(ranged), None if scratch is None else scratch.data_ptr(), n_buffers,
                             counts.data_ptr(), ok.data_ptr(), rows[0].data_ptr() if ranged else None,
                             rows[1].data_ptr() if ranged else None)
    obs.count("queries.window_kernel", nq)
    obs.count("queries.tile_slots", nq * max_candidates)
    if obs.enabled():
        obs.count_device("queries.candidates", (highs - lows).clamp(min=0).sum(0).clamp(max=max_candidates))
    return (counts, ok) if not ranged else (rows[0], rows[1], counts, ok)


def count_windows(runs, lows, highs, max_candidates: int, flat=None):
    """COUNT(k1, k2) over newest-first runs, from stage 1's int32 [k, nq]
    `lows` / `highs` -> (counts: int32[nq], ok: bool[nq]). `flat` (the
    runs' concatenation) serves the plain version only."""
    if lows.device.type == "cpu":
        return count_plain(runs, lows, highs, max_candidates, flat)
    return _select(runs, lows, highs, max_candidates, None)


def range_windows(runs, lows, highs, max_candidates: int, max_results: int, flat=None):
    """RANGE(k1, k2) -> (keys [nq, max_results], values, counts, ok)."""
    if lows.device.type == "cpu":
        return range_plain(runs, lows, highs, max_candidates, max_results, flat)
    return _select(runs, lows, highs, max_candidates, max_results)
