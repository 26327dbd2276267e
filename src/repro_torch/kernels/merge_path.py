"""K-way stable newest-first merge: the LSM's cascade, cleanup and size merge.

`merge_cascade_path` launches the CUDA rank-scatter kernel
(`csrc/merge_cascade.cu`) on CUDA tensors and runs `merge_cascade_plain`, the
same arithmetic in PyTorch, on CPU tensors. It replaces the Pallas
`repro.kernels.merge_path.merge_cascade_path`; the Hopper kernel takes any
run lengths, so no TPU tiling gate routes a shape elsewhere.

Semantics (equal to a left fold of `ref.merge_ref`): runs are given newest
first and each is ascending in `kv >> shift` (shift 1 compares original keys,
shift 0 the full key variable). Equal keys keep run order, then index order.
"""

from __future__ import annotations

import torch

from repro_torch.kernels._build import I32, P, Kernel, check_cuda_int32, run_pointers

KERNEL = Kernel(
    "merge_cascade.cu", "repro_merge_cascade",
    [P, P, P, I32, I32, P, P, P],  # kv[], val[], n[], k, shift, out_kv, out_val, stream
)


def merge_cascade_plain(runs_kv, runs_val, *, shift: int = 1, out=None):
    """The kernel's rank scatter in PyTorch: element i of run s lands at
    i + sum over newer runs of upper_bound + sum over older runs of lower_bound."""
    total = sum(kv.shape[0] for kv in runs_kv)
    device = runs_kv[0].device
    out_kv, out_val = out if out is not None else (
        torch.empty(total, dtype=torch.int32, device=device),
        torch.empty(total, dtype=torch.int32, device=device),
    )
    keys = [kv >> shift for kv in runs_kv]
    for s, (kv, val) in enumerate(zip(runs_kv, runs_val)):
        pos = torch.arange(kv.shape[0], dtype=torch.int64, device=device)
        for t, other in enumerate(keys):
            if t != s:
                pos += torch.searchsorted(other, keys[s], right=t < s)
        out_kv[pos] = kv
        out_val[pos] = val
    return out_kv, out_val


def merge_cascade_path(runs_kv, runs_val, *, compare_full: bool = False, out=None):
    """K-way merge of sorted runs, newest first -> (kv, val) of their total length.

    `out`, if given, is a pair of int32 tensors of the total length that
    receive the result; it must not overlap any input run.
    """
    k = len(runs_kv)
    if k < 1 or len(runs_val) != k:
        raise ValueError(f"need matching kv/val run lists, got {k} and {len(runs_val)}")
    shift = 0 if compare_full else 1
    if runs_kv[0].device.type == "cpu":
        return merge_cascade_plain(runs_kv, runs_val, shift=shift, out=out)
    total = sum(kv.shape[0] for kv in runs_kv)
    if out is None:
        device = runs_kv[0].device
        out = (
            torch.empty(total, dtype=torch.int32, device=device),
            torch.empty(total, dtype=torch.int32, device=device),
        )
    device = check_cuda_int32("merge_cascade_path", *runs_kv, *runs_val, *out)
    if out[0].shape[0] != total or out[1].shape[0] != total:
        raise ValueError(f"out must hold {total} elements")
    kvp, valp, n = run_pointers(runs_kv, runs_val)
    KERNEL.launch(device, kvp, valp, n, k, shift, out[0].data_ptr(), out[1].data_ptr())
    return out
