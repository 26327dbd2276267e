"""Stable merges of sorted runs: the K-way cascade merge and the pairwise
Merge Path.

`merge_cascade_path` and `merge_groups` launch the CUDA K-way Merge Path
kernel (`csrc/merge_cascade.cu`, replacing the Pallas
`repro.kernels.merge_path.merge_cascade_path`): up to 32 runs given by
pointer (the LSM's cascade, cleanup and size merge), or every group of K
adjacent equal-width runs of one array in one launch (a round of the batch
sort). `cascade_split` launches the same kernel's K-way split alone.
`merge_path` launches the CUDA Merge Path kernels (`csrc/merge_path.cu`,
replacing the Pallas `repro.kernels.merge_path.merge_path`) on one pair of
runs (the sorted array's merge): a split pass over the tile boundaries, then
the tile merge; `merge_split` launches the split alone at given diagonals
(for checks). On CPU tensors each runs its plain version,
the same function in PyTorch. The Hopper kernels take any run lengths, so
no TPU tiling gate routes a shape elsewhere.

Semantics (equal to a left fold of `ref.merge_ref`): runs are given newest
first and each is ascending in `kv >> shift` (shift 1 compares original keys,
shift 0 the full key variable). Equal keys keep run order, then index order.
"""

from __future__ import annotations

import torch

from repro_torch.kernels._build import I32, I64, MAX_RUNS, P, Kernel, check_cuda_int32, run_pointers

CASCADE_KERNEL = Kernel(
    "merge_cascade.cu", "repro_merge_cascade",
    [P, P, P, I32, I32, P, P, P],  # kv[], val[], n[], k, shift, out_kv, out_val, stream
    # kv, val, total, w, k, shift, out_kv, out_val, stream
    also={"repro_merge_groups": [P, P, I64, I64, I32, I32, P, P, P]},
)
SPLIT_KERNEL = Kernel(
    "merge_cascade.cu", "repro_cascade_split",
    [P, P, I32, I32, P, I64, P, P],  # kv[], n[], k, shift, diags, nd, out, stream
)
PATH_KERNEL = Kernel(
    "merge_path.cu", "repro_merge_path",
    # a_kv, a_val, na, b_kv, b_val, nb, shift, splits, n_splits, out_kv, out_val, stream
    [P, P, I64, P, P, I64, I32, P, I64, P, P, P],
)
PATH_SPLIT_KERNEL = Kernel(
    "merge_path.cu", "repro_merge_split",
    [P, I64, P, I64, I32, P, I64, P, P],  # a_kv, na, b_kv, nb, shift, diags, nd, out, stream
)


def _outputs(n: int, device, out):
    if out is None:
        return (torch.empty(n, dtype=torch.int32, device=device),
                torch.empty(n, dtype=torch.int32, device=device))
    if out[0].shape[0] != n or out[1].shape[0] != n:
        raise ValueError(f"out must hold {n} elements")
    return out


def merge_cascade_plain(runs_kv, runs_val, *, shift: int = 1, out=None):
    """The K-way merge as a rank scatter in PyTorch: element i of run s lands
    at i + sum over newer runs of upper_bound + sum over older runs of lower_bound."""
    total = sum(kv.shape[0] for kv in runs_kv)
    device = runs_kv[0].device
    out_kv, out_val = _outputs(total, device, out)
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
    out = _outputs(sum(kv.shape[0] for kv in runs_kv), runs_kv[0].device, out)
    device = check_cuda_int32("merge_cascade_path", *runs_kv, *runs_val, *out)
    kvp, valp, n = run_pointers(runs_kv, runs_val)
    CASCADE_KERNEL.launch(device, kvp, valp, n, k, shift, out[0].data_ptr(), out[1].data_ptr())
    return out


def merge_groups_plain(kv, val, width: int, k: int, *, shift: int, out=None):
    """Every group of k adjacent width-`width` runs of (kv, val), each run
    sorted, merged into the same span of `out`; the last group may be short
    or have fewer runs. Within a group the runs lie in run order, so the
    merge is a stable sort by (group, kv >> shift)."""
    n = kv.shape[0]
    out_kv, out_val = _outputs(n, kv.device, out)
    group = torch.arange(n, device=kv.device) // (k * width)
    order = torch.sort((group << 32) + ((kv.to(torch.int64) >> shift) + (1 << 31)), stable=True).indices
    out_kv.copy_(kv[order])
    out_val.copy_(val[order])
    return out_kv, out_val


def merge_groups(kv, val, width: int, k: int, *, compare_full: bool = False, out=None):
    """One merge round: runs [(g*k + s) * width, (g*k + s + 1) * width) of
    (kv, val), s < k, each sorted, the earlier newer, merge into the same
    span of `out`, for every group g, in one launch. `out` must not overlap
    the input."""
    if width < 1 or not 1 <= k <= MAX_RUNS:
        raise ValueError(f"need width >= 1 and 1 <= k <= {MAX_RUNS}, got {width} and {k}")
    shift = 0 if compare_full else 1
    if kv.device.type == "cpu":
        return merge_groups_plain(kv, val, width, k, shift=shift, out=out)
    n = kv.shape[0]
    out = _outputs(n, kv.device, out)
    device = check_cuda_int32("merge_groups", kv, val, *out)
    if val.shape[0] != n:
        raise ValueError("merge_groups: kv and val lengths differ")
    if n:
        CASCADE_KERNEL.launch(device, kv.data_ptr(), val.data_ptr(), n, width, k, shift,
                              out[0].data_ptr(), out[1].data_ptr(), entry="repro_merge_groups")
    return out


def cascade_split_plain(runs_kv, diags, *, shift: int = 1):
    """The K-way Merge Path split -> int64 [K, len(diags)]: element [s, q] is
    the number of elements of run s among the first diags[q] outputs of the
    merge. As the kernel (and `repro.kernels.merge_path.cascade_partition`)
    computes it: the smallest key k* with sum_s upper_bound_s(k*) >= d, by
    bisection over the int32 keys, then every element below k* and the rest
    of d from the key == k* segments in run order."""
    keys = [kv.to(torch.int64) >> shift for kv in runs_kv]
    d = diags.to(torch.int64)
    lo, hi = torch.full_like(d, -(1 << 31)), torch.full_like(d, (1 << 31) - 1)
    for _ in range(32):
        mid = lo + (hi - lo) // 2
        pred = sum(torch.searchsorted(ks, mid, right=True) for ks in keys) >= d
        hi, lo = torch.where(pred, mid, hi), torch.where(pred, lo, mid + 1)
    lbs = [torch.searchsorted(ks, lo) for ks in keys]
    segs = [torch.searchsorted(ks, lo, right=True) - lb for ks, lb in zip(keys, lbs)]
    rest = d - sum(lbs)
    bounds = []
    for lb, seg in zip(lbs, segs):
        bounds.append(lb + torch.minimum(rest.clamp(min=0), seg))
        rest = rest - seg
    return torch.stack(bounds)


def cascade_split(runs_kv, diags, *, compare_full: bool = False):
    """The kernel's K-way split alone, one warp per diagonal -> int64
    [K, len(diags)] (see `cascade_split_plain`); `diags` is int64."""
    shift = 0 if compare_full else 1
    if runs_kv[0].device.type == "cpu":
        return cascade_split_plain(runs_kv, diags, shift=shift)
    device = check_cuda_int32("cascade_split", *runs_kv)
    if diags.dtype != torch.int64 or diags.device != device or not diags.is_contiguous():
        raise ValueError("cascade_split: diags must be contiguous int64 on the runs' device")
    kvp, _, n = run_pointers(runs_kv)
    out = torch.empty((len(runs_kv), diags.shape[0]), dtype=torch.int64, device=device)
    SPLIT_KERNEL.launch(device, kvp, n, len(runs_kv), shift, diags.data_ptr(), diags.shape[0], out.data_ptr())
    return out


def path_tile() -> int:
    """Outputs per merge tile of the Merge Path kernel (MP_TILE in
    csrc/merge_path.cu; builds the kernel on first use)."""
    return PATH_KERNEL.constant("repro_merge_tile")


def merge_path_plain(a_kv, a_val, b_kv, b_val, *, shift: int = 1, out=None):
    """`ref.merge_ref`'s rank formula with `shift`: a[i] lands at
    i + |{j : b[j] < a[i]}|, b[j] at j + |{i : a[i] <= b[j]}|."""
    na, nb = a_kv.shape[0], b_kv.shape[0]
    out_kv, out_val = _outputs(na + nb, a_kv.device, out)
    a_keys, b_keys = a_kv >> shift, b_kv >> shift
    idx_a = torch.arange(na, device=a_kv.device) + torch.searchsorted(b_keys, a_keys, right=False)
    idx_b = torch.arange(nb, device=b_kv.device) + torch.searchsorted(a_keys, b_keys, right=True)
    out_kv[idx_a], out_kv[idx_b] = a_kv, b_kv
    out_val[idx_a], out_val[idx_b] = a_val, b_val
    return out_kv, out_val


def merge_path(a_kv, a_val, b_kv, b_val, *, compare_full: bool = False, out=None):
    """Stable merge of two sorted runs, `a` the newer one (it takes ties)
    -> (kv, val) of length na + nb, written into `out` if given (it must not
    overlap the inputs)."""
    shift = 0 if compare_full else 1
    if a_kv.device.type == "cpu":
        return merge_path_plain(a_kv, a_val, b_kv, b_val, shift=shift, out=out)
    na, nb = a_kv.shape[0], b_kv.shape[0]
    out = _outputs(na + nb, a_kv.device, out)
    device = check_cuda_int32("merge_path", a_kv, a_val, b_kv, b_val, *out)
    if a_val.shape[0] != na or b_val.shape[0] != nb:
        raise ValueError("merge_path: kv and val lengths differ")
    if na + nb:
        n_splits = -(-(na + nb) // path_tile()) + 1
        splits = torch.empty(n_splits, dtype=torch.int64, device=device)
        PATH_KERNEL.launch(device, a_kv.data_ptr(), a_val.data_ptr(), na, b_kv.data_ptr(), b_val.data_ptr(), nb,
                           shift, splits.data_ptr(), n_splits, out[0].data_ptr(), out[1].data_ptr())
    return out


def merge_split_plain(a_keys, b_keys, diags):
    """The Merge Path split -> int64: per diagonal d (in [0, na + nb]), the
    number of elements of `a` among the first d outputs of the merge, ties to
    `a` (take from `a` while a_key <= b_key), by a binary search of every
    diagonal at once; as `repro.kernels.merge_path.merge_partition` computes
    it. The keys are the compared ones (`kv >> shift`)."""
    na, nb = a_keys.shape[0], b_keys.shape[0]
    d = diags.to(torch.int64)
    lo, hi = (d - nb).clamp(min=0), d.clamp(max=na)
    if na and nb:  # else lo == hi already
        for _ in range((na + nb).bit_length()):
            mid = (lo + hi) // 2
            take_a = a_keys[mid.clamp(max=na - 1)] <= b_keys[(d - 1 - mid).clamp(0, nb - 1)]
            active = lo < hi
            lo, hi = torch.where(active & take_a, mid + 1, lo), torch.where(active & ~take_a, mid, hi)
    return lo


def merge_split(a_kv, b_kv, diags, *, compare_full: bool = False):
    """The merge's split kernel alone at `diags` (int64, each in [0, na + nb])
    -> int64 (see `merge_split_plain`)."""
    shift = 0 if compare_full else 1
    if a_kv.device.type == "cpu":
        return merge_split_plain(a_kv >> shift, b_kv >> shift, diags)
    device = check_cuda_int32("merge_split", a_kv, b_kv)
    if diags.dtype != torch.int64 or diags.device != device or diags.dim() != 1 or not diags.is_contiguous():
        raise ValueError("merge_split: diags must be contiguous 1-D int64 on the runs' device")
    out = torch.empty(diags.shape[0], dtype=torch.int64, device=device)
    PATH_SPLIT_KERNEL.launch(device, a_kv.data_ptr(), a_kv.shape[0], b_kv.data_ptr(), b_kv.shape[0], shift,
                             diags.data_ptr(), diags.shape[0], out.data_ptr())
    return out
