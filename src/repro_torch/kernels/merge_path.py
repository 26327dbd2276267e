"""Stable merges of sorted runs: the K-way cascade merge and the pairwise
Merge Path.

`merge_cascade_path` launches the CUDA rank-scatter kernel
(`csrc/merge_cascade.cu`, replacing the Pallas
`repro.kernels.merge_path.merge_cascade_path`): the LSM's cascade, cleanup and
size merge. `merge_path` and `merge_round` launch the CUDA Merge Path kernel
(`csrc/merge_path.cu`, replacing the Pallas `repro.kernels.merge_path.merge_path`):
one pair of runs, or every adjacent pair of equal-width runs of one array in
one launch (a round of the batch sort). On CPU tensors each runs its plain
version, the same arithmetic in PyTorch. The Hopper kernels take any run
lengths, so no TPU tiling gate routes a shape elsewhere.

Semantics (equal to a left fold of `ref.merge_ref`): runs are given newest
first and each is ascending in `kv >> shift` (shift 1 compares original keys,
shift 0 the full key variable). Equal keys keep run order, then index order.
"""

from __future__ import annotations

import torch

from repro_torch.kernels._build import I32, I64, P, Kernel, check_cuda_int32, run_pointers

CASCADE_KERNEL = Kernel(
    "merge_cascade.cu", "repro_merge_cascade",
    [P, P, P, I32, I32, P, P, P],  # kv[], val[], n[], k, shift, out_kv, out_val, stream
)
PATH_KERNEL = Kernel(
    "merge_path.cu", "repro_merge_path",
    # a_kv, a_val, a_stride, a_total, w_a, b_kv, b_val, b_stride, b_total, w_b,
    # pairs, shift, out_kv, out_val, stream
    [P, P, I64, I64, I64, P, P, I64, I64, I64, I64, I32, P, P, P],
)


def _outputs(n: int, device, out):
    if out is None:
        return (torch.empty(n, dtype=torch.int32, device=device),
                torch.empty(n, dtype=torch.int32, device=device))
    if out[0].shape[0] != n or out[1].shape[0] != n:
        raise ValueError(f"out must hold {n} elements")
    return out


def merge_cascade_plain(runs_kv, runs_val, *, shift: int = 1, out=None):
    """The kernel's rank scatter in PyTorch: element i of run s lands at
    i + sum over newer runs of upper_bound + sum over older runs of lower_bound."""
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
        PATH_KERNEL.launch(
            device, a_kv.data_ptr(), a_val.data_ptr(), 0, na, na,
            b_kv.data_ptr(), b_val.data_ptr(), 0, nb, nb, 1, shift, out[0].data_ptr(), out[1].data_ptr(),
        )
    return out


def merge_round_plain(kv, val, width: int, *, shift: int, out=None):
    """Every adjacent pair of width-`width` runs of (kv, val), merged in
    place in `out`; the last pair may be short or have no `b` run."""
    n = kv.shape[0]
    out_kv, out_val = _outputs(n, kv.device, out)
    for s in range(0, n, 2 * width):
        m, e = min(s + width, n), min(s + 2 * width, n)
        merge_path_plain(kv[s:m], val[s:m], kv[m:e], val[m:e], shift=shift,
                         out=(out_kv[s:e], out_val[s:e]))
    return out_kv, out_val


def merge_round(kv, val, width: int, *, compare_full: bool = False, out=None):
    """One merge round: runs [2p*w, (2p+1)*w) and [(2p+1)*w, (2p+2)*w) of
    (kv, val), each sorted, merge into the same span of `out`, for every p,
    in one launch. `out` must not overlap the input."""
    if width < 1:
        raise ValueError(f"run width must be >= 1, got {width}")
    shift = 0 if compare_full else 1
    if kv.device.type == "cpu":
        return merge_round_plain(kv, val, width, shift=shift, out=out)
    n = kv.shape[0]
    out = _outputs(n, kv.device, out)
    device = check_cuda_int32("merge_round", kv, val, *out)
    if val.shape[0] != n:
        raise ValueError("merge_round: kv and val lengths differ")
    if n:
        # `b` of pair p starts `width` elements after its `a`: 4 bytes each.
        PATH_KERNEL.launch(
            device, kv.data_ptr(), val.data_ptr(), 2 * width, n, width,
            kv.data_ptr() + 4 * width, val.data_ptr() + 4 * width, 2 * width, max(n - width, 0), width,
            -(-n // (2 * width)), shift, out[0].data_ptr(), out[1].data_ptr(),
        )
    return out
