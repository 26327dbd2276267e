"""Gradient compression for the data-parallel mean: int8 quantisation with
error feedback (PyTorch counterpart of repro.dist.compression).

Each float leaf is quantised to int8 against a per-leaf absmax scale after
adding the residual carried over from the previous step; the quantisation
residual becomes the next step's carry. Error feedback turns the biased
per-step rounding into an unbiased long-run average, so repeated compression
of a constant gradient converges to the exact mean.

The reference runs this inside a mapped axis and combines with `psum`. Here
one controller holds every rank's tree (as core/distributed.py holds every
shard's state): each rank's leaf is quantised on its own device, and the
dequantised tensors are summed on rank 0's device in rank order. The
arithmetic is the reference's, step by step in the leaf's dtype: `round` is
half-to-even in both packages, and an integer leaf is the floor of its mean.
No process group is made.
"""

from __future__ import annotations

import torch

from repro_torch.checkpoint.checkpoint import tree_flatten_with_path, tree_map


def _is_float(leaf) -> bool:
    return isinstance(leaf, torch.Tensor) and leaf.is_floating_point()


def init_error_state(tree):
    """Zero residual for every float leaf (int leaves carry no error)."""
    return tree_map(lambda l: torch.zeros_like(l) if _is_float(l) else torch.zeros((), dtype=l.dtype, device=l.device),
                    tree)


def _quantised(g, e):
    """(the dequantised int8 payload, the new residual) of one rank's leaf."""
    t = g + e
    scale = torch.clamp_min(t.abs().max(), 1e-30) / 127.0
    q = torch.clamp(torch.round(t / scale), -127, 127).to(torch.int8)
    deq = q.to(g.dtype) * scale
    return deq, t - deq


def compressed_tree_psum(trees, error_states):
    """Mean-reduce a list of per-rank trees via int8 + error feedback.

    `trees[r]` and `error_states[r]` are rank r's gradient tree and residual
    tree (same structure). Returns (the mean tree on rank 0's devices, the
    list of new residual trees, each on its rank's devices)."""
    n = len(trees)
    flats = [tree_flatten_with_path(t)[0] for t in trees]
    errs = [[leaf for _, leaf in tree_flatten_with_path(e)[0]] for e in error_states]
    unflatten = tree_flatten_with_path(trees[0])[1]
    means, new_errs = [], [[] for _ in range(n)]
    for i, (_, g0) in enumerate(flats[0]):
        if not _is_float(g0):
            total = g0.clone()
            for r in range(1, n):
                total += flats[r][i][1].to(g0.device)
            means.append(total // n)
            for r in range(n):
                new_errs[r].append(errs[r][i])
            continue
        total = None
        for r in range(n):
            deq, e_new = _quantised(flats[r][i][1], errs[r][i])
            new_errs[r].append(e_new)
            total = deq.to(g0.device) if total is None else total + deq.to(g0.device)
        means.append(total / n)
    return unflatten(means), [unflatten(e) for e in new_errs]
