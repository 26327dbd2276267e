"""Sort of (key variable, value) pairs by the full key variable: the batch
sort of every direct update and bulk build.

`bitonic_sort_pairs` replaces the Pallas `repro.kernels.bitonic_sort.bitonic_sort_pairs`.
On CUDA tensors it sorts every 4096-element tile in shared memory
(`csrc/bitonic_sort.cu`, one launch), then combines the tiles in K-way
rounds on the full key variable: each round is one grouped launch of the
K-way Merge Path (`merge_path.merge_groups`, up to 32 runs a group), so a
sort is 1 + ceil(log32(n / 4096)) launches (b = 2^16: 2, 2^26 keys: 4), as
the Pallas version combines its tiles by `merge_path(compare_full=True)`. On
CPU tensors it runs `sort_pairs_plain`.

The port's sort is STABLE: it equals `ref.sort_ref` (and the JAX package's
default `ops.sort_pairs`, `lax.sort(is_stable=True)`) bit for bit. The Pallas
network is not stable among identical key variables; the block sort here is
a stable merge sort and each merge round takes ties from the earlier run. So
when a batch holds the same insert twice, the earlier lane's value comes
first and wins, as on the JAX package's default path. Sorting by the full key
variable puts a tombstone before every insert of its key (paper §4.1).

Any n works, 0 included: the reference's power-of-two gate is not ported.
"""

from __future__ import annotations

import torch

from repro_torch.kernels import merge_path
from repro_torch.kernels._build import I64, MAX_RUNS, P, Kernel, check_cuda_int32

TILE = 4096  # elements one block sorts; csrc/bitonic_sort.cu BS_TILE

KERNEL = Kernel(
    "bitonic_sort.cu", "repro_block_sort",
    [P, P, I64, P, P, P],  # kv_in, val_in, n, kv_out, val_out, stream
)


def sort_pairs_plain(key_vars, values):
    """A stable sort by the full key variable."""
    order = torch.sort(key_vars, stable=True).indices
    return key_vars[order], values[order]


def block_sort_plain(key_vars, values):
    """Every TILE-element tile sorted stably by the full key variable; a
    short last tile is sorted on its own."""
    n = key_vars.shape[0]
    pad = -n % TILE
    lane = torch.arange(n + pad, device=key_vars.device)
    key = torch.cat([key_vars.to(torch.int64), key_vars.new_full((pad,), 1 << 31, dtype=torch.int64)])
    order = torch.sort(key.view(-1, TILE), dim=1, stable=True).indices
    order = (order + (lane.view(-1, TILE)[:, :1])).reshape(-1)[:n]
    return key_vars[order], values[order]


def block_sort(key_vars, values):
    """The tile sort alone -> (kv, val): one launch of csrc/bitonic_sort.cu
    on CUDA tensors, `block_sort_plain` on CPU tensors."""
    if key_vars.device.type == "cpu":
        return block_sort_plain(key_vars, values)
    device = check_cuda_int32("block_sort", key_vars, values)
    n = key_vars.shape[0]
    if values.shape[0] != n:
        raise ValueError("block_sort: kv and val lengths differ")
    out_kv, out_val = torch.empty_like(key_vars), torch.empty_like(values)
    if n:
        KERNEL.launch(device, key_vars.data_ptr(), values.data_ptr(), n, out_kv.data_ptr(), out_val.data_ptr())
    return out_kv, out_val


def merge_rounds(n: int):
    """(run width, runs per group) of each K-way round that combines the
    sorted tiles of n elements into one run: 32 runs a group while more than
    32 are left, then the rest."""
    rounds, width = [], TILE
    while width < n:
        k = min(MAX_RUNS, -(-n // width))
        rounds.append((width, k))
        width *= k
    return rounds


def sort_by_tiles(key_vars, values):
    """The tile sort, then the K-way merge rounds until one run is left. On
    CPU tensors the same steps run their plain versions."""
    kv, val = block_sort(key_vars, values)
    rounds = merge_rounds(kv.shape[0])
    spare = (torch.empty_like(kv), torch.empty_like(val)) if rounds else None
    for width, k in rounds:
        spare, (kv, val) = (kv, val), merge_path.merge_groups(kv, val, width, k, compare_full=True, out=spare)
    return kv, val


def bitonic_sort_pairs(key_vars, values):
    """Stable sort of (kv, val) by the full key variable -> new (kv, val)."""
    if key_vars.device.type == "cpu":
        return sort_pairs_plain(key_vars, values)
    return sort_by_tiles(key_vars, values)
