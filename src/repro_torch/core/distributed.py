"""Range-partitioned sharded LSM (PyTorch counterpart of repro.core.distributed).

Each shard owns a contiguous key range (the region-server model of
BigTable/HBase, chosen over hash partitioning because RANGE/COUNT then touch
only the owning shards) and runs a full local LSM over it:

  * UPDATE: every shard takes the whole b-wide batch, keeps the lanes it owns
    and turns the rest into placebos, so the local binary-counter cascade is
    unchanged and every global batch ticks every shard's r.
  * STAGE (write buffer): each shard appends its owned lanes, in arrival
    order, to its own write buffer; shards flush independently.
  * LOOKUP: every shard answers every query; non-owners contribute 0/false,
    so the sum is the owner's answer (exact for negative payloads too).
  * COUNT / RANGE: each shard clips the windows to its range; counts add,
    `ok` holds only if it holds on every shard. RANGE stays shard-major until
    `assemble_range` compacts it into global rows.
  * CLEANUP / MAINTAIN / FLUSH: shard-local.
  * SIZE: per-shard survivor counts add (ranges are disjoint).
    BULK_BUILD: one sort of the keys, sliced at the shard boundaries.

The key space [0, MAX_USER_KEY] is split evenly; shard s owns
[s * range_size, (s+1) * range_size).

One controller over a tuple of devices (launch/mesh.py), where the reference
runs `shard_map` over a jax mesh: the sharded state is a tuple of `LSMState`,
shard s's on `mesh.devices[s]`, updated in place. Each shard's work runs on
its device in turn. A replicated input is copied once to each distinct
device, and the reference's psum/pmin combines reduce on the first shard's
device, in int32. The host values a call needs from every shard (the owned
counts of a stage or a bulk build) come back in one copy per call.

`dist_*` are the operations; `make_dist_*` bind (cfg, mesh) for direct core
users, as the reference's jitted factories do (no jit, no donation here).
"""

from __future__ import annotations

import contextlib
import dataclasses
import functools
from typing import Tuple

import torch

from repro_torch.core import semantics as sem
from repro_torch.core.cleanup import lsm_cleanup, lsm_maintain
from repro_torch.core.lsm import (
    LSMConfig,
    LSMState,
    all_runs,
    lsm_build_sorted,
    lsm_debt,
    lsm_flush,
    lsm_flush_cost,
    lsm_init,
    lsm_stage,
    lsm_update,
)
from repro_torch.core.queries import lsm_count, lsm_lookup, lsm_range, valid_count_runs
from repro_torch.kernels import ops

ShardedState = Tuple[LSMState, ...]


@dataclasses.dataclass(frozen=True)
class DistLSMConfig:
    local: LSMConfig          # per-shard LSM config (batch_size = global batch!)
    num_shards: int
    axis: str = "shard"

    @property
    def range_size(self) -> int:
        return (sem.PLACEBO_KEY + self.num_shards - 1) // self.num_shards


def owner_of(cfg: DistLSMConfig, keys) -> torch.Tensor:
    return torch.clamp(sem.as_int32(keys) // cfg.range_size, 0, cfg.num_shards - 1)


def shard_bounds(cfg: DistLSMConfig, shard: int):
    """Inclusive [lo, hi] key range owned by `shard`."""
    lo = shard * cfg.range_size
    return lo, lo + cfg.range_size - 1


def _on(device: torch.device):
    """Run a shard's kernels on its own card."""
    return torch.cuda.device(device) if device.type == "cuda" else contextlib.nullcontext()


def _shards(mesh, states):
    return enumerate(zip(mesh.devices, states))


def _replicate(mesh, *tensors):
    """Each input on the first shard's device, copied once to each other
    distinct shard device -> {device: tensors}."""
    first = tuple(sem.as_int32(t, mesh.devices[0]) for t in tensors)
    return {dev: tuple(t.to(dev) for t in first) for dev in dict.fromkeys(mesh.devices)}


def _sum_on(device, parts):
    """The reference's psum: per-shard tensors added on `device`, dtype kept."""
    return functools.reduce(torch.add, (p.to(device) for p in parts))


def _clip_windows(cfg: DistLSMConfig, shard: int, k1, k2):
    lo, hi = shard_bounds(cfg, shard)
    k1c = torch.clamp(k1, lo, hi + 1)
    k2c = torch.clamp(k2, lo - 1, hi)
    return k1c, k2c, k1c <= k2c


def dist_lsm_init(cfg: DistLSMConfig, mesh) -> ShardedState:
    """One empty LSM per shard, each on its shard's device."""
    return tuple(lsm_init(cfg.local, dev) for dev in mesh.devices)


# ---------------------------------------------------------------------------
# Operations (the facade's lsm_sharded backend calls these)
# ---------------------------------------------------------------------------


def dist_update(cfg: DistLSMConfig, mesh, states: ShardedState, key_vars, values) -> ShardedState:
    """Apply one b-wide encoded batch: each shard keeps its keys, placebos the
    rest, and runs the unchanged local binary-counter cascade. A shard that
    owns no lane still takes the batch (its r advances)."""
    copies = _replicate(mesh, key_vars, values)
    out = []
    for s, (dev, st) in _shards(mesh, states):
        kv, val = copies[dev]
        with _on(dev):
            mine = owner_of(cfg, sem.original_key(kv)) == s
            out.append(lsm_update(cfg.local, st, torch.where(mine, kv, sem.PLACEBO_KV),
                                  torch.where(mine, val, sem.EMPTY_VALUE)))
    return tuple(out)


def dist_stage(cfg: DistLSMConfig, mesh, states: ShardedState, key_vars, values, count: int) -> ShardedState:
    """Stage one encoded sub-batch into the shard-local write buffers.

    key_vars/values: int32[b] with the `count` real lanes at the front in
    arrival order (the facade's contract for `stage_encoded`). Each shard
    appends its owned lanes, in arrival order, to its own buffer; no batch
    slot is consumed until that shard's buffer overflows. A shard that owns
    no lane is left as it is (staging nothing changes no field).
    """
    b = cfg.local.batch_size
    count = int(count)
    if tuple(key_vars.shape) != (b,) or tuple(values.shape) != (b,):
        raise ValueError(f"sub-batch must have shape ({b},), got {tuple(key_vars.shape)}/{tuple(values.shape)}")
    if not 0 <= count <= b:
        raise ValueError(f"count must be in [0, {b}], got {count}")
    dev0 = mesh.devices[0]
    key_vars, values = sem.as_int32(key_vars, dev0), sem.as_int32(values, dev0)
    lane = torch.arange(b, device=dev0)
    owner = torch.where(lane < count, owner_of(cfg, sem.original_key(key_vars)).long(), cfg.num_shards)
    owned = torch.bincount(owner, minlength=cfg.num_shards + 1).tolist()  # one host read for all shards
    # A stable sort by owner gathers each shard's lanes, in arrival order.
    order = torch.sort(owner, stable=True).indices
    pk, pv = sem.placebo(b, dev0)
    kv, val = torch.cat([key_vars[order], pk]), torch.cat([values[order], pv])
    out, start = [], 0
    for s, (dev, st) in _shards(mesh, states):
        n = owned[s]
        if n:
            with _on(dev):
                st = lsm_stage(cfg.local, st, kv[start:start + b].to(dev), val[start:start + b].to(dev), n)
        out.append(st)
        start += n
    return tuple(out)


def dist_flush(cfg: DistLSMConfig, mesh, states: ShardedState, min_pending: int = 1) -> ShardedState:
    """Flush shard-local write buffers holding >= min_pending elements; shards
    flush independently, so ownership skew never makes an empty shard burn a
    batch slot."""
    out = []
    for _, (dev, st) in _shards(mesh, states):
        with _on(dev):
            out.append(lsm_flush(cfg.local, st, min_pending))
    return tuple(out)


def dist_pending(cfg: DistLSMConfig, mesh, states: ShardedState) -> int:
    """Write-buffer residents across shards."""
    return sum(st.buf_n for st in states)


def dist_occupancy(cfg: DistLSMConfig, mesh, states: ShardedState):
    """(pending, resident, debt) summed across shards: host ints for the
    first two, an int32 device scalar on the first shard's device for debt."""
    resident = sum(st.r * cfg.local.batch_size for st in states)
    debt = _sum_on(mesh.devices[0], [lsm_debt(cfg.local, st) for st in states])
    return dist_pending(cfg, mesh, states), resident, debt


def dist_flush_cost(cfg: DistLSMConfig, mesh, states: ShardedState) -> int:
    """Elements every shard's cascade would touch on a flush now, summed
    (shards flush independently, so the sum is the whole step's work)."""
    return sum(lsm_flush_cost(cfg.local, st) for st in states)


def dist_lookup(cfg: DistLSMConfig, mesh, states: ShardedState, keys):
    """lookup(states, keys[q]) -> (found[q], values[q]), on the first shard's device."""
    copies = _replicate(mesh, keys)
    hits, vals = [], []
    for s, (dev, st) in _shards(mesh, states):
        (q,) = copies[dev]
        with _on(dev):
            found, v = lsm_lookup(cfg.local, st, q)
            found = found & (owner_of(cfg, q) == s)
            hits.append(found.to(torch.int32))
            vals.append(torch.where(found, v, 0))
    # ⊥-identity combine: only the owner can report found and every other
    # shard adds 0, so the sum is the owner's value, negative ones included.
    dev0 = mesh.devices[0]
    return _sum_on(dev0, hits) > 0, _sum_on(dev0, vals)


def dist_count(cfg: DistLSMConfig, mesh, states: ShardedState, k1, k2, max_candidates: int):
    """count(states, k1[q], k2[q]) -> (counts[q], ok[q]).

    Each shard counts the intersection of [k1, k2] with its own range, so
    max_candidates applies per shard; the global count is the sum and `ok`
    holds only where every shard's does. A window that misses a shard's
    range counts 0 there and is ok.
    """
    copies = _replicate(mesh, k1, k2)
    counts, oks = [], []
    for s, (dev, st) in _shards(mesh, states):
        a, b = copies[dev]
        with _on(dev):
            k1c, k2c, nonempty = _clip_windows(cfg, s, a, b)
            c, ok = lsm_count(cfg.local, st, k1c, k2c, max_candidates)
            counts.append(torch.where(nonempty, c, 0))
            oks.append((ok | ~nonempty).to(torch.int32))
    dev0 = mesh.devices[0]
    return _sum_on(dev0, counts), _sum_on(dev0, oks) == len(oks)


def dist_range(cfg: DistLSMConfig, mesh, states: ShardedState, k1, k2, max_candidates: int, max_results: int):
    """range(states, k1[q], k2[q]) ->
    (keys [shards, q, max_results], vals, counts [shards, q], ok[q]).

    Results stay shard-major (keys ascending within a shard; shards ascending
    is globally ascending, since partitioning is by range). `assemble_range`
    gives the globally compacted rows.
    """
    copies = _replicate(mesh, k1, k2)
    parts = []
    for s, (dev, st) in _shards(mesh, states):
        a, b = copies[dev]
        with _on(dev):
            k1c, k2c, nonempty = _clip_windows(cfg, s, a, b)
            keys, vals, counts, ok = lsm_range(cfg.local, st, k1c, k2c, max_candidates, max_results)
            parts.append((keys, vals, torch.where(nonempty, counts, 0), (ok | ~nonempty).to(torch.int32)))
    dev0 = mesh.devices[0]
    keys, vals, counts = (torch.stack([p[i].to(dev0) for p in parts]) for i in range(3))
    return keys, vals, counts, _sum_on(dev0, [p[3] for p in parts]) == len(parts)


def assemble_range(keys, vals, counts, ok, max_results: int):
    """Shard-major range output -> the facade's global contract.

    keys/vals: [S, nq, m] per-shard compacted rows (ascending, placebo-padded
    past counts[s, q]); counts: [S, nq] exact per-shard hit counts; ok: [nq].
    Returns (keys [nq, max_results], vals, counts [nq], ok) with rows globally
    ascending and placebo-padded past counts[q]. Truncation (a global total
    past max_results, or a shard that clipped its own window) flips ok; rows
    are never dropped silently.
    """
    S, nq, m = keys.shape
    offsets = torch.cumsum(counts, 0) - counts              # exclusive, over shards
    total = counts.sum(0).to(torch.int32)
    ok = ok & (total <= max_results)
    j = torch.arange(m, device=keys.device)[None, None, :]
    tgt = offsets[:, :, None] + j
    # Column max_results is a drop slot: lanes past a shard's count and rows
    # past max_results (the reference's mode="drop" scatter).
    tgt = torch.where((j < counts[:, :, None]) & (tgt < max_results), tgt, max_results)
    tgt = tgt.permute(1, 0, 2).reshape(nq, S * m)
    out_k = torch.full((nq, max_results + 1), sem.PLACEBO_KEY, dtype=torch.int32, device=keys.device)
    out_v = torch.full((nq, max_results + 1), sem.EMPTY_VALUE, dtype=torch.int32, device=keys.device)
    out_k.scatter_(1, tgt, keys.permute(1, 0, 2).reshape(nq, S * m))
    out_v.scatter_(1, tgt, vals.permute(1, 0, 2).reshape(nq, S * m))
    return out_k[:, :max_results], out_v[:, :max_results], total, ok


def dist_cleanup(cfg: DistLSMConfig, mesh, states: ShardedState) -> ShardedState:
    """Shard-local cleanup."""
    out = []
    for _, (dev, st) in _shards(mesh, states):
        with _on(dev):
            out.append(lsm_cleanup(cfg.local, st))
    return tuple(out)


def dist_maintain(cfg: DistLSMConfig, mesh, states: ShardedState, budget: int | None = None, *,
                  only_if_debt: bool = False) -> ShardedState:
    """Shard-local budgeted maintenance. `budget` is the PER-SHARD element
    budget; shards carry independent debt (ownership skew), so each compacts,
    or skips with only_if_debt, on its own schedule."""
    out = []
    for _, (dev, st) in _shards(mesh, states):
        with _on(dev):
            out.append(lsm_maintain(cfg.local, st, budget, only_if_debt=only_if_debt))
    return tuple(out)


def dist_size(cfg: DistLSMConfig, mesh, states: ShardedState) -> torch.Tensor:
    """Live (visible) elements across all shards, int32 scalar on the first
    shard's device. Ranges are disjoint, so per-shard counts simply add."""
    parts = []
    for _, (dev, st) in _shards(mesh, states):
        with _on(dev):
            parts.append(valid_count_runs(all_runs(cfg.local, st)))
    return _sum_on(mesh.devices[0], parts)


def dist_bulk_build(cfg: DistLSMConfig, mesh, keys, values) -> ShardedState:
    """Build from n unique keys: each shard lays its owned subset out in the
    post-CLEANUP level layout (paper §5.2, per shard), with r = ceil(owned / b)
    resident batches, no debt and no overflow.

    The reference sorts the whole key set on every shard, with non-owned
    lanes as placebos, which sort last. Range partitioning makes each
    shard's owned keys one slice of the sorted keys, so here one sort is cut
    at the shard boundaries (one host read) and each slice is copied to its
    shard. Raises ValueError when n exceeds the per-shard capacity, before
    any shard builds: one shard may own every key.
    """
    dev0 = mesh.devices[0]
    keys = sem.as_int32(keys, dev0)
    values = sem.as_int32(values, dev0)
    n = keys.shape[0]
    cap = cfg.local.capacity
    if n > cap:
        raise ValueError(f"bulk build of {n} keys exceeds per-shard capacity {cap} (one shard may own every key)")
    kv, vals = ops.sort_pairs(sem.encode_insert(keys), values)
    # The first key variable of shard s's range is lo_s << 1 (a tombstone's).
    firsts = torch.tensor([shard_bounds(cfg, s)[0] << 1 for s in range(1, cfg.num_shards)],
                          dtype=torch.int32, device=dev0)
    cuts = [0] + torch.searchsorted(kv, firsts).tolist() + [n]
    out = []
    for s, dev in enumerate(mesh.devices):
        with _on(dev):
            out.append(lsm_build_sorted(cfg.local, kv[cuts[s]:cuts[s + 1]].to(dev),
                                        vals[cuts[s]:cuts[s + 1]].to(dev)))
    return tuple(out)


# ---------------------------------------------------------------------------
# Bound factories (the reference's standalone surface)
# ---------------------------------------------------------------------------


def make_dist_update(cfg: DistLSMConfig, mesh):
    """update(states, key_vars[b], values[b]) -> states."""
    return functools.partial(dist_update, cfg, mesh)


def make_dist_lookup(cfg: DistLSMConfig, mesh):
    """lookup(states, keys[q]) -> (found[q], values[q])."""
    return functools.partial(dist_lookup, cfg, mesh)


def make_dist_count(cfg: DistLSMConfig, mesh, max_candidates: int):
    """count(states, k1[q], k2[q]) -> (counts[q], ok[q])."""
    return functools.partial(dist_count, cfg, mesh, max_candidates=max_candidates)


def make_dist_range(cfg: DistLSMConfig, mesh, max_candidates: int, max_results: int):
    """Shard-major range(states, k1[q], k2[q])."""
    return functools.partial(dist_range, cfg, mesh, max_candidates=max_candidates, max_results=max_results)


def make_dist_cleanup(cfg: DistLSMConfig, mesh):
    """cleanup(states) -> states (shard-local)."""
    return functools.partial(dist_cleanup, cfg, mesh)


def make_dist_maintain(cfg: DistLSMConfig, mesh, budget: int | None = None):
    """maintain(states) -> states (shard-local)."""
    return functools.partial(dist_maintain, cfg, mesh, budget=budget)


def make_dist_stage(cfg: DistLSMConfig, mesh):
    """stage(states, key_vars[b], values[b], count) -> states."""
    return functools.partial(dist_stage, cfg, mesh)


def make_dist_flush(cfg: DistLSMConfig, mesh):
    """flush(states) -> states (shard-local)."""
    return functools.partial(dist_flush, cfg, mesh)


def make_dist_size(cfg: DistLSMConfig, mesh):
    """size(states) -> int32 scalar (live elements, all shards)."""
    return functools.partial(dist_size, cfg, mesh)
