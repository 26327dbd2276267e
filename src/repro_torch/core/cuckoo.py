"""Static cuckoo hash table baseline (paper §5.1; Alcantara et al. 2009), on
device tensors (PyTorch counterpart of repro.core.cuckoo).

Bulk-synchronous parallel build in the style of the CUDPP GPU cuckoo table
the paper benchmarks against: every unplaced key claims a slot for its
current hash choice; the winner per slot is the largest round-permuted id (a
scatter-max); losers, and evicted previous occupants, advance to their next
of 4 hash functions and retry next round. The loop state is one slot -> key
id ownership table; keys and values are gathered from it once at the end.

Like the reference it is plain tensor code (no hand-written kernel): the
reference is plain JAX. The reference computes its hashes in uint32; here
they are int64 masked to the low 32 bits after every multiply-add (a 64-bit
multiply wraps mod 2^64, which keeps the low 32 bits exact), and the four
candidate slots of every key are kept as int32 (`table_size < 2^31`).

Immutable once built, O(1) lookups, no ordered (count/range) queries: the
point of the paper's Table 1 comparison.
"""

from __future__ import annotations

import dataclasses

import torch

EMPTY = -1
_NUM_HASHES = 4
_HASH_A = (2654435761, 2246822519, 3266489917, 668265263)
_HASH_C = (374761393, 3242174893, 1540483477, 2654435769)
_U32 = 0xFFFFFFFF


@dataclasses.dataclass(frozen=True)
class CuckooConfig:
    table_size: int          # number of slots (n / load_factor)
    max_rounds: int = 64
    seed: int = 0            # hash-family seed


@dataclasses.dataclass
class CuckooTable:
    slot_keys: torch.Tensor  # int32[table_size], EMPTY where unoccupied
    slot_vals: torch.Tensor  # int32[table_size]
    build_ok: bool           # every key placed
    rounds: int = 0          # build rounds run (not a field of the reference's table)


def _seed_term(cfg: CuckooConfig) -> int:
    """`uint32(seed * 0x85EBCA6B)` as the reference computes it: a product
    outside uint32 raises OverflowError there (every seed >= 2 and every
    negative seed), so it raises here too."""
    s = cfg.seed * 0x85EBCA6B
    if not 0 <= s <= _U32:
        raise OverflowError(f"Python integer {s} out of bounds for uint32")
    return s


def _hash_one(cfg: CuckooConfig, keys: torch.Tensor, i: int) -> torch.Tensor:
    """Hash function i of every key -> int32 slot indices."""
    k = (keys.to(torch.int64) & _U32) ^ _seed_term(cfg)
    h = (k * _HASH_A[i] + _HASH_C[i]) & _U32
    return ((h ^ (h >> 15)) % cfg.table_size).to(torch.int32)


def _hash(cfg: CuckooConfig, keys, which) -> torch.Tensor:
    """which: int32 tensor selecting one of the 4 hash functions per key."""
    keys = torch.as_tensor(keys, dtype=torch.int32)
    which = torch.as_tensor(which, device=keys.device)
    h = torch.zeros(keys.shape, dtype=torch.int32, device=keys.device)
    for i in range(_NUM_HASHES):
        h = torch.where(which == i, _hash_one(cfg, keys, i), h)
    return h


def cuckoo_build(cfg: CuckooConfig, keys, values) -> CuckooTable:
    """Bulk build on the keys' device. Keys must be unique and non-negative.
    Runs rounds until every key is placed or `max_rounds` ran; `build_ok`
    says which. An empty key set gives an empty table."""
    keys = torch.as_tensor(keys, dtype=torch.int32)
    device = keys.device
    values = torch.as_tensor(values, dtype=torch.int32, device=device)
    n = keys.shape[0]
    m = cfg.table_size
    slot_owner = torch.full((m,), EMPTY, dtype=torch.int32, device=device)
    if n == 0:
        _seed_term(cfg)
        return CuckooTable(slot_owner, torch.zeros(m, dtype=torch.int32, device=device), True)
    ids = torch.arange(n, dtype=torch.int32, device=device)
    all_h = torch.stack([_hash_one(cfg, keys, j) for j in range(_NUM_HASHES)])  # int32[4, n]
    attempt = torch.zeros(n, dtype=torch.int32, device=device)
    placed = torch.zeros(n, dtype=torch.bool, device=device)
    it = 0
    while it < cfg.max_rounds and not bool(placed.all()):
        h = all_h.gather(0, (attempt % _NUM_HASHES).long()[None])[0].long()
        # Claim contested slots: the winner is the largest round-permuted id,
        # so the victor varies between rounds. The reference's int32 product
        # wraps before the mask; its low 30 bits are the exact product's.
        tid = ids ^ ((it * 0x9E3779B) & 0x3FFFFFFF)
        claims = torch.full((m,), EMPTY, dtype=torch.int32, device=device)
        claims.scatter_reduce_(0, h, torch.where(placed, EMPTY, tid), "amax", include_self=True)
        won = ~placed & (claims[h] == tid)
        # tid is a bijection of the ids, so a slot has at most one winner.
        slot_owner[h[won]] = ids[won]
        # A key is placed iff it survives in one of its 4 candidate slots.
        placed = slot_owner[all_h[0].long()] == ids
        for j in range(1, _NUM_HASHES):
            placed |= slot_owner[all_h[j].long()] == ids
        attempt = torch.where(placed, attempt, attempt + 1)
        it += 1
    occupied = slot_owner >= 0
    owner_c = slot_owner.clamp(0, n - 1).long()
    slot_keys = torch.where(occupied, keys[owner_c], EMPTY)
    slot_vals = torch.where(occupied, values[owner_c], 0)
    return CuckooTable(slot_keys, slot_vals, bool(placed.all()), it)


def cuckoo_lookup(cfg: CuckooConfig, table: CuckooTable, query_keys):
    """Probe all 4 slots per query. Returns (found: bool, values: int32)."""
    q = torch.as_tensor(query_keys, dtype=torch.int32, device=table.slot_keys.device)
    found = torch.zeros(q.shape, dtype=torch.bool, device=q.device)
    vals = torch.zeros(q.shape, dtype=torch.int32, device=q.device)
    for i in range(_NUM_HASHES):
        h = _hash_one(cfg, q, i).long()
        hit = table.slot_keys[h] == q
        vals = torch.where(hit & ~found, table.slot_vals[h], vals)
        found = found | hit
    return found, vals
