"""LSM-backed paged KV cache: the paper's dictionary as a serving feature
(PyTorch counterpart of repro.serve.kvcache).

Paged attention needs a *mutable* mapping from logical pages (sequence,
page_index) to physical page slots. Here it is device-resident behind the
`Dictionary` facade:

  admission   = index.insert of (page_key -> slot)
  eviction    = index.delete (tombstones; the slots return to the free list)
  translation = bulk index.lookup (one per attention step)
  scans       = index.count/range over a sequence's key range

Ragged admissions stage in the facade's write buffer, so a small
`pt_allocate`/`pt_evict` call does not burn one of the LSM's 2^L - 1 batch
slots; `pt_flush` forces the buffer down, `pt_compact` runs CLEANUP and
`pt_maintain` budgeted compaction.

Keys pack (seq_id, page_idx) into the 30-bit user key space:
key = seq_id * MAX_PAGES_PER_SEQ + page_idx, so one sequence's pages are a
contiguous key range. The page payload lives in a separate dense pool; this
module manages only the index and the free list, which are tensors on the
index's device.
"""

from __future__ import annotations

import dataclasses
from typing import NamedTuple, Optional

import numpy as np
import torch

from repro_torch.api import Dictionary, QueryPlan
from repro_torch.core import semantics as sem

MAX_PAGES_PER_SEQ = 1 << 12  # 4096 pages/sequence (x page_size tokens)


@dataclasses.dataclass(frozen=True)
class PageTableConfig:
    num_pages: int                 # physical slots in the KV pool
    update_batch: int = 256        # index batch size b (sub-batches stage)
    num_levels: int = 12
    backend: str = "lsm"           # any Dictionary backend with update support
    flush_threshold: int | None = None  # facade flush policy (None: overflow-only)
    # Budgeted compaction piggybacked on every pt_allocate / pt_evict
    # (debt-gated); None: compact explicitly.
    maintenance_budget: int | None = None
    device: Optional[object] = None  # None: the card

    def make_index(self) -> Dictionary:
        # validate=False: keys come from page_key(), never user input.
        return Dictionary.create(
            self.backend, batch_size=self.update_batch, num_levels=self.num_levels,
            validate=False, flush_threshold=self.flush_threshold,
            maintenance_budget=self.maintenance_budget, device=self.device,
        )


class PageTableState(NamedTuple):
    index: Dictionary              # logical page -> physical slot
    free_count: torch.Tensor       # int32[] — free slots remaining
    free_list: torch.Tensor        # int32[num_pages] — stack of free slot ids

    @property
    def lsm(self):
        """The raw core state behind the facade."""
        return self.index.state


def page_key(seq_ids, page_idxs):
    seq_ids = sem.as_int32(seq_ids)
    return seq_ids * MAX_PAGES_PER_SEQ + sem.as_int32(page_idxs, seq_ids.device)


def _on(x, device, dtype=torch.int32) -> torch.Tensor:
    return torch.as_tensor(x, dtype=dtype, device=device)


def pt_init(cfg: PageTableConfig) -> PageTableState:
    index = cfg.make_index()
    device = index.device
    return PageTableState(
        index=index,
        free_count=torch.tensor(cfg.num_pages, dtype=torch.int32, device=device),
        free_list=torch.arange(cfg.num_pages - 1, -1, -1, dtype=torch.int32, device=device),
    )


def pt_allocate(cfg: PageTableConfig, state: PageTableState, seq_ids, page_idxs, valid):
    """Allocate physical slots for up to `update_batch` logical pages.

    valid: bool mask (invalid lanes are dropped). Returns (state, slots) with
    slots[i] = -1 where invalid.
    """
    device = state.free_list.device
    valid = _on(valid, device, torch.bool)
    v = valid.to(torch.int32)
    n_alloc = v.sum(dtype=torch.int32)
    # Pop slots from the free-list stack.
    pos = state.free_count - 1 - torch.cumsum(v, 0, dtype=torch.int32) + v
    pos = torch.where(valid, pos, 0)
    slots = torch.where(valid, state.free_list[pos.clamp(0, cfg.num_pages - 1).long()], -1)
    keys = page_key(_on(seq_ids, device), _on(page_idxs, device))
    index = state.index.insert(keys, slots, valid=valid)
    return PageTableState(index, state.free_count - n_alloc, state.free_list), slots


def pt_lookup(cfg: PageTableConfig, state: PageTableState, seq_ids, page_idxs):
    """Translate logical pages -> physical slots. Returns (found, slots)."""
    del cfg
    device = state.free_list.device
    return state.index.lookup(page_key(_on(seq_ids, device), _on(page_idxs, device)))


def pt_evict(cfg: PageTableConfig, state: PageTableState, seq_ids, page_idxs, valid):
    """Tombstone up to `update_batch` pages and push their slots back."""
    device = state.free_list.device
    keys = page_key(_on(seq_ids, device), _on(page_idxs, device))
    found, slots = state.index.lookup(keys)
    valid = _on(valid, device, torch.bool) & found
    index = state.index.delete(keys, valid=valid)
    v = valid.to(torch.int32)
    n_freed = v.sum(dtype=torch.int32)
    pos = state.free_count + torch.cumsum(v, 0, dtype=torch.int32) - 1
    # Push the freed slots; a position outside the list is dropped.
    push = valid & (pos >= 0) & (pos < cfg.num_pages)
    free_list = state.free_list.clone()
    free_list[pos[push].long()] = slots[push]
    return PageTableState(index, state.free_count + n_freed, free_list)


def _seq_windows(seq_ids, device):
    seq_ids = _on(seq_ids, device)
    k1 = page_key(seq_ids, torch.zeros_like(seq_ids))
    k2 = page_key(seq_ids, torch.full_like(seq_ids, MAX_PAGES_PER_SEQ - 1))
    return k1, k2


def pt_seq_page_count(cfg: PageTableConfig, state: PageTableState, seq_ids,
                      max_candidates: int = 1 << 13):
    """COUNT over a sequence's contiguous key range: live pages per sequence."""
    del cfg
    k1, k2 = _seq_windows(seq_ids, state.free_list.device)
    return state.index.count(k1, k2, QueryPlan(max_candidates=max_candidates))


def pt_seq_pages(cfg: PageTableConfig, state: PageTableState, seq_ids,
                 max_pages: int, max_candidates: int = 1 << 13):
    """RANGE over a sequence's key range: its pages in order."""
    del cfg
    k1, k2 = _seq_windows(seq_ids, state.free_list.device)
    keys, slots, counts, ok = state.index.range(
        k1, k2, QueryPlan(max_candidates=max_candidates, max_results=max_pages)
    )
    page_idx = torch.where(keys != sem.PLACEBO_KEY, keys % MAX_PAGES_PER_SEQ, -1)
    return page_idx, slots, counts, ok


def pt_flush(cfg: PageTableConfig, state: PageTableState) -> PageTableState:
    """Force staged admissions/evictions out of the write buffer. Translations
    never need it: staged pages are visible to lookup/count/range."""
    del cfg
    return PageTableState(state.index.flush(), state.free_count, state.free_list)


def pt_compact(cfg: PageTableConfig, state: PageTableState) -> PageTableState:
    """Paper CLEANUP: purge tombstoned translations, shrink levels."""
    del cfg
    return PageTableState(state.index.cleanup(), state.free_count, state.free_list)


def pt_maintain(cfg: PageTableConfig, state: PageTableState,
                budget: int | None = None) -> PageTableState:
    """Budgeted compaction of the index, touching at most `budget` resident
    translations (default: cfg.maintenance_budget; None: a full cleanup)."""
    if budget is None:
        budget = cfg.maintenance_budget
    return PageTableState(state.index.maintain(budget), state.free_count, state.free_list)


# -- the page table as a server tenant ----------------------------------------


class _MappedTicket:
    """A server Ticket with a transform applied to its result."""

    __slots__ = ("_inner", "_fn")

    def __init__(self, inner, fn):
        self._inner = inner
        self._fn = fn

    def result(self):
        return self._fn(self._inner.result())


class ServerPageTable:
    """The KV page table as one tenant of a `DictionaryServer`.

    It registers the tenant namespace ``seq_id * pages_per_seq + page_idx``,
    submits ragged ops, and lets the scheduler coalesce them with every other
    tenant's traffic. The free list lives on the host (slot choice is a host
    decision made at submit time); only the mapping is device state.
    `allocate` returns the slots at once plus the update ticket; `evict`
    resolves a lookup through the server, then tombstones the found keys.
    Flush and compaction policy belong to the server.
    """

    def __init__(self, server, num_pages: int, name: str = "kvcache",
                 num_seqs: int = 256, pages_per_seq: int = MAX_PAGES_PER_SEQ):
        self.server = server
        self.name = name
        self.num_pages = int(num_pages)
        self.pages_per_seq = int(pages_per_seq)
        self.num_seqs = int(num_seqs)
        # May raise KeyDomainError: the shared key space is a real resource.
        self.tenant = server.register_tenant(name, key_space=self.num_seqs * self.pages_per_seq)
        self._free = list(range(self.num_pages - 1, -1, -1))

    def _keys(self, seq_ids, page_idxs) -> np.ndarray:
        s = np.asarray(seq_ids, np.int64)
        p = np.asarray(page_idxs, np.int64)
        if (s >= self.num_seqs).any():
            raise ValueError(f"seq_id >= num_seqs={self.num_seqs}; widen the tenant")
        return s * self.pages_per_seq + p

    @property
    def free_count(self) -> int:
        return len(self._free)

    def allocate(self, seq_ids, page_idxs):
        """Admit logical pages: pop physical slots on the host and queue the
        (page -> slot) inserts. Returns (slots, ticket); the slots are usable
        at once, the ticket resolves when the insert's step has run."""
        keys = self._keys(seq_ids, page_idxs)
        n = len(keys)
        if n > len(self._free):
            raise RuntimeError(f"KV pool exhausted: need {n} pages, {len(self._free)} free")
        slots = np.asarray([self._free.pop() for _ in range(n)], np.int32)
        ticket = self.server.submit_update(self.name, keys, slots)
        return slots, ticket

    def lookup(self, seq_ids, page_idxs):
        """Translate logical pages -> slots; the ticket resolves to (found, slots)."""
        return self.server.submit_lookup(self.name, self._keys(seq_ids, page_idxs))

    def evict(self, seq_ids, page_idxs) -> int:
        """Retire pages: resolve a translation through the server, push the
        found slots back onto the free list, tombstone the found keys.
        Returns the number of pages freed."""
        keys = self._keys(seq_ids, page_idxs)
        found, slots = self.server.submit_lookup(self.name, keys).result()
        freed = np.asarray(slots)[np.asarray(found)]
        self._free.extend(int(s) for s in freed)
        live = keys[np.asarray(found)]
        if len(live):
            self.server.submit_update(self.name, live, np.zeros(len(live), np.int32),
                                      is_delete=np.ones(len(live), bool))
        return len(freed)

    def seq_page_count(self, seq_ids):
        """COUNT over each sequence's key range; ticket -> (counts, ok)."""
        s = np.asarray(seq_ids, np.int64)
        return self.server.submit_count(
            self.name, self._keys(s, np.zeros_like(s)),
            self._keys(s, np.full_like(s, self.pages_per_seq - 1)))

    def seq_pages(self, seq_ids, max_pages: int):
        """RANGE over each sequence's key range; ticket ->
        (page_idx[n, max_pages] with -1 padding, slots, counts, ok)."""
        s = np.asarray(seq_ids, np.int64)
        inner = self.server.submit_range(
            self.name, self._keys(s, np.zeros_like(s)),
            self._keys(s, np.full_like(s, self.pages_per_seq - 1)),
            max_results=max_pages)

        def decode(res):
            keys, slots, counts, ok = res
            page_idx = np.where(keys != sem.PLACEBO_KEY, keys % self.pages_per_seq, -1)
            return page_idx, slots, counts, ok

        return _MappedTicket(inner, decode)
