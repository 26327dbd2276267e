"""`Dictionary`: the facade over the dictionary backends, on device tensors.

* **The card by default.** `Dictionary.create(..., device=None)` places the
  state on "cuda" and raises when there is no CUDA device; the CPU is used
  only when the caller passes `device="cpu"` (as the tests do).

* **Linear handles.** Mutators update the state in place and return a NEW
  handle; the receiving handle is consumed, and any later use of it raises
  `ConsumedHandleError` (the counterpart of JAX's "Array has been deleted"
  after buffer donation in repro.api.dictionary).

* **Coalescing batch contract.** Updates of any length are encoded, their
  real lanes compacted to the front in arrival order (`valid=` masks lanes
  out), and split into b-wide sub-batches that feed the backend's write
  buffer. Each sub-batch carries its real-lane count, computed on the host,
  so an update never waits on the device. Duplicate keys resolve in strict
  arrival order (docs/DESIGN.md §5).

* **Key-domain validation.** Keys outside [0, MAX_USER_KEY] raise
  `KeyDomainError` at the boundary (skipped with `validate=False`).
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from repro_torch.api.backend import Backend, CapabilityError, KeyDomainError, get_backend_class
from repro_torch.api.plan import QueryPlan
from repro_torch.core import semantics as sem
from repro_torch.core.lsm import compact_real


class ConsumedHandleError(RuntimeError):
    """A mutator already consumed this `Dictionary` handle."""


def resolve_device(device) -> torch.device:
    """None means the card; a CUDA device must exist unless "cpu" was asked for."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "repro_torch runs on a CUDA device and none is available; "
            "pass device='cpu' to run the plain PyTorch versions on the CPU"
        )
    return dev


def _host_array(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return x.detach().cpu().numpy()
    return np.asarray(x)


def _check_key_domain(name: str, keys, valid=None) -> None:
    """Raise KeyDomainError for keys outside [0, MAX_USER_KEY], on the input
    as given (before any int32 cast, so overflow cannot wrap a bad key into
    range). Lanes masked out by `valid` are exempt. A tensor is checked on
    its own device, so a bulk build on the card copies no keys to the host."""
    if isinstance(keys, torch.Tensor):
        if keys.dtype.is_floating_point or keys.dtype.is_complex or keys.dtype == torch.bool:
            raise KeyDomainError(f"{name} must be an integer tensor, got dtype {keys.dtype}")
        wide = keys.to(torch.int64)
        bad = (wide < 0) | (wide > sem.MAX_USER_KEY)
        if valid is not None:
            bad &= torch.as_tensor(_host_array(valid).astype(bool), device=keys.device).reshape(bad.shape)
        wide = wide[bad]
        if wide.numel() == 0:
            return
        examples = wide[:5].tolist()
    else:
        a = np.asarray(keys)
        if a.dtype.kind not in "iu":
            raise KeyDomainError(f"{name} must be an integer array, got dtype {a.dtype}")
        wide = a.astype(np.int64)
        bad = (wide < 0) | (wide > sem.MAX_USER_KEY)
        if valid is not None:
            bad = bad & _host_array(valid).astype(bool)
        if not bad.any():
            return
        examples = np.asarray(a[bad]).ravel()[:5].tolist()
    raise KeyDomainError(
        f"{name} outside the key domain [0, {sem.MAX_USER_KEY}]: {examples} — "
        "out-of-domain keys alias the placebo key or flip sign under the "
        "status-bit encoding and would silently corrupt ordering"
    )


def _as_tensor(x, dtype, device) -> torch.Tensor:
    if isinstance(x, torch.Tensor):
        return x.to(device=device, dtype=dtype)
    np_dtype = {torch.int32: np.int32, torch.bool: np.bool_}[dtype]
    return torch.from_numpy(np.asarray(x).astype(np_dtype)).to(device)


def _as_keys(name: str, x, device) -> torch.Tensor:
    t = _as_tensor(x, torch.int32, device)
    if t.dim() == 0:
        t = t[None]
    if t.dim() != 1:
        raise ValueError(f"{name} must be 1-D, got shape {tuple(t.shape)}")
    return t.contiguous()


def _lanes(name: str, x, n: int, dtype, device) -> torch.Tensor:
    t = _as_tensor(x, dtype, device)
    if t.dim() == 0:
        t = t.expand(n)
    if t.shape != (n,):
        raise ValueError(f"{name} must have shape ({n},), got {tuple(t.shape)}")
    return t.contiguous()


class Dictionary:
    """A dynamic dictionary handle: create once, thread through updates.

        d = Dictionary.create("lsm", capacity=1 << 20)
        d = d.insert(keys, values)      # consumes d; keep the returned handle
        found, vals = d.lookup(queries)
    """

    __slots__ = ("_backend", "_state", "_validate", "_flush_threshold",
                 "_maintenance_budget", "_consumed")

    def __init__(self, backend: Backend, state, validate: bool = True,
                 flush_threshold: Optional[int] = None,
                 maintenance_budget: Optional[int] = None):
        self._backend = backend
        self._state = state
        self._validate = validate
        self._flush_threshold = flush_threshold
        self._maintenance_budget = maintenance_budget
        self._consumed = False

    @classmethod
    def create(cls, backend: str = "lsm", validate: bool = True,
               flush_threshold: Optional[int] = None,
               maintenance_budget: Optional[int] = None, device=None,
               **options) -> "Dictionary":
        """Empty dictionary. Options as in repro.api.Dictionary.create
        (capacity, batch_size, num_levels; for "cuckoo" load_factor, seed and
        max_rounds), plus `device` (default: the card).

        `flush_threshold`: after every update, a write buffer holding >= this
        many staged elements is flushed. `maintenance_budget`: piggyback
        budgeted compaction on every update/flush, skipped when the debt of
        the prefix is zero.
        """
        be = get_backend_class(backend).from_options(device=resolve_device(device), **options)
        if flush_threshold is not None:
            t = int(flush_threshold)
            if not 1 <= t <= be.batch_size:
                raise ValueError(
                    f"flush_threshold must be in [1, batch_size={be.batch_size}], got {t}"
                )
            flush_threshold = t
        if maintenance_budget is not None:
            if not be.caps.supports_maintenance:
                raise CapabilityError(be._no("maintain"))
            m = int(maintenance_budget)
            if m < 1:
                raise ValueError(f"maintenance_budget must be >= 1, got {m}")
            maintenance_budget = m
        return cls(be, be.init(), validate, flush_threshold, maintenance_budget)

    # -- introspection -------------------------------------------------------

    @property
    def backend(self) -> str:
        return self._backend.name

    @property
    def capabilities(self):
        return self._backend.caps

    @property
    def capacity(self) -> int:
        return self._backend.capacity

    @property
    def batch_size(self) -> int:
        return self._backend.batch_size

    @property
    def device(self) -> torch.device:
        return self._backend.device

    @property
    def num_shards(self) -> int:
        """Device partitions behind this handle (1 unless the backend is sharded)."""
        return self._backend.num_shards

    @property
    def buffered(self) -> bool:
        """Does this backend stage updates in a write buffer (pending and
        flush meaningful)? False for apply-at-once backends."""
        return self._backend.has_write_buffer

    @property
    def state(self):
        """The underlying core state (LSMState, SAState or CuckooTable)."""
        return self._live()

    def __repr__(self) -> str:
        return (
            f"Dictionary(backend={self._backend.name!r}, capacity={self.capacity}, "
            f"batch_size={self.batch_size}, device={str(self.device)!r})"
        )

    # -- handle discipline ---------------------------------------------------

    def _live(self):
        if self._consumed:
            raise ConsumedHandleError(
                "this Dictionary handle was consumed by a mutator; use the handle it returned"
            )
        return self._state

    def _evolve(self, new_state) -> "Dictionary":
        self._consumed = True
        return Dictionary(self._backend, new_state, self._validate,
                          self._flush_threshold, self._maintenance_budget)

    def _require(self, op: str, flag: bool) -> None:
        if not flag:
            raise CapabilityError(self._backend._no(op))

    def _piggyback_maintain(self, state):
        if self._maintenance_budget is not None:
            state = self._backend.maintain_state(state, self._maintenance_budget, only_if_debt=True)
        return state

    # -- updates -------------------------------------------------------------

    def update(self, keys, values=None, is_delete=None, valid=None) -> "Dictionary":
        """Mixed batch of any length: insert where ~is_delete, tombstone where
        is_delete; `valid=False` lanes are dropped. The later lane or call
        wins on duplicate keys. Returns the new handle."""
        state = self._live()
        be = self._backend
        self._require("update", be.caps.supports_updates)
        if self._validate:
            _check_key_domain("update keys", keys, valid)
        dev = self.device
        keys = _as_keys("keys", keys, dev)
        n = keys.shape[0]
        if n == 0:
            return self
        is_delete = (torch.zeros(n, dtype=torch.bool, device=dev) if is_delete is None
                     else _lanes("is_delete", is_delete, n, torch.bool, dev))
        if not be.caps.supports_deletes and bool(is_delete.any()):
            self._require("delete", False)
        values = (torch.zeros(n, dtype=torch.int32, device=dev) if values is None
                  else _lanes("values", values, n, torch.int32, dev))

        kv = sem.encode(keys, is_delete)
        vals = torch.where(is_delete, sem.EMPTY_VALUE, values)
        if valid is not None:
            valid = _host_array(valid).astype(bool).reshape(-1)
            if valid.shape != (n,):
                raise ValueError(f"valid must have shape ({n},), got {valid.shape}")
            kv, vals, _ = compact_real(kv, vals, torch.from_numpy(valid).to(dev))
            total_real = int(valid.sum())
        else:
            total_real = n
        b = be.batch_size
        pad = -n % b
        if pad:
            pk, pv = sem.placebo(pad, dev)
            kv, vals = torch.cat([kv, pk]), torch.cat([vals, pv])
        # A chunk with no real lanes would leave the buffer as it is.
        for i in range(-(-total_real // b)):
            count = min(total_real - i * b, b)
            state = be.stage_encoded(state, kv[i * b:(i + 1) * b], vals[i * b:(i + 1) * b], count)
        if self._flush_threshold is not None:
            state = be.flush_state(state, self._flush_threshold)
        return self._evolve(self._piggyback_maintain(state))

    def insert(self, keys, values, valid=None) -> "Dictionary":
        """Insert (key, value) pairs; newer values win on duplicate keys."""
        return self.update(keys, values, valid=valid)

    def delete(self, keys, valid=None) -> "Dictionary":
        """Delete keys via tombstones (paper §3.3)."""
        self._require("delete", self._backend.caps.supports_deletes)
        return self.update(keys, is_delete=True, valid=valid)

    def bulk_build(self, keys, values) -> "Dictionary":
        """Replace the contents with n unique keys in one sort-and-segment
        pass (paper §5.2). n need not be a multiple of batch_size. Keys
        outside the domain raise KeyDomainError and duplicate keys ValueError
        (both skipped with `validate=False`); values are cast to int32."""
        self._live()
        self._require("bulk_build", self._backend.caps.supports_bulk_build)
        if self._validate:
            _check_key_domain("bulk_build keys", keys)
        keys = _as_keys("keys", keys, self.device)
        if self._validate and torch.unique(keys).shape[0] != keys.shape[0]:
            raise ValueError("bulk_build requires unique keys (paper §5.2)")
        values = _lanes("values", values, keys.shape[0], torch.int32, self.device)
        return self._evolve(self._backend.bulk_build(keys, values))

    def cleanup(self) -> "Dictionary":
        """Purge stale elements and tombstones (paper §3.6/§4.5), folding the
        write buffer in."""
        state = self._live()
        self._require("cleanup", self._backend.caps.supports_cleanup)
        return self._evolve(self._backend.cleanup(state))

    def maintain(self, budget: Optional[int] = None) -> "Dictionary":
        """Budgeted incremental compaction touching at most `budget`
        residents; None takes the handle's maintenance_budget, and without
        one it is a full cleanup."""
        state = self._live()
        self._require("maintain", self._backend.caps.supports_maintenance)
        if budget is None:
            budget = self._maintenance_budget
        else:
            budget = int(budget)
            if budget < 1:
                raise ValueError(f"maintain budget must be >= 1, got {budget}")
        return self._evolve(self._backend.maintain_state(state, budget))

    def flush(self) -> "Dictionary":
        """Push staged (write-buffer) updates into the main structure."""
        state = self._backend.flush_state(self._live())
        return self._evolve(self._piggyback_maintain(state))

    def pending(self) -> int:
        """Staged-but-unflushed element count."""
        return self._backend.pending_count(self._live())

    def occupancy(self):
        """OccupancyStats(pending, resident, debt)."""
        return self._backend.occupancy(self._live())

    def flush_cost_estimate(self) -> int:
        """Elements a `flush()` would touch now (0 when nothing is staged)."""
        return self._backend.flush_cost(self._live())

    # -- queries -------------------------------------------------------------

    def lookup(self, keys):
        """Batched LOOKUP -> (found: bool[nq], values: int32[nq])."""
        state = self._live()
        if self._validate:
            _check_key_domain("lookup keys", keys)
        return self._backend.lookup(state, _as_keys("keys", keys, self.device))

    def _window(self, op: str, k1, k2, plan: Optional[QueryPlan]):
        self._require(op, self._backend.caps.supports_ordered_queries)
        if self._validate:
            _check_key_domain(f"{op} k1", k1)
            _check_key_domain(f"{op} k2", k2)
        plan = (plan or QueryPlan()).resolved(self._backend.max_query_candidates)
        return _as_keys("k1", k1, self.device), _as_keys("k2", k2, self.device), plan

    def count(self, k1, k2, plan: Optional[QueryPlan] = None):
        """COUNT(k1, k2) -> (counts: int32[nq], ok: bool[nq]); ok=False flags
        truncation by the plan."""
        state = self._live()
        k1, k2, plan = self._window("count", k1, k2, plan)
        return self._backend.count(state, k1, k2, plan)

    def range(self, k1, k2, plan: Optional[QueryPlan] = None):
        """RANGE(k1, k2) -> (keys [nq, max_results], values, counts, ok);
        rows ascending by key, placebo-padded beyond counts."""
        state = self._live()
        k1, k2, plan = self._window("range", k1, k2, plan)
        return self._backend.range(state, k1, k2, plan)

    def size(self):
        """Live (visible) element count, int32 scalar tensor."""
        return self._backend.size(self._live())

    def overflowed(self) -> bool:
        """Did any update exceed the static capacity?"""
        return self._backend.overflowed(self._live())
