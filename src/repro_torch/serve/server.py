"""`DictionaryServer`: continuous batching for many tenants' op streams
(PyTorch counterpart of repro.serve.server; docs/DESIGN.md §12).

The paper's rates are *batched* rates, but clients arrive as thousands of
logical streams issuing a handful of ops each (a decode step admitting one
KV page, a prefill admitting a burst, an eviction sweep tombstoning a
sequence). One server multiplexes every client's small ops into large
coalesced device steps against a single shared `Dictionary`.

* **Tenant namespacing.** Each client registers a *tenant*: a named,
  contiguous extent of the shared 30-bit key space. Tenant-local keys in
  ``[0, key_space)`` pack to ``base + key``. Registration raises
  `KeyDomainError` when the extent would overflow `MAX_USER_KEY`;
  deregistration tombstones the tenant's key range and returns the extent to
  a free list. Extents are disjoint, so ops of different tenants commute: the
  scheduler may reorder across tenants and keeps each tenant's program order.

* **Op queue and coalescing scheduler.** `submit_*` enqueues host-side
  (numpy) and returns a `Ticket`. `step()` drains the queue: repeatedly, each
  tenant's maximal head *run* of same-kind ops is a candidate; the kind with
  the most pending lanes runs next, every tenant's head run of that kind
  coalesced into ONE facade call (`update` / `lookup` / `count` / `range`).
  Results are identical to running each tenant call-at-a-time on its own
  dictionary. Coalesced batches are padded to bucketed lane counts
  (`lane_quantum` × powers of two), as in the reference.

* **Admission and flush policy.** Update lanes stage into the facade's write
  buffer; the server keeps an exact host-side model of `pending()` (it owns
  every mutation) and forces a `flush()` when it reaches
  ``flush_at_fraction * batch_size``. `maintenance_budget` piggybacks
  budgeted compaction on every update/flush, and `drain()` runs an explicit
  idle-time `maintain()`.

* **Linear handle.** The server owns the `Dictionary` handle: each mutating
  step consumes the old handle and the server re-points at the returned one.
  Queries return device tensors; a group's results are copied to the host
  once, at the first `result()` of any of its tickets, and sliced there.
  `server.dictionary` is a borrow for reads: mutating it would consume the
  handle the server holds.
"""

from __future__ import annotations

import dataclasses
from collections import OrderedDict
from typing import Callable, Dict, List, Optional, Tuple

import numpy as np
import torch

from repro_torch.api import Dictionary, KeyDomainError, QueryPlan
from repro_torch.core import semantics as sem


# -- tenants ------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class Tenant:
    """A registered namespace: tenant-local keys [0, key_space) live at
    [base, base + key_space) in the shared key domain."""

    name: str
    base: int
    key_space: int

    def pack(self, keys: np.ndarray) -> np.ndarray:
        return np.asarray(keys, np.int64) + self.base

    def unpack(self, global_keys: np.ndarray) -> np.ndarray:
        g = np.asarray(global_keys, np.int64)
        # Placebo padding rows (range results) stay placebo.
        return np.where(g == sem.PLACEBO_KEY, sem.PLACEBO_KEY, g - self.base)


# -- configuration / stats ----------------------------------------------------


@dataclasses.dataclass(frozen=True)
class ServerConfig:
    """Static server and backing-dictionary configuration.

    backend/batch_size/num_levels/capacity/num_shards feed `Dictionary.create`
    (num_shards only for a sharded backend), and so does `device` (None: the
    card). `flush_threshold` / `maintenance_budget` are the facade's own
    policies; `flush_at_fraction` is the server's admission policy: force a
    flush when the modeled write-buffer occupancy reaches that fraction of
    batch_size. `lane_quantum` buckets coalesced update/lookup widths
    (quantum × power-of-two lanes); `window_quantum` does the same for
    count/range groups and is small, since window cost is linear in lanes.
    `default_plan` overrides the auto-sized QueryPlan of count/range steps.
    """

    backend: str = "lsm"
    batch_size: int = 256
    num_levels: Optional[int] = None
    capacity: Optional[int] = None
    num_shards: Optional[int] = None
    flush_threshold: Optional[int] = None
    maintenance_budget: Optional[int] = None
    flush_at_fraction: float = 0.75
    lane_quantum: int = 64
    window_quantum: int = 2
    default_plan: Optional[QueryPlan] = None
    device: Optional[object] = None

    def make_dictionary(self) -> Dictionary:
        opts: Dict[str, object] = {"batch_size": self.batch_size}
        if self.num_levels is not None:
            opts["num_levels"] = self.num_levels
        if self.capacity is not None:
            opts["capacity"] = self.capacity
        if self.num_shards is not None:
            opts["num_shards"] = self.num_shards
        # validate=False: the server checks tenant-local domains at submit time.
        return Dictionary.create(
            self.backend, validate=False,
            flush_threshold=self.flush_threshold,
            maintenance_budget=self.maintenance_budget, device=self.device, **opts,
        )


@dataclasses.dataclass
class ServerStats:
    """Coalescing/scheduling counters (host-side, exact)."""

    submitted: int = 0      # client ops accepted into the queue
    lanes: int = 0          # scalar lanes across those ops
    steps: int = 0          # step() drains that executed at least one group
    device_steps: int = 0   # coalesced facade calls issued
    flushes: int = 0        # server-forced flush() calls (policy or explicit)
    maintains: int = 0      # explicit idle-time maintain() calls
    lanes_by_kind: Dict[str, int] = dataclasses.field(
        default_factory=lambda: {"update": 0, "lookup": 0, "count": 0, "range": 0}
    )

    @property
    def ops_per_device_step(self) -> float:
        return self.submitted / self.device_steps if self.device_steps else 0.0

    def as_dict(self) -> Dict[str, object]:
        d = dataclasses.asdict(self)
        d["ops_per_device_step"] = round(self.ops_per_device_step, 2)
        return d


# -- tickets ------------------------------------------------------------------


class Ticket:
    """Handle to one submitted op's eventual result.

    The result exists once the server has run the op's coalesced group;
    `result()` triggers a `step()` if the op is still queued, then waits only
    for its group's results (copied to the host once per group).
    """

    __slots__ = ("_server", "kind", "tenant", "_resolver", "_value", "_resolved")

    def __init__(self, server: "DictionaryServer", kind: str, tenant: str):
        self._server = server
        self.kind = kind
        self.tenant = tenant
        self._resolver: Optional[Callable[[], object]] = None
        self._value = None
        self._resolved = False

    @property
    def dispatched(self) -> bool:
        """Has the op's device step been issued (not necessarily finished)?"""
        return self._resolver is not None

    def result(self):
        if not self._resolved:
            if self._resolver is None:
                self._server.step()
            assert self._resolver is not None, "step() must dispatch every queued op"
            self._value = self._resolver()
            self._resolver = None
            self._resolved = True
        return self._value


def _on_host(*tensors) -> Callable[[], Tuple[np.ndarray, ...]]:
    """A callable that copies `tensors` to the host on its first call and
    returns the same numpy arrays on every later one: one copy per group,
    however many tickets read it."""
    cache: List[Tuple[np.ndarray, ...]] = []

    def get():
        if not cache:
            cache.append(tuple(t.cpu().numpy() for t in tensors))
        return cache[0]

    return get


@dataclasses.dataclass
class _QueuedOp:
    seq: int
    kind: str
    tenant: Tenant
    ticket: Ticket
    keys: Optional[np.ndarray] = None       # packed (global) keys
    values: Optional[np.ndarray] = None
    is_delete: Optional[np.ndarray] = None
    k1: Optional[np.ndarray] = None         # packed query bounds
    k2: Optional[np.ndarray] = None
    max_results: int = 0

    @property
    def lanes(self) -> int:
        if self.kind in ("update", "lookup"):
            return len(self.keys)
        return len(self.k1)


def _bucket(n: int, quantum: int) -> int:
    """Smallest quantum * 2^k >= n."""
    m = quantum
    while m < n:
        m *= 2
    return m


def _next_pow2(n: int) -> int:
    m = 1
    while m < n:
        m *= 2
    return m


# -- the server ---------------------------------------------------------------


class DictionaryServer:
    """Continuous-batching front end over one shared `Dictionary`.

        srv = DictionaryServer(ServerConfig(backend="lsm", batch_size=256))
        srv.register_tenant("seq-a", key_space=4096)
        srv.register_tenant("seq-b", key_space=4096)
        t1 = srv.submit_update("seq-a", keys, values)
        t2 = srv.submit_lookup("seq-b", queries)
        srv.step()                  # coalesce and dispatch queued ops
        found, vals = t2.result()   # numpy; or call result() directly (auto-steps)
        srv.drain()                 # run everything, idle-maintain, synchronize
    """

    def __init__(self, config: ServerConfig = ServerConfig(),
                 dictionary: Optional[Dictionary] = None):
        self.config = config
        self._d = dictionary if dictionary is not None else config.make_dictionary()
        self.stats = ServerStats()
        self._queue: List[_QueuedOp] = []
        self._seq = 0
        self._tenants: Dict[str, Tenant] = {}
        self._free_extents: List[Tuple[int, int]] = []  # (base, size), sorted
        self._next_base = 0
        # Host-side model of the write-buffer occupancy; exact because the
        # server owns every mutation.
        self._pending_model = 0

    # -- tenant registry ------------------------------------------------------

    @property
    def tenants(self) -> Tuple[str, ...]:
        return tuple(self._tenants)

    def tenant(self, name: str) -> Tenant:
        try:
            return self._tenants[name]
        except KeyError:
            raise KeyError(
                f"unknown tenant {name!r}; registered: {sorted(self._tenants)}"
            ) from None

    def register_tenant(self, name: str, key_space: int) -> Tenant:
        """Reserve a contiguous extent of `key_space` keys for `name`.

        Freed extents are reused first-fit (split on surplus); otherwise the
        extent is carved past the high-water mark. Raises `KeyDomainError`
        when the namespace would overflow the shared domain.
        """
        if name in self._tenants:
            raise ValueError(f"tenant {name!r} already registered")
        key_space = int(key_space)
        if key_space < 1:
            raise ValueError(f"key_space must be >= 1, got {key_space}")
        base = None
        for i, (fb, fs) in enumerate(self._free_extents):
            if fs >= key_space:
                base = fb
                if fs > key_space:
                    self._free_extents[i] = (fb + key_space, fs - key_space)
                else:
                    del self._free_extents[i]
                break
        if base is None:
            base = self._next_base
            if base + key_space - 1 > sem.MAX_USER_KEY:
                raise KeyDomainError(
                    f"registering tenant {name!r} with key_space={key_space} "
                    f"at base={base} would overflow MAX_USER_KEY="
                    f"{sem.MAX_USER_KEY} (free: "
                    f"{sem.MAX_USER_KEY + 1 - base} keys + "
                    f"{sum(s for _, s in self._free_extents)} reclaimable)"
                )
            self._next_base = base + key_space
        t = Tenant(name=name, base=base, key_space=key_space)
        self._tenants[name] = t
        return t

    def deregister_tenant(self, name: str, chunk: int = 4096) -> int:
        """Tombstone the tenant's full key range and free its extent.

        Queued ops are drained first, then the extent is emptied with
        range-scan + tombstone rounds of at most `chunk` keys. Returns the
        number of keys tombstoned.
        """
        t = self.tenant(name)
        self.drain()
        lo = np.asarray([t.base], np.int64)
        hi = np.asarray([t.base + t.key_space - 1], np.int64)
        removed = 0
        limit = min(chunk, t.key_space)
        plan = QueryPlan(max_results=limit)
        while True:
            keys, _vals, counts, _ok = self._query(lambda d: d.range(lo, hi, plan))
            n = int(counts[0])
            # Only min(n, limit) rows are real: counts report the full window
            # population, rows are truncated to the plan.
            take = min(n, limit)
            if take:
                live = keys[0, :take].cpu().numpy()
                self._mutate(lambda d: d.delete(live))
                if self._d.buffered:
                    self._pending_model = self._model_stage(self._pending_model, take)
                removed += take
            if n <= limit:
                break
        del self._tenants[name]
        self._free_extents.append((t.base, t.key_space))
        self._free_extents.sort()
        # Coalesce adjacent free extents (and the high-water tail).
        merged: List[Tuple[int, int]] = []
        for fb, fs in self._free_extents:
            if merged and merged[-1][0] + merged[-1][1] == fb:
                merged[-1] = (merged[-1][0], merged[-1][1] + fs)
            else:
                merged.append((fb, fs))
        if merged and merged[-1][0] + merged[-1][1] == self._next_base:
            self._next_base = merged.pop()[0]
        self._free_extents = merged
        return removed

    # -- submission -----------------------------------------------------------

    def _check_local(self, t: Tenant, name: str, arr, upper: int) -> np.ndarray:
        a = np.asarray(arr)
        if a.ndim == 0:
            a = a[None]
        if a.ndim != 1:
            raise ValueError(f"{name} must be scalar or 1-D, got shape {a.shape}")
        if a.dtype.kind not in "iu":
            raise KeyDomainError(f"{name} must be integers, got dtype {a.dtype}")
        a = a.astype(np.int64)
        bad = (a < 0) | (a >= upper)
        if bad.any():
            raise KeyDomainError(
                f"{name} outside tenant {t.name!r} key space [0, {upper}): "
                f"{a[bad][:5].tolist()}"
            )
        return a

    def _enqueue(self, op: _QueuedOp) -> Ticket:
        self._queue.append(op)
        self.stats.submitted += 1
        self.stats.lanes += op.lanes
        self.stats.lanes_by_kind[op.kind] += op.lanes
        return op.ticket

    def submit_update(self, tenant: str, keys, values=None, is_delete=None) -> Ticket:
        """Queue a ragged insert/delete batch of tenant-local keys; the ticket
        resolves to the number of lanes applied."""
        t = self.tenant(tenant)
        k = self._check_local(t, "update keys", keys, t.key_space)
        n = len(k)
        vals = (np.zeros(n, np.int32) if values is None
                else np.broadcast_to(np.asarray(values, np.int32), (n,)).copy())
        dels = (np.zeros(n, bool) if is_delete is None
                else np.broadcast_to(np.asarray(is_delete, bool), (n,)).copy())
        op = _QueuedOp(
            seq=self._next_seq(), kind="update", tenant=t,
            ticket=Ticket(self, "update", tenant),
            keys=t.pack(k), values=vals, is_delete=dels,
        )
        return self._enqueue(op)

    def submit_lookup(self, tenant: str, keys) -> Ticket:
        """Queue a batched lookup; resolves to (found[n], values[n])."""
        t = self.tenant(tenant)
        k = self._check_local(t, "lookup keys", keys, t.key_space)
        op = _QueuedOp(
            seq=self._next_seq(), kind="lookup", tenant=t,
            ticket=Ticket(self, "lookup", tenant), keys=t.pack(k),
        )
        return self._enqueue(op)

    def submit_count(self, tenant: str, k1, k2) -> Ticket:
        """Queue COUNT(k1, k2) windows (tenant-local, inclusive); resolves to
        (counts[n], ok[n])."""
        t = self.tenant(tenant)
        a = self._check_local(t, "count k1", k1, t.key_space)
        b = self._check_local(t, "count k2", k2, t.key_space)
        if a.shape != b.shape:
            raise ValueError(f"k1/k2 shapes differ: {a.shape}/{b.shape}")
        op = _QueuedOp(
            seq=self._next_seq(), kind="count", tenant=t,
            ticket=Ticket(self, "count", tenant),
            k1=t.pack(a), k2=t.pack(b),
        )
        return self._enqueue(op)

    def submit_range(self, tenant: str, k1, k2, max_results: int) -> Ticket:
        """Queue RANGE(k1, k2) windows; resolves to (keys[n, max_results],
        values, counts, ok) with keys unpacked back to tenant-local (placebo
        padding kept)."""
        t = self.tenant(tenant)
        a = self._check_local(t, "range k1", k1, t.key_space)
        b = self._check_local(t, "range k2", k2, t.key_space)
        if a.shape != b.shape:
            raise ValueError(f"k1/k2 shapes differ: {a.shape}/{b.shape}")
        if max_results < 1:
            raise ValueError(f"max_results must be >= 1, got {max_results}")
        op = _QueuedOp(
            seq=self._next_seq(), kind="range", tenant=t,
            ticket=Ticket(self, "range", tenant),
            k1=t.pack(a), k2=t.pack(b), max_results=int(max_results),
        )
        return self._enqueue(op)

    def _next_seq(self) -> int:
        self._seq += 1
        return self._seq

    # -- handle ownership -----------------------------------------------------

    @property
    def dictionary(self) -> Dictionary:
        """Borrow the current handle for reads and snapshots. Do NOT call
        mutators on it: they would consume the handle the server holds."""
        return self._d

    def _mutate(self, fn) -> None:
        # Linear hand-off: fn consumes self._d and the server re-points at the
        # returned handle.
        self._d = fn(self._d)
        self.stats.device_steps += 1

    def _query(self, fn):
        out = fn(self._d)
        self.stats.device_steps += 1
        return out

    # -- occupancy model ------------------------------------------------------

    def _model_stage(self, pending: int, n_real: int) -> int:
        """Mirror the write buffer's overflow and the facade's flush_threshold
        policy for `n_real` newly staged lanes."""
        pending += n_real
        b = self._d.batch_size
        while pending > b:
            pending -= b
        if (self.config.flush_threshold is not None
                and pending >= self.config.flush_threshold):
            pending = 0
        return pending

    def pending_estimate(self) -> int:
        """Host-side write-buffer occupancy model (no device sync); exact for
        single-shard buffered backends. A sharded backend's buffers are
        shard-local and flush only on local overflow, so its device truth can
        exceed this model; `occupancy()` reads the device truth."""
        return self._pending_model

    def occupancy(self):
        """Device-truth OccupancyStats of the backing dictionary."""
        return self._d.occupancy()

    # -- scheduling -----------------------------------------------------------

    def step(self) -> int:
        """Drain the queue into coalesced per-op-kind device steps.

        Per-tenant program order is a hard constraint; across tenants the
        disjoint namespaces make ops commute. Each round takes every tenant's
        maximal head run of same-kind ops as a candidate group, runs the kind
        with the most pending lanes as one facade call, and repeats. Returns
        the number of device steps issued.
        """
        drained, self._queue = self._queue, []
        if not drained:
            return 0
        issued0 = self.stats.device_steps
        per_tenant: "OrderedDict[str, List[_QueuedOp]]" = OrderedDict()
        for op in drained:
            per_tenant.setdefault(op.tenant.name, []).append(op)
        heads = {name: 0 for name in per_tenant}

        while True:
            by_kind: Dict[str, List[_QueuedOp]] = {}
            lanes: Dict[str, int] = {}
            first_seq: Dict[str, int] = {}
            for name, ops in per_tenant.items():
                i = heads[name]
                if i >= len(ops):
                    continue
                kind = ops[i].kind
                run = []
                while i < len(ops) and ops[i].kind == kind:
                    run.append(ops[i])
                    i += 1
                by_kind.setdefault(kind, []).extend(run)
                lanes[kind] = lanes.get(kind, 0) + sum(o.lanes for o in run)
                first_seq[kind] = min(first_seq.get(kind, run[0].seq), run[0].seq)
            if not by_kind:
                break
            kind = max(lanes, key=lambda k: (lanes[k], -first_seq[k]))
            group = sorted(by_kind[kind], key=lambda o: o.seq)
            for op in group:
                heads[op.tenant.name] += 1
            self._run_group(kind, group)

        self.stats.steps += 1
        return self.stats.device_steps - issued0

    def _run_group(self, kind: str, group: List[_QueuedOp]) -> None:
        {"update": self._run_update, "lookup": self._run_lookup,
         "count": self._run_count, "range": self._run_range}[kind](group)

    def _run_update(self, group: List[_QueuedOp]) -> None:
        n = sum(o.lanes for o in group)
        width = _bucket(n, self.config.lane_quantum)
        keys = np.zeros(width, np.int64)
        vals = np.zeros(width, np.int32)
        dels = np.zeros(width, bool)
        valid = np.zeros(width, bool)
        off = 0
        for op in group:
            m = op.lanes
            keys[off:off + m] = op.keys
            vals[off:off + m] = op.values
            dels[off:off + m] = op.is_delete
            valid[off:off + m] = True
            op.ticket._resolver = (lambda m=m: m)
            off += m
        self._mutate(lambda d: d.update(keys, vals, is_delete=dels, valid=valid))
        if not self._d.buffered:
            return
        self._pending_model = self._model_stage(self._pending_model, n)
        # Admission policy: flush before the buffer overflows mid-step.
        flush_at = max(1, int(self.config.flush_at_fraction * self._d.batch_size))
        if self._pending_model >= flush_at:
            self.flush()

    def _run_lookup(self, group: List[_QueuedOp]) -> None:
        n = sum(o.lanes for o in group)
        width = _bucket(n, self.config.lane_quantum)
        keys = np.zeros(width, np.int64)  # pad lanes: any in-domain key
        off = 0
        for op in group:
            keys[off:off + op.lanes] = op.keys
            off += op.lanes
        host = _on_host(*self._query(lambda d: d.lookup(keys)))
        off = 0
        for op in group:
            o, m = off, op.lanes

            def resolve(o=o, m=m):
                found, vals = host()
                f = found[o:o + m]
                return f, np.where(f, vals[o:o + m], 0)

            op.ticket._resolver = resolve
            off += m

    def _query_windows(self, group: List[_QueuedOp]):
        n = sum(o.lanes for o in group)
        width = _bucket(n, self.config.window_quantum)
        # Pad with inverted windows (1, 0): zero candidates, zero results.
        k1 = np.full(width, 1, np.int64)
        k2 = np.zeros(width, np.int64)
        off = 0
        for op in group:
            k1[off:off + op.lanes] = op.k1
            k2[off:off + op.lanes] = op.k2
            off += op.lanes
        return k1, k2

    def _run_count(self, group: List[_QueuedOp]) -> None:
        k1, k2 = self._query_windows(group)
        plan = self.config.default_plan
        host = _on_host(*self._query(lambda d: d.count(k1, k2, plan)))
        off = 0
        for op in group:
            o, m = off, op.lanes

            def resolve(o=o, m=m):
                counts, ok = host()
                return counts[o:o + m], ok[o:o + m]

            op.ticket._resolver = resolve
            off += m

    def _run_range(self, group: List[_QueuedOp]) -> None:
        k1, k2 = self._query_windows(group)
        base_plan = self.config.default_plan or QueryPlan()
        rows = _next_pow2(max(o.max_results for o in group))
        plan = dataclasses.replace(base_plan, max_results=rows)
        host = _on_host(*self._query(lambda d: d.range(k1, k2, plan)))
        off = 0
        for op in group:
            o, m, t, mr = off, op.lanes, op.tenant, op.max_results

            def resolve(o=o, m=m, t=t, mr=mr):
                keys, vals, counts, ok = host()
                rk = t.unpack(keys[o:o + m, :mr])
                rv = vals[o:o + m, :mr]
                # counts stay the full window counts; overflow of the op's own
                # row budget shows as the truncation flag, as a direct call
                # with max_results=mr reports it.
                rc = counts[o:o + m]
                rok = ok[o:o + m] & (rc <= mr)
                return rk.astype(np.int64), rv, rc, rok

            op.ticket._resolver = resolve
            off += m

    # -- maintenance / lifecycle ---------------------------------------------

    def flush(self) -> None:
        """Force staged updates down into the main structure now."""
        self._mutate(lambda d: d.flush())
        self.stats.flushes += 1
        self._pending_model = 0

    def cleanup(self) -> None:
        """Full stop-the-world compaction of the shared handle (folds the
        write buffer in; `maintain()` is the bounded-latency alternative)."""
        self._mutate(lambda d: d.cleanup())
        self._pending_model = 0

    def maintain(self, budget: Optional[int] = None) -> None:
        """Explicit budgeted compaction on the shared handle."""
        if self._d.capabilities.supports_maintenance:
            self._mutate(lambda d: d.maintain(budget))
            self.stats.maintains += 1

    def drain(self) -> ServerStats:
        """Run every queued op, idle-maintain if configured, and wait until
        every device holding the dictionary is idle. Returns the stats."""
        while self._queue:
            self.step()
        if (self.config.maintenance_budget is not None
                and self._d.capabilities.supports_maintenance):
            self.maintain(self.config.maintenance_budget)
        for dev in self._d.devices:
            if dev.type == "cuda":
                torch.cuda.synchronize(dev)
        return self.stats
