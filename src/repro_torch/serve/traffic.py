"""Multi-tenant traffic generation and replay for the dictionary server
(PyTorch counterpart of repro.serve.traffic; the generator is the same numpy
code, so one seed gives the same trace in both packages).

Three serving-shaped traffic archetypes (the KV-cache workload's phases,
usable standalone or mixed):

* **decode-trickle** — every tenant admits one or two keys per event (a
  sequence growing a KV page per decode step) and occasionally looks a few
  recent keys back up. Thousands of tiny ragged updates: the write buffer's
  reason to exist, and the op stream that murders a call-at-a-time facade.
* **prefill-burst** — one tenant admits a contiguous run of keys in a single
  large update (a prompt's pages arriving at once), then counts its window.
* **eviction-storm** — one tenant tombstones a random swath of its live keys
  (sequence retirement / cache pressure) and range-scans the window to audit
  what survived.

Traces are plain per-tenant-local ops (`TraceOp`), so the same trace replays
through the coalescing server (`replay_server`) and through one direct
call-at-a-time `Dictionary` per tenant (`replay_direct`); the results must be
identical. A pure-python oracle (`replay_oracle`) mirrors tests/harness.py's
arrival-order semantics per tenant.

Generators track per-tenant live-key state so deletes and lookups hit real
keys (plus deliberate misses); everything is driven by a seeded
`np.random.Generator` — same seed, same trace, no hypothesis required.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

import torch

from repro_torch.api import Dictionary, QueryPlan
from repro_torch.serve.server import DictionaryServer

# -- trace representation -----------------------------------------------------


@dataclasses.dataclass(frozen=True)
class TraceOp:
    """One client op in tenant-local key space."""

    tenant: str
    kind: str                                # update | lookup | count | range
    keys: Optional[np.ndarray] = None        # update/lookup lanes
    values: Optional[np.ndarray] = None
    is_delete: Optional[np.ndarray] = None
    k1: Optional[np.ndarray] = None          # count/range windows (inclusive)
    k2: Optional[np.ndarray] = None
    max_results: int = 0

    @property
    def lanes(self) -> int:
        return len(self.keys) if self.keys is not None else len(self.k1)


MIXES = ("decode_trickle", "prefill_burst", "eviction_storm", "mixed")

# Event weights for the "mixed" archetype: mostly trickles with periodic
# bursts and storms — the shape of a serving steady state.
_MIXED_WEIGHTS = {"decode_trickle": 0.70, "prefill_burst": 0.18,
                  "eviction_storm": 0.12}


class TrafficGen:
    """Stateful generator: one event per call, per-tenant live-key tracking.

    `key_space` bounds every tenant's local domain; `window` bounds
    burst/storm/scan widths (and therefore range max_results — windows never
    exceed it, so range results are never truncated and replay paths agree
    bit-for-bit).
    """

    def __init__(self, tenants: Sequence[str], key_space: int, seed: int = 0,
                 window: int = 32):
        if window > key_space:
            raise ValueError(f"window={window} exceeds key_space={key_space}")
        self.tenants = list(tenants)
        self.key_space = int(key_space)
        self.window = int(window)
        self.rng = np.random.default_rng(seed)
        self._next_key = {t: 0 for t in self.tenants}   # decode growth cursor
        self._live: Dict[str, set] = {t: set() for t in self.tenants}

    # -- events (each returns a list of TraceOps) ----------------------------

    def decode_trickle(self, tenant: str) -> List[TraceOp]:
        """1-2 fresh keys admitted (wrapping cursor), sometimes a small
        lookback over recent + missing keys."""
        n = int(self.rng.integers(1, 3))
        start = self._next_key[tenant]
        keys = (start + np.arange(n)) % self.key_space
        self._next_key[tenant] = int((start + n) % self.key_space)
        vals = self.rng.integers(-1000, 1000, n).astype(np.int32)
        self._live[tenant].update(int(k) for k in keys)
        ops = [TraceOp(tenant, "update", keys=keys.astype(np.int64), values=vals,
                       is_delete=np.zeros(n, bool))]
        if self.rng.random() < 0.5:
            nq = int(self.rng.integers(1, 4))
            qs = (start - self.rng.integers(0, self.window, nq)) % self.key_space
            ops.append(TraceOp(tenant, "lookup", keys=qs.astype(np.int64)))
        return ops

    def prefill_burst(self, tenant: str) -> List[TraceOp]:
        """Contiguous window admitted in one update, then counted."""
        w = int(self.rng.integers(self.window // 2, self.window + 1))
        lo = int(self.rng.integers(0, self.key_space - w + 1))
        keys = np.arange(lo, lo + w, dtype=np.int64)
        vals = self.rng.integers(-1000, 1000, w).astype(np.int32)
        self._live[tenant].update(range(lo, lo + w))
        return [
            TraceOp(tenant, "update", keys=keys, values=vals,
                    is_delete=np.zeros(w, bool)),
            TraceOp(tenant, "count", k1=np.asarray([lo], np.int64),
                    k2=np.asarray([lo + w - 1], np.int64)),
        ]

    def eviction_storm(self, tenant: str) -> List[TraceOp]:
        """Tombstone a random swath of live keys, then audit the window."""
        live = self._live[tenant]
        lo = int(self.rng.integers(0, self.key_space - self.window + 1))
        hi = lo + self.window - 1
        in_window = sorted(k for k in live if lo <= k <= hi)
        if in_window:
            take = max(1, len(in_window) // 2)
            doomed = self.rng.choice(np.asarray(in_window, np.int64),
                                     take, replace=False)
        else:
            # Nothing live here: tombstone misses (legal, exercises
            # tombstones for absent keys).
            doomed = self.rng.integers(lo, hi + 1, 2).astype(np.int64)
        for k in doomed:
            live.discard(int(k))
        return [
            TraceOp(tenant, "update", keys=np.sort(doomed),
                    values=np.zeros(len(doomed), np.int32),
                    is_delete=np.ones(len(doomed), bool)),
            TraceOp(tenant, "range", k1=np.asarray([lo], np.int64),
                    k2=np.asarray([hi], np.int64), max_results=self.window),
        ]

    # -- trace assembly -------------------------------------------------------

    def make(self, mix: str, events: int) -> List[TraceOp]:
        """`events` generator events (each 1-2 ops). decode_trickle rotates
        tenants round-robin (every sequence decodes); burst/storm pick a
        random tenant per event; mixed draws the archetype per event."""
        if mix not in MIXES:
            raise ValueError(f"unknown mix {mix!r}; one of {MIXES}")
        names = list(_MIXED_WEIGHTS)
        probs = np.asarray([_MIXED_WEIGHTS[n] for n in names])
        ops: List[TraceOp] = []
        for i in range(events):
            kind = (mix if mix != "mixed"
                    else names[int(self.rng.choice(len(names), p=probs))])
            if kind == "decode_trickle":
                tenant = self.tenants[i % len(self.tenants)]
            else:
                tenant = self.tenants[int(self.rng.integers(len(self.tenants)))]
            ops.extend(getattr(self, kind)(tenant))
        return ops


def make_trace(mix: str, num_tenants: int, key_space: int, events: int,
               seed: int = 0, window: int = 32) -> Tuple[List[str], List[TraceOp]]:
    """Convenience wrapper: (tenant names, trace ops)."""
    tenants = [f"tenant{i:03d}" for i in range(num_tenants)]
    gen = TrafficGen(tenants, key_space=key_space, seed=seed, window=window)
    return tenants, gen.make(mix, events)


# -- replay paths -------------------------------------------------------------


def replay_server(server: DictionaryServer, trace: Sequence[TraceOp],
                  step_every: int = 64) -> List[object]:
    """Submit the whole trace through the coalescing server, stepping every
    `step_every` submissions (the continuous-batching window), and resolve
    every ticket. Returns per-op results aligned with the trace."""
    tickets = []
    for i, op in enumerate(trace):
        if op.kind == "update":
            t = server.submit_update(op.tenant, op.keys, op.values, op.is_delete)
        elif op.kind == "lookup":
            t = server.submit_lookup(op.tenant, op.keys)
        elif op.kind == "count":
            t = server.submit_count(op.tenant, op.k1, op.k2)
        else:
            t = server.submit_range(op.tenant, op.k1, op.k2, op.max_results)
        tickets.append(t)
        if (i + 1) % step_every == 0:
            server.step()
    server.drain()
    return [t.result() for t in tickets]


def replay_direct(make_dict, tenants: Sequence[str], trace: Sequence[TraceOp],
                  plan: Optional[QueryPlan] = None) -> List[object]:
    """The adoption-gap baseline: one private `Dictionary` per tenant
    (`make_dict()` builds each, on its own device, such as
    `ServerConfig(device=...).make_dictionary`), every op its own facade
    call, results copied to the host at once. Returns per-op results aligned
    with the trace, in `replay_server`'s format."""
    dicts: Dict[str, Dictionary] = {t: make_dict() for t in tenants}
    results: List[object] = []
    for op in trace:
        d = dicts[op.tenant]
        if op.kind == "update":
            dicts[op.tenant] = d.update(op.keys, op.values, is_delete=op.is_delete)
            results.append(len(op.keys))
        elif op.kind == "lookup":
            f, v = _host(*d.lookup(op.keys))
            results.append((f, np.where(f, v, 0)))
        elif op.kind == "count":
            results.append(_host(*d.count(op.k1, op.k2, plan)))
        else:
            p = dataclasses.replace(plan or QueryPlan(), max_results=op.max_results)
            keys, vals, counts, ok = _host(*d.range(op.k1, op.k2, p))
            results.append((keys.astype(np.int64), vals, counts, ok))
    for dev in {d.device for d in dicts.values()}:
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
    return results


def _host(*tensors):
    return tuple(t.cpu().numpy() for t in tensors)


def replay_oracle(trace: Sequence[TraceOp]) -> Dict[str, dict]:
    """Per-tenant python-dict oracle with strict arrival-order semantics
    (tests/harness.py's recency rule, namespaced). Queries are not replayed —
    the final maps are the ground truth for end-state checks."""
    oracles: Dict[str, dict] = {}
    for op in trace:
        if op.kind != "update":
            continue
        o = oracles.setdefault(op.tenant, {})
        for k, v, dl in zip(op.keys, op.values, op.is_delete):
            if bool(dl):
                o.pop(int(k), None)
            else:
                o[int(k)] = int(v)
    return oracles
