"""The sliding-window generator: every input of a cell, made on the device
from `--seed`. A traffic file names it with `"generator": "sliding_window"`.

Keys. A seeded bijection maps counters [0, 2^bits - 1) onto the user keys
[0, 2^bits - 2] (`Keyspace`), held as one int32 table on the device, so a run
of fresh keys is a slice of the table. The last quarter of the counters is
never inserted: those are the lookups' absent keys. Insert and delete counters
wrap modulo the other three quarters; a key comes back only long after its
delete, never while it is live.

The sliding window (`Stream`). After a bulk build of `live` keys (counters
[0, live)), each update batch deletes the oldest live counters, overwrites
live counters drawn uniformly with new values, and inserts fresh counters, in
that lane order. Inserts equal deletes, so exactly `live` keys stay live: the
counters [lo, hi). Overwrites are drawn with replacement, so a batch may write
one key twice; the later lane wins. A batch is made by `update` and takes
effect on the window's state by `commit`, when it is sent. Batch c depends on
c alone, so batches are made a chunk of calls at a time (`CHUNK_LANES` lanes
in all), in a few large calls on the device, and a call between chunks only
takes its rows.

Values. The w-th write of the whole run (bulk writes first) carries a value
that is a bijection of w modulo 2^32, so no two writes within 2^32 of each
other carry the same value and a stale copy reads wrong.

Every random draw comes from a generator seeded by (seed, what, index), so
the same arguments give the same tensors, in any process: the reference
replays the run from the same calls.
"""

from __future__ import annotations

import random
from typing import NamedTuple

import torch

from lsmbench.harness import mix

VALUE_MUL = 0x9E3779B1  # odd: w -> w * VALUE_MUL is a bijection modulo 2^32


CHUNK_LANES = 1 << 25   # update lanes made in one go


def make(config: dict, traffic: dict, seed: int, device):
    """The cell's stream: `config["live_keys"]` live keys of
    `config["key_bits"]` bits under `traffic["update_mix"]`, in batches of
    `config["batch_size"] * traffic["update_batches"]` lanes."""
    return Stream(Keyspace(config["key_bits"], seed, device), config["live_keys"], traffic["update_mix"], seed,
                  config["batch_size"] * traffic["update_batches"])


class Batch(NamedTuple):
    keys: torch.Tensor        # int32, lane order: deletes, overwrites, inserts
    values: torch.Tensor      # int32
    is_delete: torch.Tensor   # bool
    n_del: int
    n_ins: int


class Keyspace:
    """A seeded bijection of counters onto user keys, as a table on the device."""

    def __init__(self, key_bits: int, seed: int, device, chunk: int = 1 << 26):
        if not 8 <= key_bits <= 30:
            raise ValueError(f"key_bits must be in [8, 30], got {key_bits}")
        self.bits = key_bits
        self.mask = (1 << key_bits) - 1
        self.size = self.mask                      # counters and keys: [0, 2^bits - 1)
        self.absent = 1 << (key_bits - 2)          # counters [cycle, size) are never inserted
        self.cycle = self.size - self.absent       # insert and delete counters wrap modulo this
        self.max_key = self.mask - 1
        rng = random.Random(mix(seed, "keyspace"))
        shifts = (key_bits // 2, key_bits // 2 - 2, key_bits // 2 + 1)
        self.rounds = [(rng.getrandbits(key_bits) | 1, rng.getrandbits(key_bits), s) for s in shifts]
        # The bijection of [0, 2^bits) maps some counter onto the excluded key
        # 2^bits - 1; that counter takes the image of 2^bits - 1 instead.
        self.walk = int(self._permute(torch.tensor([self.mask], dtype=torch.int64))[0])
        self.table = torch.empty(self.size, dtype=torch.int32, device=device)
        for start in range(0, self.size, chunk):
            end = min(start + chunk, self.size)
            x = self._permute(torch.arange(start, end, dtype=torch.int64, device=device))
            self.table[start:end] = torch.where(x == self.mask, self.walk, x).to(torch.int32)

    def _permute(self, x):
        for mul, add, shift in self.rounds:
            x = (x * mul + add) & self.mask
            x = x ^ (x >> shift)
        return x

    def span(self, start: int, n: int):
        """Keys of the counters start, start + 1, ..., start + n - 1 modulo `cycle`."""
        s = start % self.cycle
        if s + n <= self.cycle:
            return self.table[s:s + n]
        return torch.cat([self.table[s:self.cycle], self.table[:n - (self.cycle - s)]])

    def at(self, counters):
        """Keys of int64 counters already reduced modulo `size`."""
        return self.table[counters]


class Stream:
    """The sliding window's state and every input a cell sends. Every update
    batch has `lanes` lanes; batch c is a function of c alone, and batches are
    made `chunk` at a time, so most calls take rows of a chunk already made."""

    def __init__(self, keyspace: Keyspace, live: int, mix_shares: dict, seed: int, lanes: int):
        if abs(mix_shares["insert"] - mix_shares["delete"]) > 1e-12:
            raise ValueError("the sliding window needs as many inserts as deletes")
        if 2 * live >= keyspace.cycle:
            raise ValueError(f"live={live} is too large for a key space of {keyspace.bits} bits")
        self.ks = keyspace
        self.live = live
        self.lanes = lanes
        self.n_ins = round(lanes * mix_shares["insert"])
        if self.n_ins > live:
            raise ValueError(f"a batch of {lanes} lanes deletes more than the {live} live keys")
        self.chunk = max(1, min(CHUNK_LANES, keyspace.cycle // 2) // lanes)   # a chunk's counters wrap once at most
        self.seed = seed
        self.device = keyspace.table.device
        self.calls = 0                   # update batches sent so far
        self._g = torch.Generator(device=self.device)
        self._made = {}                  # chunk index -> (keys [chunk, lanes], values), the newest few
        self._lookups = {}               # (call index, n) -> (chunk index, keys [chunk', n])
        lane = torch.arange(lanes, dtype=torch.int64, device=self.device)
        self._lane_terms = lane * VALUE_MUL
        self._is_delete = lane < self.n_ins

    # live counters [lo, hi); `serial` writes so far
    @property
    def lo(self) -> int:
        return self.calls * self.n_ins

    @property
    def hi(self) -> int:
        return self.live + self.calls * self.n_ins

    def _gen(self, *what):
        self._g.manual_seed(mix(self.seed, *what))
        return self._g

    def _randint(self, g, high: int, n):
        shape = n if isinstance(n, tuple) else (n,)
        return torch.randint(0, high, shape, generator=g, device=self.device, dtype=torch.int64)

    def _values(self, first: int, rows: int, n: int):
        """int32 values of the writes first + i * n + j: [rows, n]. The value of
        write w is w * VALUE_MUL + salt modulo 2^32, as a 32-bit two's complement."""
        salt = mix(self.seed, "values")
        base = torch.tensor([((first + i * n) * VALUE_MUL + salt) % (1 << 32) for i in range(rows)],
                            dtype=torch.int64, device=self.device)
        return (self._lane_terms[None, :n] + base[:, None]).to(torch.int32)

    def bulk(self):
        """The bulk build's unique keys and values: counters [0, live)."""
        rows = -(-self.live // self.lanes)
        vals = self._values(0, rows, self.lanes).reshape(-1)[:self.live]
        return self.ks.span(0, self.live), vals

    def _make_chunk(self, k: int):
        """Batches [k * chunk, (k + 1) * chunk): deletes of the oldest live
        counters, overwrites drawn uniformly from the rest, fresh inserts. The
        deletes (and the inserts) of consecutive batches are consecutive
        counters, so they are slices of the key table."""
        m, n, lanes = self.chunk, self.n_ins, self.lanes
        n_ow = lanes - 2 * n
        first = k * m
        keys = torch.empty((m, lanes), dtype=torch.int32, device=self.device)
        keys[:, :n] = self.ks.span(first * n, m * n).view(m, n)
        keys[:, n + n_ow:] = self.ks.span(self.live + first * n, m * n).view(m, n)
        lo = torch.arange(first, first + m, dtype=torch.int64, device=self.device)[:, None] * n
        ow = self._randint(self._gen("overwrite", k), self.live - n, (m, n_ow)).add_(lo + n)
        keys[:, n:n + n_ow] = self.ks.at(ow.remainder_(self.ks.cycle))
        self._made[k] = (keys, self._values(self.live + first * lanes, m, lanes))
        for old in sorted(self._made)[:-3]:
            del self._made[old]

    def _chunk(self, k: int):
        if k not in self._made:
            self._make_chunk(k)
        return self._made[k]

    def _batch_keys(self, first: int, m: int):
        """Keys of batches first, ..., first + m - 1: [m, lanes]. Batch -1,
        before any, stands as batch 0."""
        lo, hi = max(first, 0), max(first + m, 1)
        rows = [self._chunk(k)[0][max(lo - k * self.chunk, 0):hi - k * self.chunk]
                for k in range(lo // self.chunk, (hi - 1) // self.chunk + 1)]
        if first < 0:
            rows.insert(0, rows[0][:1])
        keys = rows[0] if len(rows) == 1 else torch.cat(rows)
        return keys[:m]

    def update(self) -> Batch:
        """The next batch (number `calls`); the window slides at `commit`."""
        k, row = divmod(self.calls, self.chunk)
        keys, values = self._chunk(k)
        return Batch(keys[row], values[row], self._is_delete, self.n_ins, self.n_ins)

    def commit(self, batch: Batch) -> None:
        """The batch made last by `update` is sent: the window slides."""
        self.calls += 1

    def lookup_keys(self, n: int, shares: dict, tag):
        """`n` lookup keys for the window as it stands (`calls` batches sent):
        live, recently deleted and never inserted, in the given shares; `fresh`
        of the live ones were written by the last batch. The keys of a call of
        the window's rounds (tag ("round", r, i)) depend on `calls` and i
        alone, and are made a chunk of calls at a time; others (the ring's,
        the warm-up's) are made one at a time, seeded by their tag."""
        if shares["deleted"] and self.calls == 0:
            raise ValueError("deleted lookups need a delete before them")
        if shares.get("fresh") and self.calls == 0:
            raise ValueError("fresh lookups need an update batch before them")
        if tag[0] != "round":
            return self._make_lookups(self.calls, 1, n, shares, ("lookup", tag))[0]
        m = max(1, min(CHUNK_LANES // n, 64))
        k, row = divmod(self.calls, m)
        slot = (tag[2], n)
        if self._lookups.get(slot, (None,))[0] != k:
            self._lookups[slot] = (k, self._make_lookups(k * m, m, n, shares, ("lookup", tag[2], k)))
        return self._lookups[slot][1][row]

    def _make_lookups(self, first: int, m: int, n: int, shares: dict, what):
        """Lookup keys for the window after first, ..., first + m - 1 batches:
        [m, n]. The row of a window with no batch sent yet has no deleted or
        fresh keys to draw, and is never asked for (lookup_keys raises)."""
        g = self._gen(*what)
        n_live = round(n * shares["live"])
        n_dead = round(n * shares["deleted"])
        n_fresh = round(n_live * shares.get("fresh", 0.0))
        n_old = n_live - n_fresh
        n_absent = n - n_live - n_dead
        calls = torch.arange(first, first + m, dtype=torch.int64, device=self.device)[:, None]
        lo = calls * self.n_ins
        counters = torch.empty((m, n_old + n_dead + n_absent), dtype=torch.int64, device=self.device)
        counters[:, :n_old] = self._randint(g, self.live, (m, n_old)) + lo
        dead = self._randint(g, 1 << 60, (m, n_dead)) % torch.clamp(lo, min=1, max=self.live)
        counters[:, n_old:n_old + n_dead] = lo - 1 - dead
        counters[:, n_old + n_dead:] = self._randint(g, self.ks.absent, (m, n_absent)) + self.ks.cycle
        counters[:, :n_old + n_dead].remainder_(self.ks.cycle)
        keys = torch.empty((m, n), dtype=torch.int32, device=self.device)
        keys[:, :n_old] = self.ks.at(counters[:, :n_old])
        if n_fresh:
            written = self._randint(g, self.lanes - self.n_ins, (m, n_fresh)) + self.n_ins
            keys[:, n_old:n_live] = torch.gather(self._batch_keys(first - 1, m), 1, written)
        keys[:, n_live:] = self.ks.at(counters[:, n_old:])
        return keys

    def windows(self, n: int, width: int, tag):
        """`n` windows [k1, k1 + width - 1] with k1 uniform on the key space."""
        g = self._gen("window", tag)
        k1 = self._randint(g, self.ks.max_key - width + 2, n)
        return k1.to(torch.int32), (k1 + width - 1).to(torch.int32)

    def live_keys(self):
        """Every live key (counters [lo, hi))."""
        return self.ks.span(self.lo, self.live)

    def dead_keys(self):
        """The most recently deleted keys, up to `live` of them."""
        span = min(self.lo, self.live)
        return self.ks.span(self.lo - span, span)

    def absent_keys(self, n: int):
        g = self._gen("absent-readback")
        return self.ks.at(self.ks.cycle + self._randint(g, self.ks.absent, n))
