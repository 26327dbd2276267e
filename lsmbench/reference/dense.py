"""The plain reference: a dictionary as a dense table over the key space.

One slot per key of [0, 2^bits): a presence flag and a value. An update
batch is applied in lane order (the last lane of a key wins; a delete clears
the flag); a lookup reads the slot; COUNT sums presence flags over the
window by a prefix sum; RANGE lists the present keys of the window in
ascending order. Nothing here knows of levels, runs, buffers or cleanup, and
nothing is imported from the program under test.

A table never truncates: its COUNT is always ok, its RANGE ok where the
window has at most `max_results` results. `expected_ok` says what a plan's
bounds force on the program: a RANGE window with more results than
`max_results` must come back not ok; a window whose keys were written at
most `max_candidates` times in all (every resident copy, stale or not, is one
of those writes), and for RANGE has at most `max_results` results, must come
back ok; in between, either.

`control` names a broken guarantee, for the control run that must come out
not correct: "stale_overwrite" keeps the first value of a present key, so an
acknowledged overwrite is lost.
"""

from __future__ import annotations

import torch

CONTROLS = ("stale_overwrite",)

PLACEBO_KEY = (1 << 30) - 1   # what a RANGE row holds past its count
EMPTY_VALUE = 0               # the value of a miss and of a RANGE row past its count


class DenseDictionary:
    def __init__(self, key_bits: int, device, *, track_writes: bool = False, control: str | None = None):
        if control is not None and control not in CONTROLS:
            raise ValueError(f"unknown control {control!r}; one of {CONTROLS}")
        n = 1 << key_bits
        self.device = torch.device(device)
        self.control = control
        # Slot n is a drop slot for the lanes a later lane overrides.
        self.present = torch.zeros(n + 1, dtype=torch.bool, device=device)
        self.value = torch.zeros(n + 1, dtype=torch.int32, device=device)
        self.writes = torch.zeros(n + 1, dtype=torch.int32, device=device) if track_writes else None
        self._winner = torch.full((n + 1,), -1, dtype=torch.int32, device=device)
        self._prefix = {}
        self.drop = n

    # -- updates -------------------------------------------------------------

    def bulk_build(self, keys, values):
        self.present.zero_()
        self.value.zero_()
        if self.writes is not None:
            self.writes.zero_()
        self.update(keys, values, torch.zeros(keys.shape[0], dtype=torch.bool, device=keys.device))

    def update(self, keys, values, is_delete):
        """Apply one batch in lane order: the last lane of each key wins."""
        keys = keys.to(torch.int64)
        lane = torch.arange(keys.shape[0], dtype=torch.int32, device=keys.device)
        self._winner.scatter_reduce_(0, keys, lane, reduce="amax")
        last = self._winner[keys] == lane
        self._winner[keys] = -1
        if self.control == "stale_overwrite":
            last &= is_delete | ~self.present[keys]
        idx = torch.where(last, keys, self.drop)
        self.present[idx] = ~is_delete
        self.value[idx] = torch.where(is_delete, EMPTY_VALUE, values.to(torch.int32))
        if self.writes is not None:
            self.writes.index_add_(0, keys, torch.ones_like(keys, dtype=torch.int32))
        self._prefix.clear()

    # -- queries -------------------------------------------------------------

    def lookup(self, keys):
        keys = keys.to(torch.int64)
        found = self.present[keys]
        return found, torch.where(found, self.value[keys], EMPTY_VALUE)

    def _window_sum(self, name, k1, k2):
        if name not in self._prefix:
            src = self.present[:-1] if name == "present" else self.writes[:-1]
            self._prefix[name] = torch.cat([
                torch.zeros(1, dtype=torch.int64, device=self.device),
                torch.cumsum(src, 0, dtype=torch.int64),
            ])
        cs = self._prefix[name]
        return cs[k2.to(torch.int64) + 1] - cs[k1.to(torch.int64)]

    def count(self, k1, k2, plan):
        """COUNT -> (counts int32, ok all True)."""
        counts = self._window_sum("present", k1, k2)
        return counts.to(torch.int32), torch.ones_like(counts, dtype=torch.bool)

    def range(self, k1, k2, plan):
        """RANGE -> (keys [nq, max_results], values, counts, ok): the present
        keys of each window ascending, PLACEBO_KEY / EMPTY_VALUE past the count."""
        mr = plan["max_results"]
        k1w, k2w = k1.to(torch.int64), k2.to(torch.int64)
        width = int((k2w - k1w).max()) + 1 if k1.numel() else 1
        tile = k1w[:, None] + torch.arange(width, dtype=torch.int64, device=k1.device)[None, :]
        inside = tile <= k2w[:, None]
        hit = inside & self.present[torch.where(inside, tile, self.drop)]
        counts = hit.sum(1)
        col = torch.cumsum(hit, 1) - 1
        col = torch.where(hit & (col < mr), col, mr)
        nq = k1.shape[0]
        out_k = torch.full((nq, mr + 1), PLACEBO_KEY, dtype=torch.int32, device=k1.device)
        out_v = torch.full((nq, mr + 1), EMPTY_VALUE, dtype=torch.int32, device=k1.device)
        out_k.scatter_(1, col, tile.to(torch.int32))
        out_v.scatter_(1, col, self.value[torch.where(inside, tile, self.drop)])
        ok = counts <= mr
        return out_k[:, :mr], out_v[:, :mr], counts.to(torch.int32), ok

    def expected_ok(self, op: str, k1, k2, plan):
        """(must, may) per window of `op` ("count" or "range"): True where the
        plan's bounds force the program's ok (resp. allow it)."""
        if self.writes is None:
            raise ValueError("expected_ok needs a table made with track_writes=True")
        must = self._window_sum("writes", k1, k2) <= plan["max_candidates"]
        if op == "count":
            return must, torch.ones_like(must)
        fits = self._window_sum("present", k1, k2) <= plan["max_results"]
        return must & fits, fits
