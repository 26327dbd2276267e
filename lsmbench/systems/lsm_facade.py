"""The system under test for an `"lsm"` configuration: the port's
`repro_torch.api.Dictionary`, driven through one linear handle.

A configuration names it with `"system": "lsm_facade"`. The closed loop
talks to it through `bulk_build`, `fits`, `update`, `cleanup`, `lookup`,
`count` and `range`; the control run puts the reference's table in its
place.

Whether an update fits, and the levels its carries land in, come from the
dictionary's own counters, read on the host after each call (`r`, the
resident batches, bit i set where level i is full, and `pending()`, the
write buffer's lanes): a call of n lanes pushes the oldest b of the buffer
through the cascade each time more than b are pending, so it makes
max(0, ceil((pending + n) / b) - 1) carries, and carry k of them lands in
the lowest level that is empty in r + k.

`FAULTS` names the faults (lsmbench/faults.py) that can be planted in this
system, each with the kind of call whose answers it spoils; the CPU tests
plant each in every cell that sends such a call. `program_trace` turns the
port's own spans and counters (`repro_torch.obs`) on and off around a traced
window (lsmbench/progtrace.py's `Tracer`).
"""

from __future__ import annotations

from lsmbench import roofline

FAULTS = {"unchanged": "update", "half_batch": "update", "lookup_altered": "lookup", "count_altered": "count",
          "range_altered": "range"}


class LSMFacade:
    def __init__(self, config: dict, devices):
        from repro_torch.api import Dictionary, QueryPlan

        self._plan_cls = QueryPlan
        self._plans = {}
        self.d = Dictionary.create(
            config["backend"],
            validate=config["validate"],
            flush_threshold=config["flush_threshold"],
            maintenance_budget=config["maintenance_budget"],
            device=devices[0],
            capacity=config["capacity"],
            batch_size=config["batch_size"],
        )
        self.batch_size = self.d.batch_size
        self.max_batches = self.d.capacity // self.batch_size

    def _plan(self, plan: dict):
        key = (plan["max_candidates"], plan["max_results"])
        if key not in self._plans:
            self._plans[key] = self._plan_cls(*key)
        return self._plans[key]

    def _carries(self, lanes: int) -> int:
        return max(0, -(-(self.d.pending() + lanes) // self.batch_size) - 1)

    def bulk_build(self, keys, values):
        self.d = self.d.bulk_build(keys, values)

    def fits(self, lanes: int) -> bool:
        """Does an update of `lanes` lanes fit without a cleanup first?"""
        return self.d.state.r + self._carries(lanes) <= self.max_batches

    def update(self, keys, values, is_delete) -> int:
        """One update call -> the least bytes it moves (lsmbench/roofline.py)."""
        r, carries = self.d.state.r, self._carries(keys.shape[0])
        self.d = self.d.update(keys, values, is_delete)
        levels = [roofline.placement_level(r + k) for k in range(carries)]
        return roofline.update_bytes(self.batch_size, keys.shape[0], levels)

    def cleanup(self, survivors: int) -> int:
        """A stop-the-world cleanup -> the least bytes it moves: every resident
        slot read, the `survivors` (the live keys) written."""
        resident = self.d.state.r * self.batch_size + self.d.pending()
        self.d = self.d.cleanup()
        return roofline.cleanup_bytes(resident, survivors)

    def program_trace(self, on: bool):
        """On: forget the port's counters and turn its spans and counters on.
        Off: turn them off and return the counters (`obs.counters()`)."""
        from repro_torch import obs

        if on:
            obs.reset()
            obs.enable(True)
            return None
        obs.enable(False)
        return obs.counters()

    def lookup(self, keys):
        return self.d.lookup(keys)

    def count(self, k1, k2, plan: dict):
        return self.d.count(k1, k2, self._plan(plan))

    def range(self, k1, k2, plan: dict):
        return self.d.range(k1, k2, self._plan(plan))


def make(config: dict, devices) -> LSMFacade:
    return LSMFacade(config, devices)
