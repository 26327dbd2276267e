"""Faults planted in the program under test, for the tests and the chip
runs that show the check catches them. Each is a context manager that
patches one function of `repro_torch` and restores it on exit.

* `unchanged`: an update call stages nothing (a step that returns its
  state unchanged).
* `half_batch`: each staged sub-batch keeps only its first half of lanes.
* `lookup_altered`, `count_altered`, `range_altered`: one answer of each
  call is altered where it is produced.
"""

from __future__ import annotations

import contextlib

FAULTS = ("unchanged", "half_batch", "lookup_altered", "count_altered", "range_altered")


def _patch(obj, name, make):
    old = getattr(obj, name)
    setattr(obj, name, make(old))
    return lambda: setattr(obj, name, old)


@contextlib.contextmanager
def planted(fault: str):
    from repro_torch.api import backends
    from repro_torch.core import queries

    if fault == "unchanged":
        undo = _patch(backends.LSMBackend, "stage_encoded", lambda old: lambda self, state, kv, val, count: state)
    elif fault == "half_batch":
        undo = _patch(backends.LSMBackend, "stage_encoded",
                      lambda old: lambda self, state, kv, val, count: old(self, state, kv, val, count // 2))
    elif fault == "lookup_altered":
        def make(old):
            def lookup_runs(runs, keys):
                found, vals = old(runs, keys)
                vals = vals.clone()
                vals[0] += 1
                return found, vals
            return lookup_runs
        undo = _patch(queries, "lookup_runs", make)
    elif fault == "count_altered":
        def make(old):
            def count_runs(*args, **kw):
                counts, ok = old(*args, **kw)
                counts = counts.clone()
                counts[0] += 1
                return counts, ok
            return count_runs
        undo = _patch(queries, "count_runs", make)
    elif fault == "range_altered":
        def make(old):
            def range_runs(*args, **kw):
                keys, vals, counts, ok = old(*args, **kw)
                vals = vals.clone()
                vals[0, 0] += 1
                return keys, vals, counts, ok
            return range_runs
        undo = _patch(queries, "range_runs", make)
    else:
        raise ValueError(f"unknown fault {fault!r}; one of {FAULTS}")
    try:
        yield
    finally:
        undo()

