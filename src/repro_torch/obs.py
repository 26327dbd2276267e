"""Spans and counters inside the dictionary path, for an operator's profile.

Tracing is off by default, and nothing but the caller turns it on: no
environment variable does. Off, a span site costs one read of a module-level
bool and enters a shared no-op context, and a counter site does nothing.

To see where an LSM dictionary's calls spend their time:

    import torch
    from repro_torch import obs

    obs.reset()
    obs.enable(True)
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU,
                                            torch.profiler.ProfilerActivity.CUDA]) as prof:
        d = d.update(keys, values, is_delete)
        found, vals = d.lookup(queries)
    obs.enable(False)
    print(obs.counters())          # e.g. {"host_syncs": 0, "cascade.carries.L3": 1, ...}

Each span is a `torch.profiler.record_function` named `repro_torch.<name>`,
so it lands on the profiler's host timeline beside the device operations it
launched and beside the caller's own spans: one clock. A span's parent is the
span that contains it on the same thread; the caller's span around a call
(a request) contains all of the call's spans.

Counters come in two kinds. Host counters (`count`) add numbers the host
already knows. Device counters (`count_device`) add a tensor's sum into an
accumulator on the tensor's device, in place, so the host never waits for
them; `counters()` reads them, once, and belongs after the profiled window.

Spans (each under `repro_torch.`): `api.update`, `api.lookup`, `api.count`,
`api.range`, `api.cleanup` (the facade's methods); `lsm.stage` (one
sub-batch into the write buffer); `ops.sort_recency` (the write buffer's
recency sort); `cascade.push` with `cascade.merge` (the K-way merge) and
`cascade.debt` (the placebo fills and the stale count); `cleanup` with
`cleanup.merge`, `cleanup.compact`, `cleanup.redistribute`; `queries.lookup`;
count and range's `queries.bounds` (stage 1), `queries.tile` (stages 2-3),
`queries.row_sort` (stage 4), `queries.select` (stage 5).

Counters: `host_syncs` (times the path waits for the device: the core's
reads of device data, counted on every device so that a CPU run shows where
the card would wait, and the facade's key-domain checks and copies of caller
inputs between host memory and the card, counted where they cross to or
from a card); `cascade.carries.L<j>` and `cascade.merged_elements`
(each carry into level j merges b * 2^j elements); `cleanup.resident` and
`cleanup.survivors`; `queries.tile_slots` (the candidate tile's slots) and
`queries.candidates` (the device counter of the slots that hold a
candidate).
"""

from __future__ import annotations

import contextlib
import threading

import torch

PREFIX = "repro_torch."

_on = False
_NOOP = contextlib.nullcontext()
_host: dict = {}
_device: dict = {}     # name -> {device: int64 accumulator}
_lock = threading.Lock()


def enable(on: bool) -> None:
    """Turn the spans and counters on or off (off at import)."""
    global _on
    _on = bool(on)


def enabled() -> bool:
    return _on


def span(name: str):
    """A context manager: the profiler span `repro_torch.<name>` when tracing
    is on, else one shared no-op."""
    if not _on:
        return _NOOP
    return torch.profiler.record_function(PREFIX + name)


def count(name: str, n: int = 1) -> None:
    """Add the host number `n` to the counter `name` (when tracing is on)."""
    if _on:
        with _lock:
            _host[name] = _host.get(name, 0) + n


def count_device(name: str, tensor: torch.Tensor) -> None:
    """Add `tensor`'s sum to the counter `name` on the tensor's device, with
    no host wait (when tracing is on). A site whose tensor costs a launch to
    make tests `enabled()` first."""
    if _on:
        with _lock:
            acc = _device.setdefault(name, {})
            if tensor.device not in acc:
                acc[tensor.device] = torch.zeros((), dtype=torch.int64, device=tensor.device)
            acc[tensor.device].add_(tensor.sum())


def counters() -> dict:
    """Every counter by name, host and device kinds together: one host read
    of the device accumulators per device. Call it after the window."""
    with _lock:
        out = dict(_host)
        by_device = {}
        for name, acc in _device.items():
            for dev, t in acc.items():
                by_device.setdefault(dev, []).append((name, t))
        for items in by_device.values():
            for (name, _), v in zip(items, torch.stack([t for _, t in items]).tolist()):
                out[name] = out.get(name, 0) + v
    return out


def reset() -> None:
    """Forget every counter."""
    with _lock:
        _host.clear()
        _device.clear()
