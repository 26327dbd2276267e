"""What a traced window's profiler events say, summarised in memory.

The benchmark wraps the window in a `lsmbench.window` span and each call in a
span of its own (`lsmbench.update`, `lsmbench.lookup`, `lsmbench.count`,
`lsmbench.range`, and `lsmbench.cleanup` inside the update call that needed
it), with `torch.profiler.record_function`. Every call ends in a device
synchronise, so the device work a call launched runs inside its span. The
client makes a call's inputs between calls, in a `lsmbench.client` span, and
waits for them before the call. A
device operation belongs to the span in which the host launched it: the
start of the CPU op (or span) it is linked to by the profiler's correlation
id, which is on the host's clock like the spans, and not the start of the
operation itself, which the profiler takes from the device's clock (the two
can disagree by tens of microseconds, enough to put a call's last kernels in
the next span).

From the events: the device operations (kernels, copies, fills; not the
profiler's own annotations), the union of their intervals (busy time), and
per group of spans the calls, the wall time, the busy time inside them, the
operations launched and their summed device time. With operations on several devices, the busy time is each device's
union, averaged over the devices. Idle gaps are the window's time outside the
union, labelled by the innermost span the host was in at the gap's middle
("client" while it makes the next call's inputs, "between_calls" outside any
call). The profiler's device-time helpers in
`chip_smoke.py` (`profile`, `kernel_ms`) read the same events through
`key_averages()`; this reads `kineto_results` directly, which stays fast at
hundreds of thousands of events.
"""

from __future__ import annotations

import bisect

PREFIX = "lsmbench."
GROUPS = {
    "update": ("update",),
    "query": ("lookup", "count", "range"),
    "lookup": ("lookup",),
    "scan": ("count", "range"),
}


def kineto_events(prof):
    """(device ops, spans) of a stopped `torch.profiler.profile`: ops as
    (name, start_ns, end_ns, launched_ns, device index), spans as (name
    without the prefix, start_ns, end_ns)."""
    import torch

    cuda = torch.autograd.DeviceType.CUDA
    device, spans, host_start = [], [], {}
    for e in prof.profiler.kineto_results.events():
        if e.device_type() == cuda:
            if not e.is_user_annotation():
                device.append((e.name(), e.start_ns(), e.start_ns() + e.duration_ns(), e.linked_correlation_id(),
                               e.device_index()))
            continue
        # Torch ops and spans, by their id; CUDA runtime calls carry the
        # device's correlation ids instead, which would collide with these.
        if e.linked_correlation_id() == 0 and not e.name().startswith("cu"):
            host_start[e.correlation_id()] = e.start_ns()
        if e.is_user_annotation() and e.name().startswith(PREFIX):
            spans.append((e.name()[len(PREFIX):], e.start_ns(), e.start_ns() + e.duration_ns()))
    ops = [(name, s, e, host_start.get(link, s), index) for name, s, e, link, index in device]
    return ops, spans


def _union(intervals):
    merged = []
    for s, e in sorted(intervals):
        if merged and s <= merged[-1][1]:
            if e > merged[-1][1]:
                merged[-1][1] = e
        else:
            merged.append([s, e])
    return merged


def _overlap(a, b) -> int:
    """Total length of the intersection of two sorted disjoint interval lists."""
    i = j = total = 0
    while i < len(a) and j < len(b):
        lo, hi = max(a[i][0], b[j][0]), min(a[i][1], b[j][1])
        if hi > lo:
            total += hi - lo
        if a[i][1] < b[j][1]:
            i += 1
        else:
            j += 1
    return total


def _within(starts, ends, t) -> bool:
    k = bisect.bisect_right(starts, t) - 1
    return k >= 0 and t < ends[k]


def _busy_ns(ops) -> tuple:
    """(the union of the ops' intervals over all devices, its length per
    device averaged over the devices)."""
    per_device = {}
    for _, s, e, _, index in ops:
        per_device.setdefault(index, []).append((s, e))
    lengths = [sum(e - s for s, e in _union(iv)) for iv in per_device.values()]
    return _union([(s, e) for _, s, e, _, _ in ops]), (sum(lengths) / len(lengths) if lengths else 0)


def summarize(ops, spans, top: int = 10) -> dict:
    """Seconds and counts of one traced window (see the module docstring)."""
    windows = [(s, e) for name, s, e in spans if name == "window"]
    if not windows:
        raise ValueError("no lsmbench.window span in the trace")
    w0, w1 = windows[0]
    ops = [(n, max(s, w0), min(e, w1), t, d) for n, s, e, t, d in ops if e > w0 and s < w1]
    busy, busy_ns = _busy_ns(ops)
    out = {
        "window_s": (w1 - w0) / 1e9,
        "busy_s": busy_ns / 1e9,
        "ops": len(ops),
        "groups": {},
    }
    by_launch = sorted((t, e - s) for _, s, e, t, _ in ops)
    launches = [t for t, _ in by_launch]
    for group, names in GROUPS.items():
        sp = sorted((s, e) for name, s, e in spans if name in names)
        ss, se = [s for s, _ in sp], [e for _, e in sp]
        lo = bisect.bisect_left(launches, ss[0]) if sp else len(launches)
        launched = device_ns = 0
        for t, duration in by_launch[lo:]:
            if t >= se[-1]:
                break
            if _within(ss, se, t):
                launched += 1
                device_ns += duration
        out["groups"][group] = {
            "calls": len(sp),
            "wall_s": sum(e - s for s, e in sp) / 1e9,
            "busy_s": _overlap(busy, [list(x) for x in sp]) / 1e9,
            "launches": launched,
            "device_s": device_ns / 1e9,
        }
    per_name = {}
    for name, s, e, _, _ in ops:
        per_name[name] = per_name.get(name, 0) + (e - s)
    out["device_ops"] = [[n, t / 1e9] for n, t in sorted(per_name.items(), key=lambda x: -x[1])[:top]]
    # Idle gaps, labelled by the innermost span at their middle.
    layers = []
    for names in (("client",), ("cleanup",), ("update", "lookup", "count", "range")):
        sp = sorted((s, e, name) for name, s, e in spans if name in names)
        layers.append(([s for s, _, _ in sp], [e for _, e, _ in sp], [n for _, _, n in sp]))
    gaps = {}
    edges = [w0] + [x for iv in busy for x in iv] + [w1]
    for g0, g1 in zip(edges[0::2], edges[1::2]):
        if g1 <= g0:
            continue
        mid, label = (g0 + g1) // 2, "between_calls"
        for ss, se, names in layers:
            k = bisect.bisect_right(ss, mid) - 1
            if k >= 0 and mid < se[k]:
                label = names[k]
                break
        gaps[label] = gaps.get(label, 0) + (g1 - g0)
    out["idle_gaps"] = [[n, t / 1e9] for n, t in sorted(gaps.items(), key=lambda x: -x[1])[:top]]
    return out
