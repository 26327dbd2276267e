"""idle_share.query (%): 100 x (1 - the union of device operations' intervals
inside the benchmark's query spans / those spans' wall time), over the traced
window. Profiler trace."""


def read(run):
    group = run.trace["groups"]["query"] if run.trace else None
    if not group or not group["calls"] or group["wall_s"] <= 0:
        return None
    return 100.0 * (1.0 - group["busy_s"] / group["wall_s"])
