"""launches_per_call.query (launches/call): device operations (kernels, copies,
fills) that started inside the benchmark's query spans of the traced window,
per query call. Profiler trace."""


def read(run):
    group = run.trace["groups"]["query"] if run.trace else None
    if not group or not group["calls"]:
        return None
    return group["launches"] / group["calls"]
