"""launches_per_call.update (launches/call): device operations (kernels, copies,
fills) that started inside the benchmark's update spans of the traced window,
per update call, the cleanups the calls carried included. Profiler trace."""


def read(run):
    group = run.trace["groups"]["update"] if run.trace else None
    if not group or not group["calls"]:
        return None
    return group["launches"] / group["calls"]
