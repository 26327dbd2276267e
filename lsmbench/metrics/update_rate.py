"""update_rate (Melem/s): update lanes acknowledged in the window over the
window's seconds, cleanups included. Host clock."""


def read(run):
    if not run.latency_s["update"]:
        return None
    return run.work["update"] / run.window_s / 1e6
