"""cleanup_share (%): 100 x the window's wall time inside the benchmark's
cleanup spans (each ends in a device synchronise) / the window's. None in a
cell that sends no update."""


def read(run):
    if not run.latency_s["update"]:
        return None
    return 100.0 * run.cleanup_s / run.window_s
