"""latency_p95_ms (ms): the 95th percentile of every call's latency in the
window (sent to outputs ready on the device), linear between order
statistics; cleanups inside the update calls that needed them. Host clock."""

import numpy as np


def read(run):
    lat = [t for times in run.latency_s.values() for t in times]
    if not lat:
        return None
    return float(np.percentile(np.asarray(lat), 95)) * 1e3
