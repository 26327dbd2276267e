"""host_syncs_per_call.update (syncs/call): the times the port's path waited
for the device in the traced window (its `host_syncs` counter, whose sites
`repro_torch/obs.py` lists; three a cleanup) / the update calls in the
window. The program's counters (lsmbench/progtrace.py)."""

from lsmbench import progtrace


def read(run):
    return progtrace.read(run, "host_syncs_per_call.update")
