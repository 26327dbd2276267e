"""sort_share.update (%): 100 x the device seconds of the operations the host
launched inside the write buffer's recency sort (`repro_torch.ops.sort_recency`)
/ the device seconds of every operation launched inside the benchmark's update
spans, over the traced window. The program's spans (lsmbench/progtrace.py)."""

from lsmbench import progtrace


def read(run):
    return progtrace.read(run, "sort_share.update")
