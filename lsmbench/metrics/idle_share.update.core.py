"""idle_share.update.core (%): 100 x the idle seconds inside the benchmark's
update spans whose ending operation the host launched in the core's spans
(`repro_torch.lsm.*`, `ops.*`, `cascade.*`, `cleanup*`) / those spans' wall
time, over the traced window. The program's spans (lsmbench/progtrace.py)."""

from lsmbench import progtrace


def read(run):
    return progtrace.read(run, "idle_share.update.core")
