"""idle_share.update.facade (%): 100 x the idle seconds inside the
benchmark's update spans whose ending operation the host launched in the
facade's own time (`repro_torch.api.*` spans) / those spans' wall time, over
the traced window. With `.core` and the rest it adds up to
`idle_share.update`. The program's spans (lsmbench/progtrace.py)."""

from lsmbench import progtrace


def read(run):
    return progtrace.read(run, "idle_share.update.facade")
