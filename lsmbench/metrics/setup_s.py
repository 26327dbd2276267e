"""setup_s (s): process start (the top of run.py) to the first timed call:
imports, kernel build or load, the key table, the bulk build, the set-up's
updates and the warm-up calls. Host clock."""


def read(run):
    return run.setup_s
