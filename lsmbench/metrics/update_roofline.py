"""update_roofline (%): the least time of the traced window's update work (its
bytes, lsmbench/roofline.py, over the card's published bandwidth) over the
device time of every operation that started inside its spans. Profiler
trace."""

from lsmbench import roofline


def read(run):
    group = run.trace["groups"]["update"] if run.trace else None
    if not group or not group["calls"]:
        return None
    return roofline.share(run.bytes["update"], group["device_s"], run.device_name)
