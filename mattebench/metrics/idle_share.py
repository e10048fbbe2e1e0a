"""idle_share: the share of the profiled sub-window's device span (first
operation's start to last one's end) in which no device operation ran:
the union of their intervals, not their sum."""
from mattebench import trace


def read(record: dict):
    prof = record.get("profile")
    span = trace.device_window(prof) if prof else None
    if not span or span[1] <= span[0]:
        return None
    return 100.0 * (1.0 - trace.busy_us(prof) / (span[1] - span[0]))
