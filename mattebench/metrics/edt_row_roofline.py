"""edt_row_roofline: the EDT row pass's bound over its device time, in the
profiled sub-window: the larger of its bytes over the HBM bandwidth and
its operations over the f32 add/min peak (``counts.edt_counts``), over
the time of the device operations whose names hold ``edt_row``."""
from mattebench import counts, trace


def read(record: dict):
    prof = record.get("profile")
    work = (prof or {}).get("work", {}).get("edt_row")
    if not work:
        return None
    us = trace.device_us_named(prof, "edt_row")
    return 100.0 * counts.bound_s(*work) / (us / 1e6) if us else None
