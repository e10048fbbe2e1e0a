"""fam_window_roofline: the FAM kernel's bound over its device time, in
the profiled sub-window: the larger of its bytes over the HBM bandwidth
and its operations over the dtype's peak (``counts.fam_counts`` on the
unknown masks the reference derives from the cell's trimaps), over the
time of the device operations whose names hold ``fam_window``."""
from mattebench import counts, trace


def read(record: dict):
    prof = record.get("profile")
    work = (prof or {}).get("work", {}).get("fam_window")
    if not work:
        return None
    us = trace.device_us_named(prof, "fam_window")
    return 100.0 * counts.bound_s(*work) / (us / 1e6) if us else None
