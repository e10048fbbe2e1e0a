"""fam_window_roofline: the FAM kernel's bound over its device time, in
the profiled sub-window: the larger of its bytes over the HBM bandwidth
and its operations over the dtype's peak (``kernels/fam_window.py`` on
the unknown masks the reference derives from the cell's trimaps), over
the time of the device operations whose names hold ``fam_window``."""
from mattebench import counts


def read(record: dict):
    return counts.roofline(record, "fam_window", "fam_window")
