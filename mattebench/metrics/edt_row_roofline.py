"""edt_row_roofline: the EDT row pass's bound over its device time, in the
profiled sub-window: the larger of its bytes over the HBM bandwidth and
its operations over the f32 add/min peak (``kernels/edt_row.py``), over
the time of the device operations whose names hold ``edt_row``."""
from mattebench import counts


def read(record: dict):
    return counts.roofline(record, "edt_row", "edt_row")
