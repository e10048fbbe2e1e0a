"""group_norm_roofline: the GroupNorm function's bound over its device
time, in the profiled sub-window: its bytes over the HBM bandwidth (each
norm's input read and output written once, and the residual read where
the block adds one after the norm: ``kernels/group_norm.py``, counted
over the reference's norms at the cell's shapes and dtype), over the
time of the device operations whose names hold ``group_norm_`` (the
program's statistics and apply kernels)."""
from mattebench import counts


def read(record: dict):
    return counts.roofline(record, "group_norm", "group_norm_")
