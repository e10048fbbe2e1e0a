"""argmax_pool_roofline: DIM's pool and unpool bound over their device
time, in the profiled sub-window: their bytes over the HBM bandwidth (each
pool's input read, its pooled values and uint8 indices written; each
unpool's input and indices read, its output written:
``kernels/argmax_pool.py``, counted over the reference's pools at the
cell's shapes and dtype), over the time of the device operations whose
names hold ``argmax_pool_`` (the program's pool and unpool kernels)."""
from mattebench import counts


def read(record: dict):
    return counts.roofline(record, "argmax_pool", "argmax_pool_")
