"""step_mfu: FLOP per matte (the reference's encode and head on the meta
device, and the FAM attention's operations) times the traced run's
mattes per second outside its profiled sub-window, over the dtype's dense
peak."""
from mattebench import counts


def read(record: dict):
    rate = record.get("rate_outside")
    if not rate:
        return None
    return (100.0 * record["flop_per_matte"] * rate
            / counts.PEAK_FLOPS[record["dtype"]])
