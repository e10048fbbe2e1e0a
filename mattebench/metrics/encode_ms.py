"""encode_ms: device ms per frame of the work queued inside the
predictor's ``encode`` calls in the profiled sub-window."""
from mattebench import trace


def read(record: dict):
    prof = record.get("profile")
    if not prof or not prof["frames_encoded"]:
        return None
    us = trace.device_us_in_spans(prof, trace.SPAN + "encode")
    return us / 1e3 / prof["frames_encoded"] if us else None
