"""decode_ms: device ms per matte of the work queued inside the
predictor's ``decode`` calls (FAM, the decoder head, paste and quantize)
in the profiled sub-window."""
from mattebench import trace


def read(record: dict):
    prof = record.get("profile")
    if not prof or not prof["mattes_decoded"]:
        return None
    us = trace.device_us_in_spans(prof, trace.SPAN + "decode")
    return us / 1e3 / prof["mattes_decoded"] if us else None
