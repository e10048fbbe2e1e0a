"""launches_per_step: the device operations (kernels, copies, memsets) that
one step of the predictor queues, in the profiled sub-window: those whose
launch call starts inside a ``mattebench.encode`` span, over the number of
such spans, plus the same for ``mattebench.decode``. A step encodes once
and decodes once; a clip's edges add or drop decode calls, not their
size, and the batch widens the operations, not their number."""
import bisect

from mattebench import trace


def per_span(profile: dict, name: str):
    """Device operations queued inside the host spans named ``name``, a
    span (None without such a span)."""
    ranges = sorted((s[1], s[1] + s[2]) for s in profile["spans"]
                    if s[0] == name)
    if not ranges:
        return None
    starts = [r[0] for r in ranges]
    inside = set()
    for ts, corr in profile["launches"]:
        i = bisect.bisect_right(starts, ts) - 1
        if i >= 0 and ts <= ranges[i][1]:
            inside.add(corr)
    return sum(1 for o in profile["ops"] if o[3] in inside) / len(ranges)


def read(record: dict):
    prof = record.get("profile")
    if not prof or not prof["ops"]:
        return None
    encode = per_span(prof, trace.SPAN + "encode")
    decode = per_span(prof, trace.SPAN + "decode")
    if not encode or decode is None:
        return None
    return encode + decode
