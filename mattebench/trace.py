"""The traced run's profile: the profiler's chrome trace of the profiled
sub-window reduced to what the per-layer readers read, and the arithmetic
they share.

A profile is a dict of lists (JSON as it stands, so a test can hand a
reader a canned one):

- ``ops``: ``[name, start_us, dur_us, correlation]`` of each device
  operation (kernels, copies and memsets);
- ``launches``: ``[start_us, correlation]`` of each host call that
  queued one (the CUDA runtime or driver call);
- ``spans``: ``[name, start_us, dur_us]`` of the benchmark's host spans
  (``mattebench.<what>``: ``window``, ``upload``, ``step``, ``encode``,
  ``decode``, ``readback``, ``wait``, ``clip_reset``).

Host and device times share the profiler's clock.
"""
from __future__ import annotations

import bisect
import json
from collections import defaultdict

DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
LAUNCH_CATS = ("cuda_runtime", "cuda_driver")
SPAN = "mattebench."


def reduce_chrome_trace(path: str) -> dict:
    """The profile of a chrome trace written by ``torch.profiler``."""
    with open(path) as f:
        data = json.load(f)
    events = data["traceEvents"] if isinstance(data, dict) else data
    ops, launches, spans = [], [], []
    for e in events:
        if e.get("ph") != "X":
            continue
        cat, args = e.get("cat"), e.get("args") or {}
        if cat in DEVICE_CATS:
            ops.append([e["name"], float(e["ts"]), float(e["dur"]),
                        args.get("correlation")])
        elif cat in LAUNCH_CATS and "correlation" in args:
            launches.append([float(e["ts"]), args["correlation"]])
        elif cat == "user_annotation" and e["name"].startswith(SPAN):
            spans.append([e["name"], float(e["ts"]), float(e["dur"])])
    return {"ops": ops, "launches": launches, "spans": spans}


def merged(intervals) -> list[tuple[float, float]]:
    """Sorted, overlapping ``(start, end)`` intervals joined."""
    out: list[list[float]] = []
    for a, b in sorted(intervals):
        if out and a <= out[-1][1]:
            out[-1][1] = max(out[-1][1], b)
        else:
            out.append([a, b])
    return [(a, b) for a, b in out]


def device_window(profile: dict) -> tuple[float, float] | None:
    """From the first device operation's start to the last one's end: the
    span in which every device operation was recorded (those queued before
    the profiler started ran before the first recorded one, on the one
    stream)."""
    ops = profile["ops"]
    if not ops:
        return None
    return min(o[1] for o in ops), max(o[1] + o[2] for o in ops)


def busy_us(profile: dict) -> float:
    """Microseconds in which some device operation ran: the union of their
    intervals, not the sum."""
    return sum(b - a for a, b in merged((o[1], o[1] + o[2])
                                        for o in profile["ops"]))


def idle_gaps(profile: dict) -> list[tuple[float, float]]:
    """The device's idle intervals inside :func:`device_window`."""
    busy = merged((o[1], o[1] + o[2]) for o in profile["ops"])
    return [(busy[i][1], busy[i + 1][0]) for i in range(len(busy) - 1)]


def device_us_in_spans(profile: dict, name: str) -> float:
    """Device microseconds of the operations queued inside the host spans
    named ``name`` (by their launch call's start)."""
    ranges = sorted((s[1], s[1] + s[2]) for s in profile["spans"]
                    if s[0] == name)
    starts = [r[0] for r in ranges]
    inside = set()
    for ts, corr in profile["launches"]:
        i = bisect.bisect_right(starts, ts) - 1
        if i >= 0 and ts <= ranges[i][1]:
            inside.add(corr)
    return sum(o[2] for o in profile["ops"] if o[3] in inside)


def device_us_named(profile: dict, part: str) -> float:
    """Device microseconds of the operations whose name holds ``part``."""
    return sum(o[2] for o in profile["ops"] if part in o[0])


def top_ops(profile: dict, n: int = 10) -> list[list]:
    """The ``n`` device operations that took the most time, summed by
    name (up to 120 characters), in seconds."""
    total: dict[str, float] = defaultdict(float)
    for o in profile["ops"]:
        total[o[0][:120]] += o[2]
    best = sorted(total.items(), key=lambda kv: -kv[1])[:n]
    return [[k, v / 1e6] for k, v in best]


def labelled_gaps(profile: dict, n: int = 10) -> list[list]:
    """The ``n`` longest idle gaps of the device, in seconds, each named
    by the innermost host span open at its middle (``other`` if none)."""
    spans = sorted(((s[1], s[1] + s[2], s[0][len(SPAN):])
                    for s in profile["spans"] if s[0] != SPAN + "window"),
                   key=lambda s: s[1] - s[0])
    out = []
    for a, b in sorted(idle_gaps(profile), key=lambda g: g[0] - g[1])[:n]:
        mid = (a + b) / 2
        label = next((s[2] for s in spans if s[0] <= mid <= s[1]), "other")
        out.append([label, (b - a) / 1e6])
    return out
