"""matte_p95_ms: the 95th percentile, over every matte delivered in the
window, of its latency: from the host handing in the frame to its matte
on the host (linear interpolation between order statistics)."""


def percentile(values, q: float) -> float:
    xs = sorted(values)
    pos = (len(xs) - 1) * q
    lo = int(pos)
    hi = min(lo + 1, len(xs) - 1)
    return xs[lo] + (xs[hi] - xs[lo]) * (pos - lo)


def read(record: dict):
    lat = [(arrived - handed) * 1e3 for handed, arrived in record["mattes"]]
    return percentile(lat, 0.95) if lat else None
