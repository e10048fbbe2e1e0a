"""The comparison that decides ``correct``: mattes that the timed window
delivered to the host, against the reference's mattes of the same frames.

The reference (``mattebench/reference``, f32, TF32 off) is given the
benchmark's state dict and host frames, and recomputes each sampled
matte from its previous, current and next frame (reflected at the clip's
edges, as the stream reflects them). Each number compared is held
against its limit in the configuration file (``limits`` by the traffic's
dtype); the numbers:

- ``matte_mad_max``: the largest, over the sampled mattes of every
  stream, of the mean absolute difference in levels over the trimap's
  unknown pixels;
- ``off8_share_max``: the largest, over the sampled mattes, of the share
  of the unknown pixels whose level differs by more than 8;
- ``known_mismatch``: the trimap's known pixels (0 or 255) that differ
  from the reference's pasted trimap, over every sampled matte: exact,
  limit 0.

The configuration names the numbers it compares by giving them limits.

A matte of the wrong shape or type counts as failed.
"""
from __future__ import annotations

import torch

from mattebench import reference


class Sample:
    """A delivered matte batch: ``[streams, H, W]`` uint8 on the host,
    of clip frame ``clip_frame`` in a clip whose last frame is ``last``."""

    def __init__(self, clip_frame: int, last: int, mattes: torch.Tensor):
        self.clip_frame, self.last, self.mattes = clip_frame, last, mattes


def reference_mattes(config: dict, state_dict: dict, traffic, samples: list,
                     device, arith=reference.EXACT) -> list[torch.Tensor]:
    """The reference's uint8 mattes ``[streams, H, W]`` (host) of each
    sample's frames, computed on ``device`` a frame batch at a time, each
    encode kept while the next samples read it."""
    with reference.exact_math():
        ref = reference.Reference(
            config, {k: v.to(device) for k, v in state_dict.items()}, arith)
        cache: dict[int, dict] = {}
        out: list = [None] * len(samples)
        order = sorted(range(len(samples)),
                       key=lambda i: traffic.pool_index(samples[i].clip_frame))
        with torch.no_grad():
            for i in order:
                s = samples[i]
                pools = [traffic.pool_index(f) for f in
                         traffic.window(s.clip_frame, s.last)]
                for p in list(cache):
                    if p not in pools:
                        del cache[p]
                for p in pools:
                    if p not in cache:
                        img, tri = traffic.batch(p)
                        cache[p] = ref.encode(img.to(device), tri.to(device))
                out[i] = ref.matte(*(cache[p] for p in pools)).cpu()
        return out


OFF_LEVELS = 8


def compare(samples: list, want: list, traffic, limits: dict) -> dict:
    """Every number the check can compare (``numbers``), those that the
    configuration gives a limit (``checks``: each with its limit; all of
    them, without limits, where it gives none for this dtype), and the
    count of mattes (one stream's frame) outside a limit.

    ``matte_mad_max``: the largest mean absolute difference, in levels, over
    a matte's unknown pixels; ``off8_share_max``: the largest share of a
    matte's unknown pixels off by more than ``OFF_LEVELS`` levels;
    ``known_mismatch``: known pixels that differ, over every matte."""
    shape = (traffic.streams, traffic.height, traffic.width)
    per_matte = []
    known_bad = 0
    for s, w in zip(samples, want):
        tri = traffic.batch(s.clip_frame)[1][..., 0]
        got = s.mattes
        if got.shape != shape or got.dtype != torch.uint8:
            per_matte += [(float("inf"), 1.0, 1)] * traffic.streams
            known_bad += 1
            continue
        unknown = (tri > 0) & (tri < 255)
        diff = (got.int() - w.int()).abs()
        for b in range(traffic.streams):
            d = diff[b][unknown[b]].double()
            bad = int((diff[b][~unknown[b]] != 0).sum())
            known_bad += bad
            per_matte.append((d.mean().item(),
                              (d > OFF_LEVELS).double().mean().item(), bad))
    numbers = {"matte_mad_max": max((m[0] for m in per_matte), default=0.0),
               "off8_share_max": max((m[1] for m in per_matte), default=0.0),
               "known_mismatch": known_bad}
    names = [k for k in numbers if k in limits] or list(numbers)
    checks = {k: {"value": numbers[k], "limit": limits.get(k)} for k in names}
    def outside(m) -> bool:
        own = {"matte_mad_max": m[0], "off8_share_max": m[1]}
        return m[2] > 0 or any(limits.get(k) is None or own[k] > limits[k]
                               for k in own if k in names)

    failed = sum(outside(m) for m in per_matte)
    return {"numbers": numbers, "checks": checks, "failed": failed,
            "mattes": len(per_matte)}


def passed(checks: dict, mattes: int) -> bool:
    """Some matte checked, and every number within its limit."""
    return mattes > 0 and all(c["limit"] is not None and c["value"] <= c["limit"]
                              for c in checks.values())
