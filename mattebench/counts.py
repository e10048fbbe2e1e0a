"""The benchmark's shared yardstick of work: the published peaks of the
card, the least time a piece of work can take, a kernel's share of it,
and the FLOP of a matte counted over the reference model. What each
hand-written kernel reads and computes is counted by its own module,
``mattebench/kernels/<kernel>.py``.

Peaks: one NVIDIA H100 SXM (NVIDIA's data sheet, dense rates), at its full
700 W power limit.
"""
from __future__ import annotations

import torch
from torch.utils.flop_counter import FlopCounterMode

from mattebench import reference, trace
from mattebench.reference import common

HBM_BYTES_PER_S = 3.35e12
PEAK_FLOPS = {"bfloat16": 989e12,       # tensor cores, dense
              "float32": 67e12}         # outside the tensor cores
# an add or a min of f32 is one operation in one issue slot (the 67
# TFLOP/s above count a fused multiply-add as two): 132 SMs x 128 lanes x
# 1.98 GHz
PEAK_F32_ADD_MIN = 132 * 128 * 1.98e9


def bound_s(nbytes: float, ops: float, ops_per_s: float) -> float:
    """The least time the card could take: the larger of the bytes over
    the HBM bandwidth and the operations over the peak."""
    return max(nbytes / HBM_BYTES_PER_S, ops / ops_per_s)


def roofline(record: dict, kernel: str, part: str):
    """The share (%) of its bound that ``kernel`` reached in the traced
    run's profiled sub-window: its work's :func:`bound_s` over the time
    of the device operations whose names hold ``part``. None without its
    work or such operations."""
    prof = record.get("profile")
    work = (prof or {}).get("work", {}).get(kernel)
    if not work:
        return None
    us = trace.device_us_named(prof, part)
    return 100.0 * bound_s(*work) / (us / 1e6) if us else None


def meta_frame(config: dict, height: int, width: int):
    """The configuration's reference module, its state dict on the meta
    device and its prepared input of one blank ``height`` x ``width``
    frame moved there: the module's own ``prepare`` runs on the host, and
    only the shapes and dtypes it gives count."""
    model = reference.method(config)
    sd = {k: torch.empty(s, device="meta")
          for k, s in reference.spec(config).items()}
    img = torch.zeros(1, height, width, 3, dtype=torch.uint8)
    with torch.no_grad():
        pre = model.prepare(img, img[..., :1])

    def meta(t):
        if isinstance(t, torch.Tensor):
            return t.to("meta")
        return None if t is None else tuple(meta(u) for u in t)

    return model, sd, {k: meta(v) for k, v in pre.items()}


def flop_per_frame(config: dict, height: int, width: int) -> tuple[float, float]:
    """FLOP of one encode (network and FAM projections) and of one head
    at ``height`` x ``width``, counted by ``FlopCounterMode`` over the
    reference model on the meta device (convolutions and matrix
    products)."""
    model, sd, pre = meta_frame(config, height, width)
    with torch.no_grad(), FlopCounterMode(display=False) as enc_count:
        enc, feat = model.encode(common.EXACT, sd, pre["x"], pre["extras"])
        _, _, v = common.fam_projections(common.EXACT, sd, feat)
    with torch.no_grad(), FlopCounterMode(display=False) as head_count:
        model.head(common.EXACT, sd, enc, v)
    return float(enc_count.get_total_flops()), float(head_count.get_total_flops())
