"""The benchmark's yardstick of work: the published peaks of the card, the
operations and bytes of the two hand-written kernels, and the FLOP of a
matte counted over the reference model.

Peaks: one NVIDIA H100 SXM (NVIDIA's data sheet, dense rates), at its full
700 W power limit.
"""
from __future__ import annotations

import torch
from torch.utils.flop_counter import FlopCounterMode

from mattebench import reference
from mattebench.reference import common

HBM_BYTES_PER_S = 3.35e12
PEAK_FLOPS = {"bfloat16": 989e12,       # tensor cores, dense
              "float32": 67e12}         # outside the tensor cores
# an add or a min of f32 is one operation in one issue slot (the 67
# TFLOP/s above count a fused multiply-add as two): 132 SMs x 128 lanes x
# 1.98 GHz
PEAK_F32_ADD_MIN = 132 * 128 * 1.98e9
# The EDT row pass's least exact algorithm: a min-plus convolution with the
# convex kernel d^2, done by a lower-envelope pass in which each value
# enters and leaves the envelope once: a few adds, a divide and compares
# each, counted high as 16 operations an output.
EDT_OPS_PER_OUTPUT = 16


def bound_s(nbytes: float, ops: float, ops_per_s: float) -> float:
    """The least time the card could take: the larger of the bytes over
    the HBM bandwidth and the operations over the peak."""
    return max(nbytes / HBM_BYTES_PER_S, ops / ops_per_s)


def fam_counts(mask: torch.Tensor, channels: int, window: int,
               itemsize: int) -> tuple[float, float]:
    """Bytes and operations of one FAM window attention (inference, no
    logits) over ``mask`` (``[N, h, w]``, nonzero inside: each call of the
    stream has both neighbours' rows, so N is twice the streams). Bytes:
    q, k and the mask read, the output written, once each. Operations: a
    multiply-add for the dot and one for the weighted sum, per channel of
    each in-frame neighbour of each pixel inside the mask (outside it the
    output is 0 whatever q and k)."""
    n, h, w = mask.shape
    r = window // 2
    ny = torch.tensor([min(y + r, h - 1) - max(y - r, 0) + 1 for y in range(h)],
                      dtype=torch.float64)
    nx = torch.tensor([min(x + r, w - 1) - max(x - r, 0) + 1 for x in range(w)],
                      dtype=torch.float64)
    inside = (mask != 0).double().cpu()
    nbytes = (3 * n * h * w * channels + n * h * w) * itemsize
    ops = 4.0 * channels * (inside * torch.outer(ny, nx)).sum().item()
    return float(nbytes), ops


def fam_mask(tri_u8: torch.Tensor, grid: tuple[int, int]) -> torch.Tensor:
    """The unknown region of uint8 trimaps ``[N, H, W, 1]`` at the FAM's
    grid, as the reference derives it: ``[N, h, w]``."""
    s = tri_u8.float() * torch.tensor(common.IMG_SCALE, dtype=torch.float32)
    trimask = common.nchw(((s > 0) & (s < 1)).float())
    return (common.resize_nearest(trimask, grid) > 0.5)[:, 0]


def edt_counts(rows: int, width: int) -> tuple[float, float]:
    """Bytes and operations of one EDT row pass over ``rows`` rows of
    ``width``: each f32 input read once and each output written once,
    ``EDT_OPS_PER_OUTPUT`` operations an output."""
    return 8.0 * rows * width, float(EDT_OPS_PER_OUTPUT * rows * width)


def edt_rows(streams: int, height: int) -> int:
    """Rows of the row pass for one encode of ``streams`` frames: the
    background and the foreground maps of each."""
    return 2 * streams * height


def flop_per_frame(config: dict, height: int, width: int) -> tuple[float, float]:
    """FLOP of one encode (network and FAM projections) and of one head
    at ``height`` x ``width``, counted by ``FlopCounterMode`` over the
    reference model on the meta device (convolutions and matrix
    products)."""
    model = reference.MODELS[config["method"]]
    sd = {k: torch.empty(s, device="meta")
          for k, s in reference.spec(config).items()}
    x = torch.empty(1, 3 + model.TRIMAP_CHANNELS, height, width, device="meta")
    extras = (torch.empty(1, 3, height, width, device="meta"),
              torch.empty(1, 2, height, width, device="meta"))
    with torch.no_grad(), FlopCounterMode(display=False) as enc_count:
        enc, feat = model.encode(common.EXACT, sd, x, extras)
        _, _, v = common.fam_projections(common.EXACT, sd, feat)
    with torch.no_grad(), FlopCounterMode(display=False) as head_count:
        model.head(common.EXACT, sd, enc, v)
    return float(enc_count.get_total_flops()), float(head_count.get_total_flops())
