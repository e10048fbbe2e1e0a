"""Video matting metrics: SAD, MSE, SSDA, dtSSD and MESSDdt (port of
tcvom_tpu/ops/metrics.py; the reference's calc_metric.py:22-46 and the
flow-warped temporal error of utils/utils.py:90-123).

Every function takes ``[H, W]`` tensors (``[H, W, 2]`` for flow) on any
device; masks are bool or {0, 1}; invalid flow is NaN, as the quantized
flow PNGs encode it.
"""
from __future__ import annotations

import torch

from tcvom_tpu_torch.ops.image import coords_grid, grid_sample


def _mf(m: torch.Tensor, a: torch.Tensor) -> torch.Tensor:
    return m.to(a.dtype)


def sad(a, g, m):
    """Mean absolute difference over the mask (the reference's mSAD)."""
    mf = _mf(m, a)
    return torch.sum(torch.abs(a - g) * mf) / torch.clamp_min(mf.sum(), 1.0)


def mse(a, g, m):
    mf = _mf(m, a)
    return torch.sum((a - g) ** 2 * mf) / torch.clamp_min(mf.sum(), 1.0)


def ssda(a, g, m):
    return torch.sqrt(torch.sum((a - g) ** 2 * _mf(m, a)))


def dtssd(a, g, m, ha, hg):
    """sqrt of the masked SSD between temporal differences
    (calc_metric.py:31-34)."""
    d = (a - ha) - (g - hg)
    return torch.sqrt(torch.sum(d * d * _mf(m, a)))


def messddt(a, g, m, ha, hg, flow):
    """Flow-compensated temporal error (utils/utils.py:90-123,
    metric=True). ``flow`` ``[H, W, 2]`` (dx, dy) from the current to the
    adjacent frame, NaN where invalid. Returns (L1 sum, squared-difference
    sum, valid pixel count) over the valid pixels of the mask."""
    h, w = a.shape
    nan = torch.isnan(flow)
    coords = coords_grid(h, w, a.dtype, a.device) + torch.where(nan, 0.0, flow)
    valid = ~nan.any(-1) & (m if m.dtype == torch.bool else m > 0.5)
    vf = valid.to(a.dtype)
    pgt = grid_sample(hg[..., None], coords)[..., 0]
    pa = grid_sample(ha[..., None], coords)[..., 0]
    cur, warped = a - g, pa - pgt
    return (torch.sum(torch.abs(cur - warped) * vf),
            torch.sum(torch.abs(cur * cur - warped * warped) * vf),
            torch.sum(valid.to(torch.int32)))


def frame_metrics(a, g, tri, ha, hg, hvalid, flow) -> dict:
    """All per-frame metrics (the keys of calc_metric.py:128), 0-d tensors.

    a, g:   pred / gt alpha in [0, 1], f32 ``[H, W]``
    tri:    trimap image in [0, 255] (mask: 0 < tri < 255)
    ha, hg: next-frame pred / gt (ignored where ``hvalid`` is 0)
    flow:   ``[H, W, 2]`` flow to the next frame, NaN-invalid
    """
    mask = (tri > 0) & (tri < 255)
    fix, org, valid = messddt(a, g, mask, ha, hg, flow)
    hv = torch.as_tensor(hvalid, device=a.device)
    return {
        "mSAD": sad(a, g, mask),
        "MSE": mse(a, g, mask),
        "SSDA": ssda(a, g, mask),
        "pixel_count": mask.sum(dtype=torch.int32),
        "dtSSD": dtssd(a, g, mask, ha, hg) * hv.to(a.dtype),
        "MESSDdt_fix": fix * hv.to(a.dtype),
        "MESSDdt": org * hv.to(a.dtype),
        "flow_pixel_count": (valid * hv).to(torch.int32),
    }
