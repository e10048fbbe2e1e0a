"""Matting losses on channels-last ``[..., H, W, C]`` tensors (port of
tcvom_tpu/ops/losses.py), with the reference's normalization constants
(utils/loss_func.py):

- ``l1_mask``        masked L1 with the clamped ``safe`` denominator
- ``l1_grad``        L1 between gradient magnitudes
- ``exclusion_loss`` 3-level F/B gradient exclusion
- ``lap_loss``       5-level Laplacian pyramid L1 (OpenCV pyrDown/pyrUp)
- ``sparsity_loss``
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from tcvom_tpu_torch.ops.image import avg_pool, image_gradient

EPSILON = 1.001e-5

_GAUSS_5x5 = torch.tensor([[1., 4., 6., 4., 1.],
                           [4., 16., 24., 16., 4.],
                           [6., 24., 36., 24., 6.],
                           [4., 16., 24., 16., 4.],
                           [1., 4., 6., 4., 1.]]) / 256.0


def l1_mask(x: torch.Tensor, y: torch.Tensor, mask: torch.Tensor | None = None,
            epsilon: float = EPSILON, normalize: bool = True) -> torch.Tensor:
    """Masked L1. With a mask and ``normalize``, divides by the count of
    mask pixels above ``epsilon`` clamped to [epsilon, y.numel() + 1]."""
    res = torch.abs(x - y)
    if mask is not None:
        res = res * mask
        if normalize:
            safe = torch.clamp((mask > epsilon).to(x.dtype).sum(), epsilon,
                               float(y.numel()) + 1)
            return res.sum() / safe
        return res.sum()
    return res.mean() if normalize else res.sum()


def l1_grad(pred: torch.Tensor, gt: torch.Tensor,
            mask: torch.Tensor | None = None, epsilon: float = EPSILON,
            normalize: bool = True) -> torch.Tensor:
    """L1 between gradient magnitudes ``sqrt(dx^2 + dy^2 + eps)``."""
    fx, fy = image_gradient(pred)
    tx, ty = image_gradient(gt)
    mag_f = torch.sqrt(fx * fx + fy * fy + epsilon)
    mag_t = torch.sqrt(tx * tx + ty * ty + epsilon)
    return l1_mask(mag_f, mag_t, mask=mask, normalize=normalize)


def exclusion_loss(img1: torch.Tensor, img2: torch.Tensor, level: int = 3,
                   epsilon: float = EPSILON,
                   normalize: bool = True) -> torch.Tensor:
    """Gradient exclusion between predicted F and B over ``level`` 2x
    average-pooled levels; per-sample means over (H, W, C)."""
    gradx, grady = [], []
    red = (-3, -2, -1)
    for _ in range(level):
        gx1, gy1 = image_gradient(img1)
        gx2, gy2 = image_gradient(img2)
        ax = 2.0 * gx1.abs().mean() / (gx2.abs().mean() + epsilon)
        ay = 2.0 * gy1.abs().mean() / (gy2.abs().mean() + epsilon)
        gx1s = torch.sigmoid(gx1) * 2 - 1
        gy1s = torch.sigmoid(gy1) * 2 - 1
        gx2s = torch.sigmoid(gx2 * ax) * 2 - 1
        gy2s = torch.sigmoid(gy2 * ay) * 2 - 1
        sx = (gx1s ** 2 * gx2s ** 2).mean(dim=red) + epsilon
        sy = (gy1s ** 2 * gy2s ** 2).mean(dim=red) + epsilon
        gradx.append(sx ** 0.25)
        grady.append(sy ** 0.25)
        img1 = avg_pool(img1, 2, 2)
        img2 = avg_pool(img2, 2, 2)
    gx = sum(gradx) / float(level)
    gy = sum(grady) / float(level)
    if normalize:
        return gx.mean() + gy.mean()
    return gx.sum() + gy.sum()


def sparsity_loss(pred: torch.Tensor, trimask: torch.Tensor, eps: float = 1e-5,
                  gamma: float = 0.9) -> torch.Tensor:
    m = (trimask > 0.5).to(pred.dtype)
    term = (pred + eps) ** gamma + (1.0 - pred + eps) ** gamma - 1.0
    return (term * m).sum()


def _conv_gauss(img: torch.Tensor, scale: float) -> torch.Tensor:
    """Depthwise ``scale`` * Gauss 5x5, reflect-padded, on NCHW."""
    c = img.shape[1]
    k = (_GAUSS_5x5 * scale).to(img).expand(c, 1, 5, 5)
    return F.conv2d(F.pad(img, (2, 2, 2, 2), mode="reflect"), k, groups=c)


def _lap_pyramid(img: torch.Tensor, levels: int) -> list[torch.Tensor]:
    current, pyr = img, []
    for _ in range(levels):
        down = _conv_gauss(current, 1.0)[:, :, ::2, ::2]
        # zero-interleaved upsample then 4 * Gauss (OpenCV pyrUp)
        n, c, h, w = down.shape
        up = down.new_zeros((n, c, 2 * h, 2 * w))
        up[:, :, ::2, ::2] = down
        pyr.append(current - _conv_gauss(up, 4.0))
        current = down
    return pyr


def lap_loss(img: torch.Tensor, tgt: torch.Tensor, max_levels: int = 5,
             normalize: bool = True) -> torch.Tensor:
    """Laplacian-pyramid L1 over ``max_levels`` levels with 2^level
    weights, divided by ``tgt.numel()`` when ``normalize``. The reference
    call sites pass no mask, and a full-resolution mask cannot weight the
    coarser levels, so none is taken."""
    def nchw(t):
        return t.reshape((-1,) + t.shape[-3:]).permute(0, 3, 1, 2)

    loss = sum((2 ** lvl) * l1_mask(a, b, normalize=False)
               for lvl, (a, b) in enumerate(zip(
                   _lap_pyramid(nchw(img), max_levels),
                   _lap_pyramid(nchw(tgt), max_levels))))
    return loss / float(tgt.numel()) if normalize else loss
