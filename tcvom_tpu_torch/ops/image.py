"""Image-tensor primitives (port of tcvom_tpu/ops/image.py).

The resizes and pools the models use take NCHW tensors. The JAX versions
were written to equal torch's own operators, so here they are those
operators: ``F.interpolate``, ``F.max_pool2d`` and ``F.adaptive_avg_pool2d``.

The functions of the training stack (:func:`avg_pool`, :func:`unfold`,
:func:`image_gradient`, :func:`dilate_by_radius`) take channels-last
``[..., H, W, C]`` tensors with any leading dims, as the JAX ones do and as
the losses and the trimap synthesis hold their tensors.
"""
from __future__ import annotations

from typing import Sequence

import torch
import torch.nn.functional as F


def resize_bilinear(x: torch.Tensor, size: Sequence[int],
                    align_corners: bool = False) -> torch.Tensor:
    return F.interpolate(x, size=tuple(int(s) for s in size), mode="bilinear",
                         align_corners=align_corners)


def resize_nearest(x: torch.Tensor, size: Sequence[int]) -> torch.Tensor:
    """``src = floor(dst * in / out)``, torch's ``mode='nearest'``."""
    return F.interpolate(x, size=tuple(int(s) for s in size), mode="nearest")


def max_pool(x: torch.Tensor, window: int, stride: int | None = None,
             padding: int = 0) -> torch.Tensor:
    return F.max_pool2d(x, window, stride or window, padding)


def adaptive_avg_pool(x: torch.Tensor,
                      out_size: int | tuple[int, int]) -> torch.Tensor:
    """Bin i spans [floor(i*H/s), ceil((i+1)*H/s))."""
    return F.adaptive_avg_pool2d(x, out_size)


def _channels_last_op(fn, x: torch.Tensor) -> torch.Tensor:
    """Apply an NCHW op ``fn`` to ``[..., H, W, C]``."""
    lead = x.shape[:-3]
    y = fn(x.reshape((-1,) + x.shape[-3:]).permute(0, 3, 1, 2))
    y = y.permute(0, 2, 3, 1)
    return y.reshape(lead + y.shape[1:])


def avg_pool(x: torch.Tensor, window: int, stride: int | None = None,
             padding: int = 0) -> torch.Tensor:
    """Average pool over H, W of ``[..., H, W, C]`` (``F.avg_pool2d``)."""
    return _channels_last_op(
        lambda t: F.avg_pool2d(t, window, stride or window, padding), x)


def unfold(x: torch.Tensor, kernel: int) -> torch.Tensor:
    """Zero-padded ``kernel``x``kernel`` patches at stride 1:
    ``[..., H, W, C] -> [..., H, W, k*k, C]``, patch p row-major over
    (dy, dx), ``F.unfold``'s order."""
    r = kernel // 2
    h, w = x.shape[-3], x.shape[-2]
    xp = F.pad(x, (0, 0, r, r, r, r))
    return torch.stack([xp[..., dy:dy + h, dx:dx + w, :]
                        for dy in range(kernel) for dx in range(kernel)],
                       dim=-2)


def image_gradient(x: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """(dx, dy) forward differences of ``[..., H, W, C]`` with a zero
    column/row appended at the far edge (reference
    utils/loss_func.py:40-47)."""
    dy = F.pad(x[..., 1:, :, :] - x[..., :-1, :, :], (0, 0, 0, 0, 0, 1))
    dx = F.pad(x[..., :, 1:, :] - x[..., :, :-1, :], (0, 0, 0, 1))
    return dx, dy


def dilate_by_radius(mask: torch.Tensor, radius: int | torch.Tensor,
                     max_radius: int = 25) -> torch.Tensor:
    """Binary dilation of ``mask [..., H, W, C]`` by a Chebyshev radius.

    A Python-int ``radius`` (the eval path's fixed trimap width) is a
    separable two-pass max pool. A tensor ``radius`` (integers in
    [0, max_radius], broadcastable to the leading dims: one per sample) is
    the reference's per-sample ``max_pool2d(2r+1, pad=r)`` as iterated 3x3
    max pools, each sample taking the iterate its radius names."""
    if isinstance(radius, int):
        if radius == 0:
            return mask
        k = 2 * radius + 1
        return _channels_last_op(
            lambda t: F.max_pool2d(F.max_pool2d(t, (k, 1), 1, (radius, 0)),
                                   (1, k), 1, (0, radius)), mask)
    r = radius.to(mask.device).reshape(
        radius.shape + (1,) * (mask.dim() - radius.dim()))
    out = torch.where(r == 0, mask, torch.zeros_like(mask))
    cur = mask
    for i in range(max_radius):
        cur = _channels_last_op(lambda t: F.max_pool2d(t, 3, 1, 1), cur)
        out = torch.where(r == i + 1, cur, out)
    return out
