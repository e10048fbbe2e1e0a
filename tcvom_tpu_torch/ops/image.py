"""Image-tensor primitives on NCHW tensors (port of tcvom_tpu/ops/image.py).

The JAX versions were written to equal torch's own operators, so here they
are those operators: ``F.interpolate``, ``F.max_pool2d`` and
``F.adaptive_avg_pool2d``.
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
