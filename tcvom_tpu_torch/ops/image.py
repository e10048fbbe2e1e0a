"""Image-tensor primitives (port of tcvom_tpu/ops/image.py).

The resizes and pools the models use take NCHW tensors. The JAX versions
were written to equal torch's own operators, so here they are those
operators: ``F.interpolate``, ``F.max_pool2d``, ``F.adaptive_avg_pool2d``,
``F.pixel_shuffle`` and ``F.pad`` (GCA's :func:`reflection_pad`). DIM's
argmax pool keeps its index as the in-window position (uint8), as the JAX
one does, not as torch's flat int64 (:func:`max_pool_argmax_2x2`).

The functions of the training stack (:func:`avg_pool`, :func:`unfold`,
:func:`image_gradient`, :func:`dilate_by_radius`) and of the metrics
(:func:`coords_grid`, :func:`grid_sample`) take channels-last
``[..., H, W, C]`` tensors with any leading dims, as the JAX ones do and as
the losses, the trimap synthesis and the metrics hold their tensors.
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


def max_pool_argmax_2x2(x: torch.Tensor
                        ) -> tuple[torch.Tensor, torch.Tensor]:
    """2x2, stride-2 max pool of ``[N, C, H, W]`` (H, W even) returning
    (pooled, idx): ``idx`` is the uint8 in-window position of the max in
    [0, 4), row-major, the first on ties, as ``nn.MaxPool2d(2, 2,
    return_indices=True)`` picks it. A quarter of torch's int64 flat index:
    a stream caches three levels of it per frame."""
    n, c, h, w = x.shape
    xv = x.view(n, c, h // 2, 2, w // 2, 2)
    a, b = xv[:, :, :, 0, :, 0], xv[:, :, :, 0, :, 1]
    d, e = xv[:, :, :, 1, :, 0], xv[:, :, :, 1, :, 1]
    # each pair keeps its first element unless the second is larger, and
    # the second pair wins only if strictly larger: the first max overall
    top, bottom = torch.maximum(a, b), torch.maximum(d, e)
    idx = torch.where(bottom > top, (e > d).to(torch.uint8) + 2,
                      (b > a).to(torch.uint8))
    return torch.maximum(top, bottom), idx


def max_unpool_2x2(x: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """Inverse of :func:`max_pool_argmax_2x2`: each value of ``[N, C, h, w]``
    goes to its recorded in-window slot of ``[N, C, 2h, 2w]``, zeros
    elsewhere (``nn.MaxUnpool2d(2, 2)``)."""
    n, c, h, w = x.shape
    slot = torch.arange(4, dtype=idx.dtype, device=idx.device).view(
        1, 1, 1, 2, 1, 2)
    out = torch.where(idx[:, :, :, None, :, None] == slot,
                      x[:, :, :, None, :, None], 0.0)
    return out.reshape(n, c, 2 * h, 2 * w)


def pixel_shuffle(x: torch.Tensor, r: int) -> torch.Tensor:
    """``[N, C*r*r, H, W] -> [N, C, H*r, W*r]``: channel ``c*r*r + dy*r +
    dx`` goes to offset (dy, dx) of channel c."""
    return F.pixel_shuffle(x, r)


def reflection_pad(x: torch.Tensor, pad: int) -> torch.Tensor:
    """Reflect-pad H and W of ``[N, C, H, W]`` by ``pad``
    (``nn.ReflectionPad2d``: the edge row is not repeated)."""
    return F.pad(x, (pad, pad, pad, pad), mode="reflect")


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


def coords_grid(h: int, w: int, dtype=torch.float32,
                device: str | torch.device = "cpu") -> torch.Tensor:
    """``[H, W, 2]`` grid of (x, y) pixel coordinates."""
    ys, xs = torch.meshgrid(torch.arange(h, dtype=dtype, device=device),
                            torch.arange(w, dtype=dtype, device=device),
                            indexing="ij")
    return torch.stack([xs, ys], dim=-1)


def grid_sample(img: torch.Tensor, coords: torch.Tensor,
                mode: str = "bilinear") -> torch.Tensor:
    """Sample ``img [..., H, W, C]`` at pixel ``coords [..., H', W', 2]``
    (x, y), as ``F.grid_sample(align_corners=True, padding_mode='zeros')``
    after the reference's pixel-to-normalized conversion (utils/utils.py:
    75-88): out-of-frame corners contribute zero. The weights are taken on
    the pixel coordinates themselves, as the JAX function takes them, so
    no normalization round trip moves them."""
    h, w, ch = img.shape[-3:]
    flat = img.reshape(img.shape[:-3] + (h * w, ch))
    x, y = coords[..., 0], coords[..., 1]

    def gather(iy, ix):
        idx = iy.clamp(0, h - 1) * w + ix.clamp(0, w - 1)
        idx = idx.reshape(idx.shape[:-2] + (-1, 1)).expand(
            idx.shape[:-2] + (idx.shape[-2] * idx.shape[-1], ch))
        out = torch.gather(flat, -2, idx).reshape(iy.shape + (ch,))
        inside = (iy >= 0) & (iy <= h - 1) & (ix >= 0) & (ix <= w - 1)
        return out * inside[..., None].to(img.dtype)

    if mode == "nearest":
        # torch rounds with floor(coord + 0.5) on the unnormalized grid
        return gather(torch.floor(y + 0.5).long(), torch.floor(x + 0.5).long())
    x0, y0 = torch.floor(x), torch.floor(y)
    wx, wy = (x - x0).to(img.dtype)[..., None], (y - y0).to(img.dtype)[..., None]
    x0i, y0i = x0.long(), y0.long()
    return (gather(y0i, x0i) * (1 - wx) * (1 - wy)
            + gather(y0i, x0i + 1) * wx * (1 - wy)
            + gather(y0i + 1, x0i) * (1 - wx) * wy
            + gather(y0i + 1, x0i + 1) * wx * wy)
