"""Image-tensor primitives (port of tcvom_tpu/ops/image.py).

The resizes and pools the models use take NCHW tensors. The JAX versions
were written to equal torch's own operators, so here they are those
operators: ``F.interpolate``, ``F.max_pool2d``, ``F.adaptive_avg_pool2d``,
``F.avg_pool2d``, ``F.pixel_shuffle`` and ``F.pad`` (GCA's
:func:`reflection_pad`). DIM's argmax pool keeps its index as the
in-window position (uint8), as the JAX one does, not as torch's flat
int64 (:func:`max_pool_argmax_2x2`); on the card it and its unpool run as
hand-written kernels (``ops/argmax_pool_kernel.py``).

In band mode (``parallel.space``: the input is this rank's horizontal
band of each frame) the resizes and pools that couple rows take their
halos from the other bands: :func:`max_pool` and :func:`resize_bilinear`
(x2) read rows across the band's edges, :func:`reflection_pad` takes
them too and reflects at the frame's edges only, :func:`adaptive_avg_pool`
sums its bins over every band and returns the whole pooled map; the
nearest resize, the pixel shuffle, the 2x2 average pool and the 2x2
argmax pool and unpool stay within the band, which they check.

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

from tcvom_tpu_torch.ops import argmax_pool_kernel
from tcvom_tpu_torch.parallel import space


def resize_bilinear(x: torch.Tensor, size: Sequence[int],
                    align_corners: bool = False) -> torch.Tensor:
    """Bilinear resize of ``[N, C, H, W]`` to ``size``. In band mode only
    the x2 upsampling of a band (``size`` twice the band's rows): one
    source row above and one below from the neighbouring bands, resized,
    then cropped, which the exact scale makes exact; rows are clamped
    only at the frame's edges."""
    size = tuple(int(s) for s in size)
    bands = space.current()
    if bands is None:
        return F.interpolate(x, size=size, mode="bilinear",
                             align_corners=align_corners)
    h = x.shape[-2]
    if align_corners or size[0] != 2 * h:
        raise ValueError(f"band mode resizes a band x2 only, not {h} rows "
                         f"to {size[0]}")
    lo, hi, height = bands.span(h)
    top, bottom = int(lo > 0), int(hi < height)
    ext = bands.rows(x, lo - 1, hi + 1)[..., 1 - top:h + 1 + bottom, :]
    y = F.interpolate(ext, size=(2 * (h + top + bottom), size[1]),
                      mode="bilinear", align_corners=False)
    return y[..., 2 * top:2 * (top + h), :]


def _local(x: torch.Tensor, rows: int) -> None:
    """In band mode: that ``x`` and a result of ``rows`` rows are both
    bands (the scale between them a power of two, and the band's edges on
    whole rows of both), so that a nearest resize or 2x2 pool between
    them reads only its own band; :meth:`Bands.scale` raises if not."""
    bands = space.current()
    if bands is not None:
        bands.scale(x.shape[-2])
        bands.scale(rows)


def resize_nearest(x: torch.Tensor, size: Sequence[int]) -> torch.Tensor:
    """``src = floor(dst * in / out)``, torch's ``mode='nearest'``. Within
    the band in band mode (a whole ratio of rows)."""
    _local(x, int(size[0]))
    return F.interpolate(x, size=tuple(int(s) for s in size), mode="nearest")


def max_pool(x: torch.Tensor, window: int, stride: int | None = None,
             padding: int = 0) -> torch.Tensor:
    """``F.max_pool2d``; in band mode on the rows the band's output reads,
    padded with -inf at the frame's edges only."""
    stride = stride or window
    bands = space.current()
    if bands is None:
        return F.max_pool2d(x, window, stride, padding)
    x = bands.window(x, window, stride, 1, padding, fill=float("-inf"))
    return F.max_pool2d(x, window, stride, (0, padding))


def adaptive_avg_pool(x: torch.Tensor,
                      out_size: int | tuple[int, int]) -> torch.Tensor:
    """Bin i spans [floor(i*H/s), ceil((i+1)*H/s)). In band mode over the
    global H: each bin sums this band's rows of it (in at least f32), the
    sums are summed over the bands, and the whole pooled map is returned
    on every rank."""
    bands = space.current()
    if bands is None:
        return F.adaptive_avg_pool2d(x, out_size)
    sh, sw = (out_size, out_size) if isinstance(out_size, int) else out_size
    lo, hi, height = bands.span(x.shape[-2])
    w = x.shape[-1]
    xf = x.to(torch.promote_types(x.dtype, torch.float32))
    sums, areas = [], []
    for i in range(sh):
        a, b = (i * height) // sh, -((-(i + 1) * height) // sh)
        band = xf[..., max(a, lo) - lo:max(min(b, hi), lo) - lo, :].sum(-2)
        for j in range(sw):
            c, d = (j * w) // sw, -((-(j + 1) * w) // sw)
            sums.append(band[..., c:d].sum(-1))
            areas.append((b - a) * (d - c))
    total = bands.sum_over_bands(torch.stack(sums, -1))
    out = total / torch.tensor(areas, dtype=total.dtype, device=x.device)
    return out.reshape(x.shape[:-2] + (sh, sw)).to(x.dtype)


def max_pool_argmax_2x2(x: torch.Tensor
                        ) -> tuple[torch.Tensor, torch.Tensor]:
    """2x2, stride-2 max pool of ``[N, C, H, W]`` (H, W even) returning
    (pooled, idx): ``idx`` is the uint8 in-window position of the max in
    [0, 4), row-major, the first on ties, as ``nn.MaxPool2d(2, 2,
    return_indices=True)`` picks it. A quarter of torch's int64 flat index:
    a stream caches three levels of it per frame. Within the band in band
    mode. The plain ops on the CPU and where a gradient is needed, else
    the kernel (``ops/argmax_pool_kernel.py``), bit for bit the same."""
    _local(x, x.shape[-2] // 2)
    if argmax_pool_kernel.runs_plain(x):
        return argmax_pool_kernel.max_pool_argmax_2x2_ref(x)
    return argmax_pool_kernel.argmax_pool_cuda(x)


def max_unpool_2x2(x: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """Inverse of :func:`max_pool_argmax_2x2`: each value of ``[N, C, h, w]``
    goes to its recorded in-window slot of ``[N, C, 2h, 2w]``, zeros
    elsewhere (``nn.MaxUnpool2d(2, 2)``). Within the band in band mode.
    Dispatched as :func:`max_pool_argmax_2x2` is."""
    _local(x, 2 * x.shape[-2])
    if argmax_pool_kernel.runs_plain(x):
        return argmax_pool_kernel.max_unpool_2x2_ref(x, idx)
    return argmax_pool_kernel.argmax_unpool_cuda(x, idx)


def avg_pool_2x2(x: torch.Tensor) -> torch.Tensor:
    """2x2, stride-2 average pool of ``[N, C, H, W]`` (``nn.AvgPool2d(2,
    2)``). Within the band in band mode."""
    _local(x, x.shape[-2] // 2)
    return F.avg_pool2d(x, 2, 2)


def pixel_shuffle(x: torch.Tensor, r: int) -> torch.Tensor:
    """``[N, C*r*r, H, W] -> [N, C, H*r, W*r]``: channel ``c*r*r + dy*r +
    dx`` goes to offset (dy, dx) of channel c. Within the band in band
    mode."""
    _local(x, x.shape[-2] * r)
    return F.pixel_shuffle(x, r)


def reflection_pad(x: torch.Tensor, pad: int) -> torch.Tensor:
    """Reflect-pad H and W of ``[N, C, H, W]`` by ``pad``
    (``nn.ReflectionPad2d``: the edge row is not repeated).

    In band mode the band's rows with ``pad`` more on each side: the
    neighbouring bands' rows at an inner edge, the reflection only at
    the frame's top and bottom; W is whole and reflects as before. The
    result is the window that a following padding-0 op reads for this
    band of its output, no band itself: that op runs under
    ``space.whole()`` (GCA's guidance head, ``models/gca.py``)."""
    bands = space.current()
    if bands is None:
        return F.pad(x, (pad, pad, pad, pad), mode="reflect")
    lo, hi, _ = bands.span(x.shape[-2])
    x = bands.rows(x, lo - pad, hi + pad, fill="reflect")
    return F.pad(x, (pad, pad, 0, 0), mode="reflect")


def _channels_last_op(fn, x: torch.Tensor) -> torch.Tensor:
    """Apply an NCHW op ``fn`` to ``[..., H, W, C]``."""
    lead = x.shape[:-3]
    y = fn(x.reshape((-1,) + x.shape[-3:]).permute(0, 3, 1, 2))
    y = y.permute(0, 2, 3, 1)
    return y.reshape(lead + y.shape[1:])


def avg_pool(x: torch.Tensor, window: int, stride: int | None = None,
             padding: int = 0) -> torch.Tensor:
    """Average pool over H, W of ``[..., H, W, C]`` (``F.avg_pool2d``).

    Below f32 (the bf16 training recipe's loss targets) the window is
    summed in the input's dtype, one element after another in row-major
    order, then divided: the JAX package's ``reduce_window`` sum in bf16
    as XLA runs it (``F.avg_pool2d`` sums in f32 and rounds once, which
    moves 1 in 8 of the bf16 means of an 8x8 window)."""
    stride = stride or window
    if x.dtype.itemsize >= 4:
        return _channels_last_op(
            lambda t: F.avg_pool2d(t, window, stride, padding), x)
    if padding:
        x = F.pad(x, (0, 0, padding, padding, padding, padding))
    h = (x.shape[-3] - window) // stride + 1
    w = (x.shape[-2] - window) // stride + 1
    acc = None
    for dy in range(window):
        for dx in range(window):
            t = x[..., dy:dy + stride * (h - 1) + 1:stride,
                  dx:dx + stride * (w - 1) + 1:stride, :]
            acc = t if acc is None else acc + t
    return acc / (window * window)


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
