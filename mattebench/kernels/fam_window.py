"""fam_window: the FAM window attention (inference, no logits), one call a
decoded frame with both neighbours' keys."""
from __future__ import annotations

import functools

import torch

from mattebench import counts
from mattebench.reference import common


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


def per_pool(program) -> list[tuple[float, float]]:
    """Bytes and operations of the FAM call that decodes each pool frame
    (both neighbours' rows, every stream)."""
    config = program.config
    return pool_counts(program.traffic, config["fam_channels"],
                       config["agg_window"])


@functools.lru_cache(maxsize=4)
def pool_counts(tp, channels: int, window: int) -> list[tuple[float, float]]:
    """:func:`per_pool` of the traffic ``tp``, counted once a run."""
    itemsize = torch.empty((), dtype=tp.dtype).element_size()
    out = []
    for p in range(tp.pool_frames):
        mask = fam_mask(tp.batch(p)[1], (tp.height // 8, tp.width // 8))
        out.append(fam_counts(torch.cat([mask, mask]), channels, window,
                              itemsize))
    return out


def work(program, encodes: int, frames_decoded: list) -> list[float]:
    tp = program.traffic
    pools = per_pool(program)
    fam = [pools[tp.pool_index(f)] for f in frames_decoded]
    return [sum(b for b, _ in fam), sum(o for _, o in fam),
            counts.PEAK_FLOPS[program.params["dtype"]]]


def flop_per_matte(program) -> float:
    """The attention's operations a matte, over the pool's masks (the
    reference computes them elementwise, which the FLOP counter skips)."""
    tp = program.traffic
    fam = sum(o for _, o in per_pool(program)) / tp.pool_frames
    return fam / tp.streams
