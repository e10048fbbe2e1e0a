"""Euclidean distance transform and FBA trimap encoding on the device
(port of tcvom_tpu/ops/distance.py).

1. column pass: exact 1D distance by log-doubling min-plus shifts;
2. row pass: the squared-EDT lower envelope
   ``D^2[i,j] = min_{|d| <= T} (g[i,j+d]^2 + d^2)``, the kernel of
   :mod:`tcvom_tpu_torch.ops.edt_kernel`.

The row pass always searches exactly +-T columns (the Pallas kernel's
semantics). The JAX package's XLA route searches a slightly wider chunked
window instead; the two differ only where the nearest seed is T+1..2T-1
columns away, i.e. beyond the radius the consumer keeps.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from tcvom_tpu_torch.ops import edt_kernel

_BIG = 1.0e7  # "infinity" that stays finite when squared in float32


def _dist1d_along_axis(seed: torch.Tensor, axis: int,
                       truncate: int | None = None) -> torch.Tensor:
    """Exact 1D distance (in pixels) to the nearest True along ``axis``;
    with ``truncate``, exact up to ``truncate`` and >= it beyond."""
    n = seed.shape[axis]
    d = torch.where(seed, 0.0, _BIG).to(torch.float32)
    limit = n if truncate is None else min(n, truncate)
    d = d.movedim(axis, -1)

    def relax(d, shift):
        fwd = F.pad(d[..., :n - shift], (shift, 0), value=_BIG)
        bwd = F.pad(d[..., shift:], (0, shift), value=_BIG)
        return torch.minimum(d, torch.minimum(fwd, bwd) + shift)

    # a relax of shift s after coverage c reaches c + s while s <= c + 1
    covered = 0
    while covered < limit:
        s = min(covered + 1, limit - covered, n - 1)
        if s <= 0:
            break
        d = relax(d, s)
        covered += s
    return d.movedim(-1, axis)


def edt_squared(seed: torch.Tensor, truncate: int | None = None
                ) -> torch.Tensor:
    """Squared Euclidean distance to the nearest True pixel.

    ``seed``: bool ``[..., H, W]``. Returns f32 of the same shape; pixels
    with no seed in reach get a huge finite value. ``truncate``: the row
    pass searches only +-truncate columns (exact wherever the true distance
    is <= truncate, >= truncate^2 elsewhere)."""
    g = _dist1d_along_axis(seed, axis=seed.dim() - 2, truncate=truncate)
    g2 = torch.clamp_max(g * g, _BIG)
    w = seed.shape[-1]
    # offsets past the row's far end only meet the 1e7 padding, which never
    # wins against the row's own d = 0 candidate, so T caps at W - 1
    t = w - 1 if truncate is None else min(truncate, w - 1)
    out = edt_kernel.edt_row_pass(g2.reshape(-1, w).contiguous(), t)
    return out.reshape(g2.shape)


def trimap_transform(trimap2: torch.Tensor, length: float = 320.0
                     ) -> torch.Tensor:
    """FBA 6-channel Gaussian distance encoding.

    ``trimap2``: ``[..., H, W, 2]`` binary (bg, fg) maps. Returns
    ``[..., H, W, 6]``: ``exp(-d2 / (2 (s L)^2))`` for s in (0.02, 0.08,
    0.16) per input channel. Distances are truncated at 256 px, where the
    widest Gaussian has underflowed (~7e-7)."""
    seeds = (trimap2 >= 0.5).movedim(-1, 0)              # [2, ..., H, W]
    d2 = edt_squared(seeds, truncate=256)
    outs = []
    for k in range(2):
        for s in (0.02, 0.08, 0.16):
            sigma2 = 2.0 * (s * length) ** 2
            outs.append(torch.exp(-d2[k] / sigma2))
    return torch.stack(outs, dim=-1)
