"""Deep Image Matting with the temporal aggregation module (TCVOM's
``vmn_dim``), eval path, in plain PyTorch over a state dict.

DIM (Xu et al., arXiv:1703.03872): a VGG16 encoder, BatchNorm after each of
its 13 3x3 convolutions, on 4 input channels (the normalized RGB image and
the trimap scaled to [0, 1]); five 2x2 max pools that keep where each max
was; ``conv6`` 7x7 512 -> 4096 at OS 32; a decoder that max-unpools with
those positions at every level, each unpool followed by a 5x5 convolution
and a ReLU (``dconv6`` is 1x1, before the first unpool), ``alpha_pred``
5x5 and a clip to [0, 1]. TCVOM (arXiv:2105.11427) splits the decoder after
``dconv4`` (OS 8, 256 channels) and puts its FAM there.

The pools are ``F.max_pool2d(..., return_indices=True)`` and the unpools
``F.max_unpool2d`` with torch's flat int64 index: written apart from the
program's in-window uint8 index and its kernels.
"""
from __future__ import annotations

import contextlib

import torch
import torch.nn.functional as F

from mattebench.reference.common import (IMG_MEAN, IMG_SCALE, IMG_STD, Arith,
                                         batch_norm, conv, nchw)

# (convs, channels) of the encoder's five stages
STAGES = ((2, 64), (2, 128), (3, 256), (3, 512), (3, 512))
# (name, in, out) of the 5x5 convs after each unpool, deepest first: the
# first two in the per-frame half, the last three in the head
UP = (("dconv5", 512, 512), ("dconv4", 512, 256), ("dconv3", 256, 128),
      ("dconv2", 128, 64), ("dconv1", 64, 64))


def spec(config: dict) -> dict[str, tuple[int, ...]]:
    """Every parameter and buffer's shape, by name (``num_batches_tracked``
    is ``()``)."""
    out: dict[str, tuple[int, ...]] = {}

    def conv_(name, cout, cin, k):
        out[name + ".weight"] = (cout, cin, k, k)
        out[name + ".bias"] = (cout,)

    cin = 4
    for s, (n, feat) in enumerate(STAGES, 1):
        for j in range(1, n + 1):
            conv_(f"encoder.conv{s}{j}", feat, cin, 3)
            for p in ("weight", "bias", "running_mean", "running_var"):
                out[f"encoder.bn{s}{j}.{p}"] = (feat,)
            out[f"encoder.bn{s}{j}.num_batches_tracked"] = ()
            cin = feat
    conv_("encoder.conv6", 4096, 512, 7)
    conv_("decoder.dconv6", 512, 4096, 1)
    for name, c_in, c_out in UP:
        conv_("decoder." + name, c_out, c_in, 5)
    conv_("decoder.alpha_pred", 1, 64, 5)
    c = config["fam_channels"]
    for n in ("key", "query", "value"):
        conv_(f"decoder.fam.{n}_conv", c, c, 3)
    return out


def prepare(img_u8: torch.Tensor, tri_u8: torch.Tensor) -> dict:
    """The 4-channel input ``x`` (normalized RGB, the trimap scaled to [0,
    1]) and the unknown mask ``trimask`` (0 < trimap < 255), NCHW f32, of
    uint8 frames ``[N, H, W, 3]`` (BGR) and trimaps ``[N, H, W, 1]``; no
    ``extras``."""
    scale = torch.tensor(IMG_SCALE, dtype=torch.float32)
    scaled = img_u8.float().flip(-1) * scale
    mean = torch.tensor(IMG_MEAN, device=img_u8.device)
    std = torch.tensor(IMG_STD, device=img_u8.device)
    s = tri_u8.float() * scale
    return dict(x=nchw(torch.cat([(scaled - mean) / std, s], dim=-1)),
                extras=None, trimask=nchw(((s > 0) & (s < 1)).float()))


_POOLS: list = [None]


@contextlib.contextmanager
def recording_pools():
    """Inside, each pool and unpool appends to the list this yields its
    larger side's elements (the pool's input, the unpool's output) and
    bytes an element."""
    _POOLS[0] = []
    try:
        yield _POOLS[0]
    finally:
        _POOLS[0] = None


def _record(big: torch.Tensor) -> None:
    if _POOLS[0] is not None:
        _POOLS[0].append((big.numel(), big.element_size()))


def _pool(x):
    _record(x)
    return F.max_pool2d(x, 2, 2, return_indices=True)


def _unpool(x, idx):
    out = F.max_unpool2d(x, idx, 2, 2,
                         output_size=(2 * x.shape[-2], 2 * x.shape[-1]))
    _record(out)
    return out


def _conv(ar, sd, name, x, padding):
    return conv(ar, x, sd[name + ".weight"], sd[name + ".bias"],
                padding=padding)


def _up(ar, sd, name, x, idx):
    return F.relu(_conv(ar, sd, "decoder." + name, _unpool(x, idx), 2))


def encode(ar: Arith, sd: dict, x: torch.Tensor, extras=None
           ) -> tuple[dict, torch.Tensor]:
    """The per-frame half: the encoder, ``conv6``, ``dconv6`` and the first
    two unpools with their convs. ``x``: the 4-channel input, NCHW.
    Returns (the indices of the first three pools, which the head reads;
    the OS-8 features)."""
    x = x.to(ar.dtype)
    indices = []
    for s, (n, _) in enumerate(STAGES, 1):
        for j in range(1, n + 1):
            x = F.relu(batch_norm(ar, _conv(ar, sd, f"encoder.conv{s}{j}",
                                            x, 1), sd, f"encoder.bn{s}{j}"))
        x, idx = _pool(x)
        indices.append(idx)
    x = F.relu(_conv(ar, sd, "encoder.conv6", x, 3))
    x = F.relu(_conv(ar, sd, "decoder.dconv6", x, 0))
    for (name, _, _), idx in zip(UP[:2], indices[:2:-1]):
        x = _up(ar, sd, name, x, idx)
    return {"indices": tuple(indices[:3])}, x


def head(ar: Arith, sd: dict, enc: dict, x: torch.Tensor) -> torch.Tensor:
    """The per-matte half from the FAM output ``x``: alpha ``[N, 1, H, W]``
    in at least f32, clipped to [0, 1]."""
    x = x.to(ar.dtype)
    for (name, _, _), idx in zip(UP[2:], enc["indices"][::-1]):
        x = _up(ar, sd, name, x, idx)
    out = _conv(ar, sd, "decoder.alpha_pred", x, 2)
    return torch.clamp(out, 0.0, 1.0).to(ar.wide)
