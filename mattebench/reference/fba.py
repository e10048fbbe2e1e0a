"""FBA Matting with the temporal aggregation module (TCVOM's ``vmn_fba``),
eval path, in plain PyTorch over a state dict.

FBA (Forte and Pitie, arXiv:2003.07711): a dilated ResNet-50 (output
stride 8) with weight-standardized convolutions and GroupNorm(32) on an
11-channel input (normalized RGB, the 6-channel Gaussian trimap encoding,
the binary bg/fg maps), a pyramid-pooling decoder and the closed-form
F/B/alpha fusion. TCVOM (arXiv:2105.11427) splits the decoder after
``conv_up1`` (OS 8) and puts its FAM there, at 256 channels.

``spec`` gives the parameter table under the reference PyTorch code's
``state_dict`` names; ``prepare`` the input, with FBA's trimap encoding;
``encode`` and ``head`` compute with any
:class:`~mattebench.reference.common.Arith`.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from mattebench.reference.common import (Arith, conv, group_norm, nchw,
                                         preprocess, resize_bilinear)

POOL_SCALES = (1, 2, 3, 6)
TRIMAP_CHANNELS = 8
# (stride, first block's dilation, the others' dilation) of layer1..4:
# ResnetDilated at dilate_scale 8
STAGES = ((1, 1, 1), (2, 1, 1), (1, 1, 2), (1, 2, 4))


def spec(config: dict) -> dict[str, tuple[int, ...]]:
    """Every parameter's shape, by name."""
    out: dict[str, tuple[int, ...]] = {}
    c = config["fam_channels"]

    def ws(name, cout, cin, k, bias):
        out[name + ".weight"] = (cout, cin, k, k)
        if bias:
            out[name + ".bias"] = (cout,)

    def gn(name, ch):
        out[name + ".weight"] = (ch,)
        out[name + ".bias"] = (ch,)

    ws("encoder.conv1", 64, 3 + TRIMAP_CHANNELS, 7, False)
    gn("encoder.bn1", 64)
    cin = 64
    for i, blocks in enumerate(config["layers"], 1):
        planes = 64 * 2 ** (i - 1)
        for j in range(blocks):
            p = f"encoder.layer{i}.{j}."
            ws(p + "conv1", planes, cin, 1, False)
            gn(p + "bn1", planes)
            ws(p + "conv2", planes, planes, 3, False)
            gn(p + "bn2", planes)
            ws(p + "conv3", 4 * planes, planes, 1, False)
            gn(p + "bn3", 4 * planes)
            if j == 0:
                ws(p + "downsample.0", 4 * planes, cin, 1, False)
                gn(p + "downsample.1", 4 * planes)
            cin = 4 * planes
    for i in range(len(POOL_SCALES)):
        ws(f"decoder.ppm.{i}.1", 256, 2048, 1, True)
        gn(f"decoder.ppm.{i}.2", 256)
    ws("decoder.conv_up1.0", 256, 2048 + 256 * len(POOL_SCALES), 3, True)
    gn("decoder.conv_up1.1", 256)
    ws("decoder.conv_up1.3", 256, 256, 3, True)
    gn("decoder.conv_up1.4", 256)
    ws("decoder.conv_up2.0", 256, 512, 3, True)
    gn("decoder.conv_up2.1", 256)
    ws("decoder.conv_up3.0", 64, 256 + 64, 3, True)
    gn("decoder.conv_up3.1", 64)
    ws("decoder.conv_up4.0", 32, 64 + 3 + 3 + 2, 3, True)
    ws("decoder.conv_up4.2", 16, 32, 3, True)
    ws("decoder.conv_up4.4", 7, 16, 1, True)
    for n in ("key", "query", "value"):
        ws(f"decoder.fam.{n}_conv", c, c, 3, True)
    return out


def prepare(img_u8: torch.Tensor, tri_u8: torch.Tensor) -> dict:
    """The 11-channel input ``x`` (normalized RGB, the 6 Gaussian distance
    channels, the binary bg/fg maps), the ``extras`` the head reads (the
    RGB image in [0, 1], the binary bg/fg maps) and the unknown mask
    ``trimask``, NCHW f32, of uint8 frames and trimaps."""
    pre = preprocess(img_u8, tri_u8, TRIMAP_CHANNELS)
    return dict(x=nchw(torch.cat([pre["imgs"], pre["tris"]], dim=-1)),
                extras=(nchw(pre["scaled"]), nchw(pre["tris"][..., -2:])),
                trimask=nchw(pre["trimask"]))


def _standardize(w: torch.Tensor) -> torch.Tensor:
    """Weight standardization: per output channel, minus the mean, over
    the unbiased std (+1e-12 inside the root, +1e-5 outside)."""
    w = w.to(torch.promote_types(w.dtype, torch.float32))
    w = w - w.mean(dim=(1, 2, 3), keepdim=True)
    var = w.reshape(w.shape[0], -1).var(dim=1, unbiased=True)
    return w / (torch.sqrt(var + 1e-12) + 1e-5)[:, None, None, None]


def _ws(ar, sd, name, x, stride=1, padding=0, dilation=1):
    return conv(ar, x, _standardize(sd[name + ".weight"]),
                sd.get(name + ".bias"), stride, padding, dilation)


def _gn(ar, sd, name, x, residual=None):
    return group_norm(ar, x, sd[name + ".weight"], sd[name + ".bias"],
                      residual=residual)


def _bottleneck(ar, sd, p, x, stride, dilation):
    out = F.relu(_gn(ar, sd, p + "bn1", _ws(ar, sd, p + "conv1", x)))
    out = F.relu(_gn(ar, sd, p + "bn2", _ws(ar, sd, p + "conv2", out, stride,
                                            dilation, dilation)))
    if p + "downsample.0.weight" in sd:
        x = _gn(ar, sd, p + "downsample.1",
                _ws(ar, sd, p + "downsample.0", x, stride))
    return F.relu(_gn(ar, sd, p + "bn3", _ws(ar, sd, p + "conv3", out), x))


def _conv_gn_lrelu(ar, sd, name, gn_name, x):
    return F.leaky_relu(_gn(ar, sd, gn_name, _ws(ar, sd, name, x, padding=1)),
                        0.01)


def encode(ar: Arith, sd: dict, x: torch.Tensor, extras) -> tuple[dict, torch.Tensor]:
    """The per-frame half: the encoder and the decoder up to ``conv_up1``.
    ``x``: the 11-channel input; ``extras``: (the RGB image in [0, 1], the
    binary bg/fg maps), NCHW. Returns (what the head reads, the OS-8
    features)."""
    x = x.to(ar.dtype)
    h = F.relu(_gn(ar, sd, "encoder.bn1",
                   _ws(ar, sd, "encoder.conv1", x, 2, 3)))
    os2 = h
    h = F.max_pool2d(h, 3, 2, 1)
    for i, (stride, first, rest) in enumerate(STAGES, 1):
        j = 0
        while f"encoder.layer{i}.{j}.conv1.weight" in sd:
            h = _bottleneck(ar, sd, f"encoder.layer{i}.{j}.", h,
                            stride if j == 0 else 1, first if j == 0 else rest)
            j += 1
        if i == 1:
            os4 = h
    pyramid = [h]
    for i, s in enumerate(POOL_SCALES):
        p = f"decoder.ppm.{i}."
        y = F.adaptive_avg_pool2d(h, s)
        y = F.leaky_relu(_gn(ar, sd, p + "2", _ws(ar, sd, p + "1", y)), 0.01)
        pyramid.append(resize_bilinear(y, h.shape[-2:]))
    y = torch.cat(pyramid, dim=1)
    y = _conv_gn_lrelu(ar, sd, "decoder.conv_up1.0", "decoder.conv_up1.1", y)
    y = _conv_gn_lrelu(ar, sd, "decoder.conv_up1.3", "decoder.conv_up1.4", y)
    enc = {"rgb_norm": x[:, :3], "os2": os2, "os4": os4,
           "extras": tuple(t.to(ar.dtype) for t in extras)}
    return enc, y


def fusion(alpha, img, fg, bg):
    """The closed-form consistency solve (la = 0.1)."""
    fg = alpha * img + (1 - alpha ** 2) * fg - alpha * (1 - alpha) * bg
    bg = (1 - alpha) * img + (2 * alpha - alpha ** 2) * bg - alpha * (1 - alpha) * fg
    fg = torch.clamp(fg, 0, 1)
    bg = torch.clamp(bg, 0, 1)
    la = 0.1
    alpha = (alpha * la + torch.sum((img - bg) * (fg - bg), dim=1, keepdim=True)
             ) / (torch.sum((fg - bg) * (fg - bg), dim=1, keepdim=True) + la)
    return torch.clamp(alpha, 0, 1)


def head(ar: Arith, sd: dict, enc: dict, x: torch.Tensor) -> torch.Tensor:
    """The per-matte half from the FAM output ``x``: alpha ``[N, 1, H, W]``
    in at least f32."""
    img, two_chan = enc["extras"]

    def up(t):
        return resize_bilinear(t, (2 * t.shape[-2], 2 * t.shape[-1]))

    x = x.to(ar.dtype)
    h = _conv_gn_lrelu(ar, sd, "decoder.conv_up2.0", "decoder.conv_up2.1",
                       torch.cat([up(x), enc["os4"]], dim=1))
    h = _conv_gn_lrelu(ar, sd, "decoder.conv_up3.0", "decoder.conv_up3.1",
                       torch.cat([up(h), enc["os2"]], dim=1))
    h = torch.cat([up(h), enc["rgb_norm"], img, two_chan], dim=1)
    p = "decoder.conv_up4."
    h = F.leaky_relu(conv(ar, h, sd[p + "0.weight"], sd[p + "0.bias"],
                          padding=1), 0.01)
    h = F.leaky_relu(conv(ar, h, sd[p + "2.weight"], sd[p + "2.bias"],
                          padding=1), 0.01)
    out = conv(ar, h, sd[p + "4.weight"], sd[p + "4.bias"]).to(ar.wide)
    alpha = torch.clamp(out[:, 0:1], 0, 1)
    return fusion(alpha, img.to(ar.wide), torch.sigmoid(out[:, 1:4]),
                  torch.sigmoid(out[:, 4:7]))
