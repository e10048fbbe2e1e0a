"""FBA matting backbone (port of tcvom_tpu/models/fba.py), NCHW.

Dilated ResNet-50 with weight-standardized convs and GroupNorm(32), a
pyramid-pooling decoder and the closed-form FBA fusion (reference
models/FBA/). Input is 11 channels: normalized RGB(3) + Gaussian trimap
encoding(6) + binary bg/fg(2); output is 7 channels (alpha, F, B).
Module names are the reference's ``state_dict`` keys.
"""
from __future__ import annotations

import torch
import torch.nn as nn
import torch.nn.functional as F

from tcvom_tpu_torch.models.layers import (EncoderDecoder, GroupNorm32,
                                           WSConv2d, at_least_f32)
from tcvom_tpu_torch.ops.image import (adaptive_avg_pool, max_pool,
                                       resize_bilinear)


class Bottleneck(nn.Module):
    """ResNet-50 bottleneck with WS convs and GN32; a stride may be
    replaced by dilation (reference models.py:207-220)."""

    def __init__(self, inplanes: int, planes: int, stride: int = 1,
                 dilation: int = 1, downsample: bool = False):
        super().__init__()
        self.conv1 = WSConv2d(inplanes, planes, 1, bias=False)
        self.bn1 = GroupNorm32(planes)
        self.conv2 = WSConv2d(planes, planes, 3, stride=stride,
                              padding=dilation, dilation=dilation, bias=False)
        self.bn2 = GroupNorm32(planes)
        self.conv3 = WSConv2d(planes, planes * 4, 1, bias=False)
        self.bn3 = GroupNorm32(planes * 4)
        self.downsample = (nn.Sequential(
            WSConv2d(inplanes, planes * 4, 1, stride=stride, bias=False),
            GroupNorm32(planes * 4)) if downsample else None)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        out = F.relu(self.bn1(self.conv1(x)))
        out = F.relu(self.bn2(self.conv2(out)))
        out = self.bn3(self.conv3(out))
        identity = x if self.downsample is None else self.downsample(x)
        return F.relu(out + identity)


def _layer(inplanes: int, planes: int, blocks: int, stride: int,
           dilations: tuple[int, int]) -> nn.Sequential:
    mods = [Bottleneck(inplanes, planes, stride, dilations[0], True)]
    mods += [Bottleneck(planes * 4, planes, 1, dilations[1])
             for _ in range(1, blocks)]
    return nn.Sequential(*mods)


class FBAEncoder(nn.Module):
    """ResnetDilated(resnet50, dilate_scale=8) with an 11-channel stem
    (reference models.py:33-65, 183-236). Returns the conv_out pyramid."""

    def __init__(self, input_chn: int = 11, layers=(3, 4, 6, 3)):
        super().__init__()
        self.conv1 = WSConv2d(input_chn, 64, 7, stride=2, padding=3,
                              bias=False)
        self.bn1 = GroupNorm32(64)
        self.layer1 = _layer(64, 64, layers[0], 1, (1, 1))
        self.layer2 = _layer(256, 128, layers[1], 2, (1, 1))
        # layer3/4: stride -> 1; first-block 3x3 dilation 1/2, rest 2/4
        self.layer3 = _layer(512, 256, layers[2], 1, (1, 2))
        self.layer4 = _layer(1024, 512, layers[3], 1, (2, 4))

    def forward(self, x: torch.Tensor) -> dict:
        conv_out = [x]                                        # OS=1
        h = F.relu(self.bn1(self.conv1(x)))
        conv_out.append(h)                                    # OS=2
        h = max_pool(h, 3, 2, 1)
        for layer in (self.layer1, self.layer2, self.layer3, self.layer4):
            h = layer(h)
            conv_out.append(h)                                # OS=4, 8, 8, 8
        return {"conv_out": tuple(conv_out)}


def fba_fusion(alpha, img, F_, B):
    """Closed-form consistency solve (reference models.py:246-255), NCHW."""
    F_ = alpha * img + (1 - alpha ** 2) * F_ - alpha * (1 - alpha) * B
    B = (1 - alpha) * img + (2 * alpha - alpha ** 2) * B - alpha * (1 - alpha) * F_
    F_ = torch.clamp(F_, 0, 1)
    B = torch.clamp(B, 0, 1)
    la = 0.1
    alpha = (alpha * la + torch.sum((img - B) * (F_ - B), dim=1, keepdim=True)
             ) / (torch.sum((F_ - B) * (F_ - B), dim=1, keepdim=True) + la)
    return torch.clamp(alpha, 0, 1), F_, B


class _AdaptivePool(nn.Module):
    def __init__(self, size: int):
        super().__init__()
        self.size = size

    def forward(self, x):
        return adaptive_avg_pool(x, self.size)


def _conv_gn_lrelu(cin: int, cout: int) -> list[nn.Module]:
    return [WSConv2d(cin, cout, 3, padding=1), GroupNorm32(cout),
            nn.LeakyReLU(0.01)]


class FBADecoder(nn.Module):
    """fba_decoder (reference models.py:258-353). ``mode='extract'`` stops
    at OS=8 after conv_up1 (the per-frame half of VMN); ``mode='head'``
    continues from the FAM output ``x``; ``'full'`` runs both."""

    # the modules mode="extract" runs, frozen with the encoder under
    # FREEZE_BACKBONE (models/vmn.py::VMN.train)
    EXTRACT_MODULES = ("ppm", "conv_up1")

    def __init__(self, pool_scales=(1, 2, 3, 6)):
        super().__init__()
        self.ppm = nn.ModuleList(nn.Sequential(
            _AdaptivePool(s), WSConv2d(2048, 256, 1), GroupNorm32(256),
            nn.LeakyReLU(0.01)) for s in pool_scales)
        self.conv_up1 = nn.Sequential(
            *_conv_gn_lrelu(2048 + 256 * len(pool_scales), 256),
            *_conv_gn_lrelu(256, 256))
        self.conv_up2 = nn.Sequential(*_conv_gn_lrelu(256 + 256, 256))
        self.conv_up3 = nn.Sequential(*_conv_gn_lrelu(256 + 64, 64))
        self.conv_up4 = nn.Sequential(
            nn.Conv2d(64 + 3 + 3 + 2, 32, 3, padding=1), nn.LeakyReLU(0.01),
            nn.Conv2d(32, 16, 3, padding=1), nn.LeakyReLU(0.01),
            nn.Conv2d(16, 7, 1))

    @staticmethod
    def prune_enc_head(enc: dict) -> dict:
        """Drop what ``mode='head'`` never reads (the OS=8 pyramid and the
        8 encoding channels of the raw input), keeping the indexing."""
        co = enc["conv_out"]
        out = {"conv_out": (co[0][:, :3], co[1], co[2], None, None, None)}
        if "extras" in enc:
            out["extras"] = enc["extras"]
        return out

    def forward(self, enc: dict, mode: str = "full", x=None) -> torch.Tensor:
        conv_out = enc["conv_out"]
        img, two_chan_trimap = enc["extras"]
        if mode in ("full", "extract"):
            conv5 = conv_out[-1]
            size = conv5.shape[-2:]
            parts = [conv5] + [resize_bilinear(branch(conv5), size)
                               for branch in self.ppm]
            x = self.conv_up1(torch.cat(parts, dim=1))        # OS=8
            if mode == "extract":
                return x
        h = resize_bilinear(x, (x.shape[-2] * 2, x.shape[-1] * 2))
        h = self.conv_up2(torch.cat([h, conv_out[-4]], dim=1))        # OS=4
        h = resize_bilinear(h, (h.shape[-2] * 2, h.shape[-1] * 2))
        h = self.conv_up3(torch.cat([h, conv_out[-5]], dim=1))        # OS=2
        h = resize_bilinear(h, (h.shape[-2] * 2, h.shape[-1] * 2))
        h = torch.cat([h, conv_out[-6][:, :3], img, two_chan_trimap], dim=1)
        out = at_least_f32(self.conv_up4(h))                   # OS=1
        # the fusion solve runs in at least f32 whatever the network dtype
        alpha = torch.clamp(out[:, 0:1], 0, 1)
        F_ = torch.sigmoid(out[:, 1:4])
        B = torch.sigmoid(out[:, 4:7])
        alpha, F_, B = fba_fusion(alpha, at_least_f32(img), F_, B)
        return torch.cat([alpha, F_, B], dim=1)


class FBA(EncoderDecoder):
    """Single-frame FBA matting model (reference models.py:7-30): the
    encoder and the ``full`` decoder. ``forward(x, extras)``: ``x`` the
    11-channel input, ``extras`` (raw scaled image, 2-channel trimap), all
    NCHW; returns (alpha, F, B) ``[N, 7, H, W]``."""

    def __init__(self, layers=(3, 4, 6, 3)):
        super().__init__()
        self.encoder = FBAEncoder(layers=tuple(layers))
        self.decoder = FBADecoder()

    def forward(self, x: torch.Tensor, extras) -> torch.Tensor:
        return self.decoder(dict(self.encoder(x), extras=extras))
