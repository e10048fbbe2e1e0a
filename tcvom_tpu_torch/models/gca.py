"""GCA backbone (Guided Contextual Attention matting; port of
tcvom_tpu/models/gca.py), NCHW.

A ResNet-D encoder of layers (3, 4, 4, 2) with spectral-norm convs
(:class:`~tcvom_tpu_torch.models.layers.SNConv2d`), five shortcut heads, a
guidance head on the RGB input and guided contextual attention at OS 8,
and a decoder of layers (2, 3, 3, 2) with a second attention at OS 8
(reference models/GCA/encoders/res_gca_enc.py, decoders/res_gca_dec.py).
Input is 6 channels: normalized RGB and the 3-channel one-hot trimap;
output is alpha. Module names are the reference's ``state_dict`` keys,
under ``encoder.`` and ``decoder.`` in both the single-frame model and the
VMN.

The JAX package's TPU-only ``fast`` branches (the block-packed shortcut,
stem and tail, ``tcvom_tpu/models/gca.py:122-133``, ``:156-170``,
``:253-264``) are not ported: this is the branch it runs elsewhere.
"""
from __future__ import annotations

import torch
import torch.nn as nn
import torch.nn.functional as F

from tcvom_tpu_torch.models.layers import BatchNorm, EncoderDecoder, SNConv2d
from tcvom_tpu_torch.ops.gca_attention import guided_attention_core
from tcvom_tpu_torch.ops.image import reflection_pad, resize_nearest

def _leaky(x: torch.Tensor) -> torch.Tensor:
    return F.leaky_relu(x, 0.2)


class _ReflectionPad1(nn.Module):
    """Reflection padding by 1: slots 0, 4 and 8 of the guidance head."""

    def forward(self, x):
        return reflection_pad(x, 1)


class GuidedCxtAtten(nn.Module):
    """Guidance 1x1 conv -> attention core -> ``W`` (1x1 conv, BatchNorm)
    -> residual (reference ops.py:83-229). The core's f32 output is cast to
    the features' dtype before ``W``."""

    def __init__(self, out_channels: int = 128, guidance_channels: int = 128):
        super().__init__()
        self.guidance_conv = nn.Conv2d(guidance_channels,
                                       guidance_channels // 2, 1)
        self.W = nn.Sequential(
            nn.Conv2d(out_channels, out_channels, 1, bias=False),
            BatchNorm(out_channels))

    def forward(self, f, alpha, unknown):
        f = self.guidance_conv(f)
        hw = (f.shape[-2] // 2, f.shape[-1] // 2)
        y = guided_attention_core(resize_nearest(f, hw), alpha,
                                  resize_nearest(unknown, hw))
        return self.W(y.to(alpha.dtype)) + alpha


class EncBasicBlock(nn.Module):
    """Encoder residual block; a stride-2 block's ``downsample`` is
    (AvgPool 2, SN 1x1 conv, BatchNorm) (reference resnet_enc.py:17-49).
    At GCA's widths only the stride-2 blocks change width."""

    def __init__(self, inplanes: int, planes: int, stride: int = 1):
        super().__init__()
        self.conv1 = SNConv2d(inplanes, planes, 3, stride, 1)
        self.bn1 = BatchNorm(planes)
        self.conv2 = SNConv2d(planes, planes, 3, 1, 1)
        self.bn2 = BatchNorm(planes)
        self.downsample = nn.Sequential(
            nn.AvgPool2d(2, stride), SNConv2d(inplanes, planes, 1),
            BatchNorm(planes)) if stride != 1 else None

    def forward(self, x):
        out = F.relu(self.bn1(self.conv1(x)))
        out = self.bn2(self.conv2(out))
        identity = x if self.downsample is None else self.downsample(x)
        return F.relu(out + identity)


class DecBasicBlock(nn.Module):
    """Decoder residual block, leaky ReLU 0.2: a stride-2 block's ``conv1``
    is the SN transposed conv (4, 2, 1) and its ``upsample`` is (nearest
    2x, SN 1x1 conv, BatchNorm) (reference decoders/resnet_dec.py)."""

    def __init__(self, inplanes: int, planes: int, stride: int = 1):
        super().__init__()
        if stride > 1:
            self.conv1 = SNConv2d(inplanes, inplanes, 4, 2, 1, transpose=True)
        else:
            self.conv1 = SNConv2d(inplanes, inplanes, 3, 1, 1)
        self.bn1 = BatchNorm(inplanes)
        self.conv2 = SNConv2d(inplanes, planes, 3, 1, 1)
        self.bn2 = BatchNorm(planes)
        self.upsample = nn.Sequential(
            nn.Upsample(scale_factor=2, mode="nearest"),
            SNConv2d(inplanes, planes, 1), BatchNorm(planes)
        ) if stride != 1 else None

    def forward(self, x):
        out = _leaky(self.bn1(self.conv1(x)))
        out = self.bn2(self.conv2(out))
        identity = x if self.upsample is None else self.upsample(x)
        return _leaky(out + identity)


def _shortcut(inplanes: int, planes: int) -> nn.Sequential:
    """(SN 3x3 conv, ReLU, BatchNorm) twice (reference res_gca_enc.py:47-55):
    keys ``.0``, ``.2``, ``.3``, ``.5``."""
    return nn.Sequential(
        SNConv2d(inplanes, planes, 3, 1, 1), nn.ReLU(), BatchNorm(planes),
        SNConv2d(planes, planes, 3, 1, 1), nn.ReLU(), BatchNorm(planes))


def _make_layer(block, inplanes: int, planes: int, blocks: int,
                stride: int) -> nn.Sequential:
    return nn.Sequential(block(inplanes, planes, stride),
                         *(block(planes, planes) for _ in range(1, blocks)))


class GCAEncoder(nn.Module):
    """resnet_gca_encoder_29. ``forward(x)``: ``x`` ``[N, 6, H, W]``, H and
    W multiples of 32; returns {"bottleneck" (OS 32, 512), "shortcut"
    (five heads, OS 1 to 16), "image_fea" (the guidance head's OS 8, 128),
    "unknown" (the trimap's unknown channel at OS 8)}."""

    def __init__(self, layers=(3, 4, 4, 2), input_chn: int = 6):
        super().__init__()
        self.conv1 = SNConv2d(input_chn, 32, 3, 2, 1)
        self.bn1 = BatchNorm(32)
        self.conv2 = SNConv2d(32, 32, 3, 1, 1)
        self.bn2 = BatchNorm(32)
        self.conv3 = SNConv2d(32, 64, 3, 2, 1)
        self.bn3 = BatchNorm(64)
        # reflect pad, SN conv stride 2, ReLU, BatchNorm; three times
        head, cin = [], 3
        for feat in (16, 32, 128):
            head += [_ReflectionPad1(), SNConv2d(cin, feat, 3, 2, 0),
                     nn.ReLU(), BatchNorm(feat)]
            cin = feat
        self.guidance_head = nn.Sequential(*head)
        self.layer1 = _make_layer(EncBasicBlock, 64, 64, layers[0], 1)
        self.layer2 = _make_layer(EncBasicBlock, 64, 128, layers[1], 2)
        self.layer3 = _make_layer(EncBasicBlock, 128, 256, layers[2], 2)
        self.layer_bottleneck = _make_layer(EncBasicBlock, 256, 512,
                                            layers[3], 2)
        self.shortcut = nn.ModuleList(
            [_shortcut(cin, planes) for cin, planes in
             ((input_chn, 32), (32, 32), (64, 64), (128, 128), (256, 256))])
        self.gca = GuidedCxtAtten(128, 128)

    def forward(self, x: torch.Tensor) -> dict:
        out = F.relu(self.bn1(self.conv1(x)))
        x1 = F.relu(self.bn2(self.conv2(out)))                   # H/2, 32
        out = F.relu(self.bn3(self.conv3(x1)))                   # H/4, 64
        im_fea = self.guidance_head(x[:, :3])                    # H/8, 128
        unknown = resize_nearest(x[:, 4:5], (x.shape[-2] // 8,
                                             x.shape[-1] // 8))
        x2 = self.layer1(out)                                    # H/4, 64
        x3 = self.gca(im_fea, self.layer2(x2), unknown)          # H/8, 128
        x4 = self.layer3(x3)                                     # H/16, 256
        bottleneck = self.layer_bottleneck(x4)                   # H/32, 512
        feas = tuple(sc(t) for sc, t in zip(self.shortcut,
                                            (x, x1, x2, x3, x4)))
        return {"bottleneck": bottleneck, "shortcut": feas,
                "image_fea": im_fea, "unknown": unknown}


class GCADecoder(nn.Module):
    """res_gca_decoder_22 (the JAX package's GCADecoder and GCADecoderVMN,
    one class). ``mode='extract'`` runs layer1 and layer2 with the fused
    shortcuts 5 and 4 and the attention: 128 channels at OS 8 (the
    per-frame half of the VMN); ``mode='head'`` continues from the FAM
    output ``x``: layer3, layer4 with shortcuts 3 and 2, the SN transposed
    ``conv1``, ``bn1``, shortcut 1, ``conv2`` and ``(tanh + 1) / 2``;
    ``'full'`` runs both."""

    # the modules mode="extract" runs, frozen with the encoder under
    # FREEZE_BACKBONE (models/vmn.py::VMN.train)
    EXTRACT_MODULES = ("layer1", "layer2", "gca")

    def __init__(self, layers=(2, 3, 3, 2)):
        super().__init__()
        self.layer1 = _make_layer(DecBasicBlock, 512, 256, layers[0], 2)
        self.layer2 = _make_layer(DecBasicBlock, 256, 128, layers[1], 2)
        self.layer3 = _make_layer(DecBasicBlock, 128, 64, layers[2], 2)
        self.layer4 = _make_layer(DecBasicBlock, 64, 32, layers[3], 2)
        self.conv1 = SNConv2d(32, 32, 4, 2, 1, transpose=True)
        self.bn1 = BatchNorm(32)
        self.conv2 = nn.Conv2d(32, 1, 3, padding=1)
        self.gca = GuidedCxtAtten(128, 128)

    @staticmethod
    def prune_enc_head(enc: dict) -> dict:
        """Keep what ``mode='head'`` reads: shortcuts 1-3."""
        f1, f2, f3, _, _ = enc["shortcut"]
        return {"shortcut": (f1, f2, f3, None, None)}

    def forward(self, enc: dict, mode: str = "full", x=None) -> torch.Tensor:
        fea1, fea2, fea3, fea4, fea5 = enc["shortcut"]
        if mode in ("full", "extract"):
            h = self.layer1(enc["bottleneck"]) + fea5
            h = self.layer2(h) + fea4
            x = self.gca(enc["image_fea"], h, enc["unknown"])
            if mode == "extract":
                return x
        h = self.layer3(x) + fea3
        h = self.layer4(h) + fea2
        h = _leaky(self.bn1(self.conv1(h))) + fea1
        return (torch.tanh(self.conv2(h)) + 1.0) / 2.0


class GCA(EncoderDecoder):
    """Single-frame GCA generator (reference generators.py:35-37).
    ``forward(x)``: ``x`` ``[N, 6, H, W]``; alpha ``[N, 1, H, W]``."""

    def __init__(self):
        super().__init__()
        self.encoder = GCAEncoder()
        self.decoder = GCADecoder()

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.decoder(self.encoder(x))
