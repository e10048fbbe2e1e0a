"""IndexNet matting backbone (MobileNetV2 and learned index pooling; port of
tcvom_tpu/models/index.py), NCHW.

Every encoder conv has stride 1; the encoder downsamples through learned
index maps, ``x <- idx_en * x`` then ``4 * avg_pool2d(x, 2, 2)``, and the
decoder upsamples with ``idx_de * nearest_resize`` (reference
models/Index/net.py, hlindex.py, hlaspp.py, hlconv.py). Module names are
the reference's ``state_dict`` keys.
"""
from __future__ import annotations

import torch
import torch.nn as nn
import torch.nn.functional as F

from tcvom_tpu_torch.models.layers import (BatchNorm, Dropout, EncoderDecoder,
                                           conv_bn_relu6)
from tcvom_tpu_torch.ops.image import pixel_shuffle, resize_nearest

# (expand ratio, out channels, blocks) of layer1..layer7
_LAYER_CFG = ((1, 16, 1), (6, 24, 2), (6, 32, 3), (6, 64, 4), (6, 96, 3),
              (6, 160, 3), (6, 320, 1))


class InvertedResidual(nn.Module):
    """MobileNetV2 inverted residual at stride 1 and dilation 1 (reference
    net.py:25-83, as the encoder builds it); the depthwise conv pads 1 on
    each side."""

    def __init__(self, inp: int, oup: int, expand_ratio: int):
        super().__init__()
        hidden = round(inp * expand_ratio)
        layers = [] if expand_ratio == 1 else [
            nn.Conv2d(inp, hidden, 1, bias=False), BatchNorm(hidden),
            nn.ReLU6()]
        layers += [nn.Conv2d(hidden, hidden, 3, padding=1, groups=hidden,
                             bias=False),
                   BatchNorm(hidden), nn.ReLU6(),
                   nn.Conv2d(hidden, oup, 1, bias=False), BatchNorm(oup)]
        self.conv = nn.Sequential(*layers)
        self.use_res = inp == oup

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        h = self.conv(x)
        return x + h if self.use_res else h


class DepthwiseM2OIndexBlock(nn.Module):
    """Four 4x4 stride-2 conv heads (groups 1) -> sigmoid, softmax over the
    four -> channel ``c*4 + k`` -> pixel shuffle 2 (reference
    hlindex.py:120-167, nonlinear with context). Returns (idx_en, idx_de),
    ``[N, C, H, W]`` at the input's resolution."""

    def __init__(self, inp: int):
        super().__init__()
        for i in range(1, 5):
            self.add_module(f"indexnet{i}", nn.Sequential(
                nn.Conv2d(inp, inp, 4, 2, 1, bias=False), BatchNorm(inp),
                nn.ReLU6(), nn.Conv2d(inp, inp, 1, bias=False)))

    def forward(self, x: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
        y = torch.sigmoid(torch.stack(
            [getattr(self, f"indexnet{i}")(x) for i in range(1, 5)], dim=2))
        n, c, _, h, w = y.shape
        z = torch.softmax(y, dim=2)
        return (pixel_shuffle(z.reshape(n, c * 4, h, w), 2),
                pixel_shuffle(y.reshape(n, c * 4, h, w), 2))


class _ASPPBranch(nn.Module):
    def __init__(self, *mods: nn.Module):
        super().__init__()
        self.atrous_conv = nn.Sequential(*mods)

    def forward(self, x):
        return self.atrous_conv(x)


class ASPP(nn.Module):
    """ASPP at OS 32 (reference hlaspp.py:87-135): a 1x1 branch, three
    depthwise-separable branches at dilations 2, 4 and 8, and a global
    average branch broadcast back; Dropout(0.5), a no-op in eval. In
    training the pooled branch's BatchNorm sees one value a channel per
    frame, so a train step needs more than one frame (the trainer checks).
    The dropout draws from the trainer's generator (``layers.Dropout``)."""

    def __init__(self, inp: int = 320, oup: int = 160):
        super().__init__()
        self.aspp1 = _ASPPBranch(*conv_bn_relu6(inp, 256, 1))
        for i, d in ((2, 2), (3, 4), (4, 8)):
            self.add_module(f"aspp{i}", _ASPPBranch(
                nn.Conv2d(inp, inp, 3, padding=d, dilation=d, groups=inp,
                          bias=False), BatchNorm(inp), nn.ReLU6(),
                *conv_bn_relu6(inp, 256, 1)))
        self.global_avg_pool = nn.Sequential(nn.AdaptiveAvgPool2d(1),
                                             *conv_bn_relu6(inp, 256, 1))
        self.bottleneck_conv = conv_bn_relu6(5 * 256, oup, 1)
        self.dropout = Dropout(0.5)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        branches = [self.aspp1(x), self.aspp2(x), self.aspp3(x),
                    self.aspp4(x)]
        g = self.global_avg_pool(x)
        branches.append(g.expand(-1, -1, x.shape[-2], x.shape[-1]))
        return self.dropout(self.bottleneck_conv(torch.cat(branches, dim=1)))


class IndexMattingEncoder(nn.Module):
    """Returns the 13 features of reference net.py:196-233 as a dict."""

    def __init__(self, input_chn: int = 4):
        super().__init__()
        self.layer0 = conv_bn_relu6(input_chn, 32, 3)
        inp = 32
        for li, (t, out, n) in enumerate(_LAYER_CFG, start=1):
            self.add_module(f"layer{li}", nn.Sequential(*(
                InvertedResidual(inp if i == 0 else out, out, t)
                for i in range(n))))
            inp = out
        for li, c in ((0, 32), (2, 24), (3, 32), (4, 64), (6, 160)):
            self.add_module(f"index{li}", DepthwiseM2OIndexBlock(c))
        self.dconv_pp = ASPP(320, 160)

    def _index_pool(self, h, li: int):
        # the skip feature is re-bound to idx_en * h before pooling
        # (reference net.py:199-224): the decoder reads the weighted map
        idx_en, idx_de = getattr(self, f"index{li}")(h)
        h = idx_en * h
        return 4.0 * F.avg_pool2d(h, 2, 2), h, idx_de

    def forward(self, x: torch.Tensor) -> dict:
        l0p, l0, idx0_de = self._index_pool(self.layer0(x), 0)
        l1 = self.layer1(l0p)
        l2p, l2, idx2_de = self._index_pool(self.layer2(l1), 2)
        l3p, l3, idx3_de = self._index_pool(self.layer3(l2p), 3)
        l4p, l4, idx4_de = self._index_pool(self.layer4(l3p), 4)
        l5 = self.layer5(l4p)
        l6p, l6, idx6_de = self._index_pool(self.layer6(l5), 6)
        return {"l": self.dconv_pp(self.layer7(l6p)), "l6": l6,
                "idx6_de": idx6_de, "l5": l5, "l4": l4, "idx4_de": idx4_de,
                "l3": l3, "idx3_de": idx3_de, "l2": l2, "idx2_de": idx2_de,
                "l1": l1, "l0": l0, "idx0_de": idx0_de}


class IndexedUpsampling(nn.Module):
    """idx_de-weighted nearest upsample, concatenated with the skip, then a
    5x5 conv_bn (reference hldecoder.py:115-133)."""

    def __init__(self, cin: int, oup: int):
        super().__init__()
        self.dconv = conv_bn_relu6(cin, oup, 5)

    def forward(self, l_encode, l_low, indices=None):
        if indices is not None:
            l_encode = indices * resize_nearest(l_encode, l_low.shape[-2:])
        return self.dconv(torch.cat([l_encode, l_low], dim=1))


# (name, in = upsampled + skip, out, skip, index map) of the decoder layers
_DECODER = (("decoder_layer6", 160 + 160, 96, "l6", "idx6_de"),
            ("decoder_layer5", 96 + 96, 64, "l5", None),
            ("decoder_layer4", 64 + 64, 32, "l4", "idx4_de"),
            ("decoder_layer3", 32 + 32, 24, "l3", "idx3_de"),
            ("decoder_layer2", 24 + 24, 16, "l2", "idx2_de"),
            ("decoder_layer1", 16 + 16, 32, "l1", None),
            ("decoder_layer0", 32 + 32, 32, "l0", "idx0_de"))
_SPLIT = 3          # decoder_layer4 ends the extract half: 32 channels, OS 8


class IndexMattingDecoder(nn.Module):
    """The decoder of both IndexNet models (the JAX package's
    IndexMattingDecoder and IndexMattingDecoderVMN, whose parameters are
    the same). ``mode='extract'`` runs decoder_layer6..4, 32 channels at
    OS 8; ``mode='head'`` continues from the FAM output ``x`` through
    decoder_layer3..0 and the prediction head (conv_bn 32 -> 1 and a 5x5
    1 -> 1 conv, unclipped); ``'full'`` runs both."""

    # the modules mode="extract" runs, frozen with the encoder under
    # FREEZE_BACKBONE (models/vmn.py::VMN.train)
    EXTRACT_MODULES = tuple(layer[0] for layer in _DECODER[:_SPLIT])

    def __init__(self):
        super().__init__()
        for name, cin, cout, _, _ in _DECODER:
            self.add_module(name, IndexedUpsampling(cin, cout))
        self.pred = nn.Sequential(conv_bn_relu6(32, 1, 5),
                                  nn.Conv2d(1, 1, 5, padding=2, bias=False))

    @staticmethod
    def prune_enc_head(enc: dict) -> dict:
        """Keep what ``mode='head'`` reads: skip levels 0-3 and their index
        maps."""
        return {k: enc[k] for k in
                ("l0", "l1", "l2", "l3", "idx0_de", "idx2_de", "idx3_de")}

    def _run(self, layers, x, enc):
        for name, _, _, skip, idx in layers:
            x = getattr(self, name)(x, enc[skip],
                                    None if idx is None else enc[idx])
        return x

    def forward(self, enc: dict, mode: str = "full", x=None) -> torch.Tensor:
        if mode in ("full", "extract"):
            x = self._run(_DECODER[:_SPLIT], enc["l"], enc)
            if mode == "extract":
                return x
        return self.pred(self._run(_DECODER[_SPLIT:], x, enc))


class IndexMatting(EncoderDecoder):
    """Single-frame IndexNet (reference net.py:285-294). ``forward(x)``:
    ``x`` ``[N, 4, H, W]``, H and W multiples of 32; returns alpha
    ``[N, 1, H, W]``, unclipped."""

    def __init__(self, input_chn: int = 4):
        super().__init__()
        self.encoder = IndexMattingEncoder(input_chn)
        self.decoder = IndexMattingDecoder()

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.decoder(self.encoder(x))
