"""DIM backbone (Deep Image Matting; port of tcvom_tpu/models/dim.py), NCHW.

A VGG16 encoder with BatchNorm and five argmax max-pools, ``conv6`` 7x7
512 -> 4096, and a decoder that max-unpools with the recorded indices
(reference models/DIM/vggnet.py:10-133, models/VMN/VMN_DIM.py). Input is
4 channels: normalized RGB and the 1-channel trimap; output is alpha.
Module names are the reference's ``state_dict`` keys: flat for the
single-frame model, under ``encoder.`` and ``decoder.`` in the VMN.
"""
from __future__ import annotations

import torch
import torch.nn as nn
import torch.nn.functional as F

from tcvom_tpu_torch.models.layers import BatchNorm
from tcvom_tpu_torch.ops.image import max_pool_argmax_2x2, max_unpool_2x2

_STAGES = ((2, 64), (2, 128), (3, 256), (3, 512), (3, 512))
# the encoder's modules, which the single-frame model keeps beside the
# decoder's under flat keys
_ENCODER_MODULES = tuple(
    f"{kind}{stage}{j}" for stage, (n_convs, _) in enumerate(_STAGES, start=1)
    for j in range(1, n_convs + 1) for kind in ("conv", "bn")) + ("conv6",)
# (name, in, out) of the 5x5 convs after each unpool, deepest first
_UP = (("dconv5", 512, 512), ("dconv4", 512, 256), ("dconv3", 256, 128),
       ("dconv2", 128, 64), ("dconv1", 64, 64))


def _add_encoder(m: nn.Module, input_chn: int) -> None:
    cin = input_chn
    for stage, (n_convs, feat) in enumerate(_STAGES, start=1):
        for j in range(1, n_convs + 1):
            m.add_module(f"conv{stage}{j}", nn.Conv2d(cin, feat, 3, padding=1))
            m.add_module(f"bn{stage}{j}", BatchNorm(feat))
            cin = feat
    m.conv6 = nn.Conv2d(512, 4096, 7, padding=3)


def _encode(m: nn.Module, x: torch.Tensor) -> dict:
    idxs = []
    for stage, (n_convs, _) in enumerate(_STAGES, start=1):
        for j in range(1, n_convs + 1):
            x = F.relu(getattr(m, f"bn{stage}{j}")(
                getattr(m, f"conv{stage}{j}")(x)))
        x, idx = max_pool_argmax_2x2(x)
        idxs.append(idx)
    return {"indices": tuple(idxs), "x6": F.relu(m.conv6(x))}


class DIMEncoder(nn.Module):
    """VGG16 with BatchNorm; returns {"indices": the pools' uint8 in-window
    indices, OS 2 to 32, "x6": conv6's features at OS 32}."""

    def __init__(self, input_chn: int = 4):
        super().__init__()
        _add_encoder(self, input_chn)

    def forward(self, x: torch.Tensor) -> dict:
        return _encode(self, x)


class DIMDecoder(nn.Module):
    """The decoder of both DIM models (the JAX package's DIMDecoder and
    DIMDecoderVMN, whose parameters are the same). ``mode='extract'`` runs
    dconv6 -> unpool5/dconv5 -> unpool4/dconv4, 256 channels at OS 8 (the
    per-frame half of the VMN); ``mode='head'`` continues from the FAM
    output ``x``: unpool3..1 with their 5x5 convs, ``alpha_pred``, clip
    (``_dim_head_slow``); ``'full'`` runs both."""

    # the modules mode="extract" runs, frozen with the encoder under
    # FREEZE_BACKBONE (models/vmn.py::VMN.train)
    EXTRACT_MODULES = ("dconv6", "dconv5", "dconv4")

    def __init__(self):
        super().__init__()
        self.dconv6 = nn.Conv2d(4096, 512, 1)
        for name, cin, cout in _UP:
            self.add_module(name, nn.Conv2d(cin, cout, 5, padding=2))
        self.alpha_pred = nn.Conv2d(64, 1, 5, padding=2)

    @staticmethod
    def prune_enc_head(enc: dict) -> dict:
        """Keep what ``mode='head'`` reads: the pool indices 1-3."""
        i1, i2, i3, _, _ = enc["indices"]
        return {"indices": (i1, i2, i3, None, None)}

    def _up(self, name: str, x, idx):
        return F.relu(getattr(self, name)(max_unpool_2x2(x, idx)))

    def forward(self, enc: dict, mode: str = "full", x=None) -> torch.Tensor:
        i1, i2, i3, i4, i5 = enc["indices"]
        if mode in ("full", "extract"):
            x = F.relu(self.dconv6(enc["x6"]))
            x = self._up("dconv4", self._up("dconv5", x, i5), i4)
            if mode == "extract":
                return x
        x = self._up("dconv1", self._up("dconv2", self._up("dconv3", x, i3),
                                        i2), i1)
        return torch.clamp(self.alpha_pred(x), 0.0, 1.0)


class DeepMatting(DIMDecoder):
    """Single-frame DIM (reference DIM_VGG): the encoder's layers beside
    the decoder's in one module, as the reference's flat keys have them.
    ``forward(x)``: ``x`` ``[N, 4, H, W]``, H and W multiples of 32;
    returns alpha ``[N, 1, H, W]`` in [0, 1]."""

    def __init__(self, input_chn: int = 4):
        super().__init__()
        _add_encoder(self, input_chn)

    def frozen_modules(self) -> list[nn.Module]:
        """The backbone that FREEZE_BACKBONE freezes: the encoder's layers
        and the extract half's."""
        return [getattr(self, name)
                for name in _ENCODER_MODULES + self.EXTRACT_MODULES]

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return super().forward(_encode(self, x))
