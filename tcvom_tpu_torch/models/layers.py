"""Layer primitives of the matting backbones (port of
tcvom_tpu/models/layers.py), NCHW with OIHW kernels."""
from __future__ import annotations

import torch
import torch.nn as nn
import torch.nn.functional as F


def at_least_f32(x: torch.Tensor) -> torch.Tensor:
    """``x`` in f32, or in f64 when it is f64: the f32 islands of a bf16
    network stay f32, and an f64 network stays f64 throughout."""
    return x.to(torch.promote_types(x.dtype, torch.float32))


def ws_standardize(weight: torch.Tensor) -> torch.Tensor:
    """Weight standardization (reference models/FBA/layers_WS.py:13-23):
    subtract the per-output-channel mean and divide by the unbiased std
    (+1e-12 inside the sqrt, +1e-5 outside). Computed in at least f32 and
    cast back to the weight's dtype."""
    w32 = at_least_f32(weight)
    w = w32 - w32.mean(dim=(1, 2, 3), keepdim=True)
    var = w.reshape(w.shape[0], -1).var(dim=1, unbiased=True)
    std = torch.sqrt(var + 1e-12) + 1e-5
    return (w / std[:, None, None, None]).to(weight.dtype)


class WSConv2d(nn.Conv2d):
    """Weight-standardized conv (FBA; reference models/FBA/layers_WS.py)."""

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return F.conv2d(x, ws_standardize(self.weight), self.bias,
                        self.stride, self.padding, self.dilation, self.groups)


def GroupNorm32(channels: int) -> nn.GroupNorm:
    """GroupNorm(32, eps 1e-5) (FBA's ``norm``, models/FBA/layers_WS.py:26).
    PyTorch keeps the statistics in f32 for bf16 inputs."""
    return nn.GroupNorm(32, channels, eps=1e-5)


def BatchNorm(channels: int) -> nn.BatchNorm2d:
    """BatchNorm2d with the JAX package's settings (eps 1e-5, momentum 0.1,
    flax's 0.9), used in eval mode: the running statistics of a
    checkpoint. (In training, flax updates the running variance with the
    biased batch variance and torch with the unbiased one: ROADMAP.md
    Queue 1 item 11.)"""
    return nn.BatchNorm2d(channels, eps=1e-5, momentum=0.1)


def conv_bn_relu6(cin: int, cout: int, kernel: int) -> nn.Sequential:
    """conv (no bias, stride 1, same padding) + BatchNorm + ReLU6
    (``min(max(x, 0), 6)``), the reference's ``conv_bn``
    (models/Index/hlconv.py:36-41): keys ``.0`` and ``.1``."""
    return nn.Sequential(
        nn.Conv2d(cin, cout, kernel, padding=kernel // 2, bias=False),
        BatchNorm(cout), nn.ReLU6())
