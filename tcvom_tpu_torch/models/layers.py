"""Layer primitives of the matting backbones (port of
tcvom_tpu/models/layers.py), NCHW with OIHW kernels."""
from __future__ import annotations

import torch
import torch.nn as nn
import torch.nn.functional as F

from tcvom_tpu_torch import parallel


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


class EncoderDecoder(nn.Module):
    """A model of an ``encoder`` and a ``decoder`` whose class lists the
    modules of its feature-extraction half in ``EXTRACT_MODULES``."""

    def frozen_modules(self) -> list[nn.Module]:
        """The backbone that FREEZE_BACKBONE freezes: the encoder and the
        decoder's extract half."""
        return [self.encoder] + [getattr(self.decoder, name) for name in
                                 type(self.decoder).EXTRACT_MODULES]


class BatchNorm(nn.BatchNorm2d):
    """BatchNorm2d with the JAX package's settings and training semantics
    (flax's ``nn.BatchNorm`` and ``RawBatchNorm``,
    tcvom_tpu/models/layers.py:25-32, :90-123): eps 1e-5, momentum 0.1
    (flax's 0.9).

    Eval mode is torch's own: the running statistics. In training the
    input is normalized with the batch mean and the *biased* batch
    variance, as in torch, and the running statistics are updated without
    gradient from that same biased variance, as flax does (torch's own
    update takes the unbiased one, n/(n-1) larger). With ``momentum=None``
    (a cumulative average, which flax does not have;
    ``registry.calibrate_random_weights`` sets it) training is torch's own
    throughout. The ``state_dict`` keys are torch's.

    One statistics pass: ``F.batch_norm`` at momentum 1 writes the batch
    mean and unbiased variance into scratch buffers beside the output, and
    the running statistics move toward that mean and that variance times
    (n-1)/n.

    Under a process group of more than one rank the batch is every rank's
    (``parallel``; the JAX package's BatchNorm over the global batch under
    GSPMD, tcvom_tpu/parallel/mesh.py:10-11): the mean and then the biased
    variance are sums over the ranks through a differentiable all-reduce,
    and the running statistics move toward those, alike on every rank.
    ``torch.nn.SyncBatchNorm`` would update them from the unbiased
    variance and runs on the card only."""

    def __init__(self, channels: int):
        super().__init__(channels, eps=1e-5, momentum=0.1)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if not self.training or self.momentum is None:
            return super().forward(x)
        if parallel.world() > 1:
            return self._synced(x)
        mean = torch.zeros_like(self.running_mean)
        var = torch.zeros_like(self.running_var)
        y = F.batch_norm(x, mean, var, self.weight, self.bias, True, 1.0,
                         self.eps)
        n = x.numel() // x.shape[1]
        self._update(mean, var * ((n - 1) / n))
        return y

    def _synced(self, x: torch.Tensor) -> torch.Tensor:
        """Training forward over every rank's batch (each rank's of the
        same shape, as the sharded loader gives them): two passes, the
        mean and then the centred second moment, each summed over the
        ranks."""
        dims = (0, 2, 3)
        count = float(x.numel() // x.shape[1] * parallel.world())
        mean = parallel.all_reduce_sum_grad(x.sum(dims)) / count
        xc = x - mean[None, :, None, None]
        var = parallel.all_reduce_sum_grad((xc * xc).sum(dims)) / count
        scale = self.weight * torch.rsqrt(var + self.eps)
        self._update(mean.detach(), var.detach())
        return xc * scale[None, :, None, None] + self.bias[None, :, None, None]

    @torch.no_grad()
    def _update(self, mean: torch.Tensor, biased_var: torch.Tensor) -> None:
        self.num_batches_tracked.add_(1)
        self.running_mean.lerp_(mean, self.momentum)
        self.running_var.lerp_(biased_var, self.momentum)


class Dropout(nn.Dropout):
    """``nn.Dropout`` whose training mask is drawn from ``generator`` when
    one is set (the trainer sets one, seeded from its own: a step is then
    reproducible from the trainer's seed), else from torch's global RNG.
    Elements are zeroed with probability ``p`` and the rest scaled by
    ``1 / (1 - p)``; eval mode is the identity. Under a process group of
    more than one rank the mask is drawn for every rank's rows (the
    generator is seeded alike on each) and the rank keeps its own, so
    that a step of the ranks is the one-process step on their global
    batch."""

    generator: torch.Generator | None = None

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if not self.training or self.generator is None:
            return super().forward(x)
        n = parallel.world()
        if n == 1:
            keep = torch.empty_like(x).bernoulli_(1.0 - self.p,
                                                  generator=self.generator)
        else:
            keep = x.new_empty((x.shape[0] * n,) + x.shape[1:]).bernoulli_(
                1.0 - self.p, generator=self.generator)
            keep = keep[parallel.shard_slice(keep.shape[0])]
        return x * keep / (1.0 - self.p)


def conv_bn_relu6(cin: int, cout: int, kernel: int) -> nn.Sequential:
    """conv (no bias, stride 1, same padding) + BatchNorm + ReLU6
    (``min(max(x, 0), 6)``), the reference's ``conv_bn``
    (models/Index/hlconv.py:36-41): keys ``.0`` and ``.1``."""
    return nn.Sequential(
        nn.Conv2d(cin, cout, kernel, padding=kernel // 2, bias=False),
        BatchNorm(cout), nn.ReLU6())


def l2n(v: torch.Tensor, eps: float = 1e-12) -> torch.Tensor:
    """``v / (||v|| + eps)``, the power iteration's normalization."""
    return v / (torch.linalg.vector_norm(v) + eps)


class _SNParams(nn.Module):
    """The parameters of a spectral-norm conv under the reference wrapper's
    names (models/GCA/ops.py:12-80): ``weight_bar`` (OIHW for a conv, IOHW
    for a transposed conv) and the power iteration's vectors ``weight_u``
    (``weight_bar.shape[0]``) and ``weight_v`` (the rest of the flattened
    weight), held as buffers. GCA's spectral-norm convs have no bias."""

    def __init__(self, shape: tuple[int, ...]):
        super().__init__()
        self.weight_bar = nn.Parameter(torch.empty(shape))
        width = shape[1] * shape[2] * shape[3]
        self.register_buffer("weight_u", l2n(torch.randn(shape[0])))
        self.register_buffer("weight_v", l2n(torch.randn(width)))


class SNConv2d(nn.Module):
    """Conv2d (or, with ``transpose=True``, ConvTranspose2d) wrapped in
    spectral normalization (GCA; port of ``SNConv`` and ``SNConvRaw``,
    tcvom_tpu/models/layers.py:127-189, 258-330). The conv runs with
    ``weight_bar / sigma``, ``sigma = u . (W @ v)`` where ``W`` is
    ``weight_bar`` flattened to ``[weight_bar.shape[0], -1]``: the output
    channels of a conv, the *input* channels of a transposed conv (torch's
    IOHW), as the reference's ``view(height, -1)`` has it.

    In eval mode the stored ``u`` and ``v`` are used as they are. In
    ``.train()`` mode one power iteration updates them first, without
    gradient (``v = l2n(W^T u)``, ``u = l2n(W v)``); the gradient reaches
    the weight through sigma only, as the JAX package's ``stop_gradient``s
    of ``u`` and ``v`` have it.

    Sigma and the normalized weight are computed in at least f32 and the
    weight cast to the input's dtype. The JAX package's bf16 stream casts
    ``u``, ``v`` and the kernel to bf16 and computes sigma in bf16
    (tcvom_tpu/infer/predict.py:159); here a model cast to bf16 holds
    bf16 ``u``, ``v`` and ``weight_bar`` too, but sigma is not rounded.

    The transposed conv is ``F.conv_transpose2d`` on the IOHW weight, the
    JAX package's ``conv_transpose_torch``."""

    def __init__(self, in_channels: int, out_channels: int, kernel_size: int,
                 stride: int = 1, padding: int = 0, transpose: bool = False):
        super().__init__()
        k = kernel_size
        shape = ((in_channels, out_channels, k, k) if transpose
                 else (out_channels, in_channels, k, k))
        self.module = _SNParams(shape)
        self.stride, self.padding, self.transpose = stride, padding, transpose

    def _wmat(self) -> torch.Tensor:
        w = at_least_f32(self.module.weight_bar)
        return w.reshape(w.shape[0], -1)

    @torch.no_grad()
    def power_iteration(self) -> None:
        """One power-iteration step on the stored ``u``, ``v``."""
        wmat = self._wmat().detach()
        m = self.module
        v = l2n(wmat.t() @ at_least_f32(m.weight_u))
        u = l2n(wmat @ v)
        m.weight_u.copy_(u)
        m.weight_v.copy_(v)

    def sigma(self) -> torch.Tensor:
        m = self.module
        u, v = (at_least_f32(t).detach() for t in (m.weight_u, m.weight_v))
        return u @ (self._wmat() @ v)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if self.training:
            self.power_iteration()
        w = (at_least_f32(self.module.weight_bar) / self.sigma()).to(x.dtype)
        if self.transpose:
            return F.conv_transpose2d(x, w, None, self.stride, self.padding)
        return F.conv2d(x, w, None, self.stride, self.padding)
