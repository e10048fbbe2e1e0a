"""Layer primitives of the matting backbones (port of
tcvom_tpu/models/layers.py), NCHW with OIHW kernels.

Under the bf16 training recipe (``MattingTrainer(compute_dtype=
torch.bfloat16)``) the layers receive bf16 parameters and f32
activations, as the JAX package's layers do under its ``_cast_compute``
(its normalized input is promoted to f32 by the f32 mean and std). Each
layer then does what the JAX layer does: a weight is cast to its input's
dtype for the product with the input (so the arithmetic is f32 on
bf16-rounded weights, and the gradient is rounded to bf16 by that cast's
backward), what a layer computes from its parameters and state alone runs
in the parameters' dtype (weight standardization excepted: f32, cast
back), and the state it reads (BatchNorm's running statistics,
``u``, ``v``) is rounded to that dtype; new state is stored in the f32
buffers. With parameters and input of one dtype every layer is as
before.

Under ``checkpointed`` (``--remat``) a forward runs twice, the second
time in the backward pass; :func:`recomputing` tells a layer that it is
in the second run, where it writes no state and draws no new random
numbers.
"""
from __future__ import annotations

import contextlib
import contextvars

import torch
import torch.nn as nn
import torch.nn.functional as F
import torch.utils.checkpoint

from tcvom_tpu_torch import parallel
from tcvom_tpu_torch.ops import group_norm_kernel
from tcvom_tpu_torch.parallel import space


def at_least_f32(x: torch.Tensor) -> torch.Tensor:
    """``x`` in f32, or in f64 when it is f64: the f32 islands of a bf16
    network stay f32, and an f64 network stays f64 throughout."""
    return x.to(torch.promote_types(x.dtype, torch.float32))


def weak(value: float, dtype: torch.dtype) -> float:
    """The Python float ``value`` rounded to ``dtype``, as JAX converts a
    Python scalar that meets an array of that dtype (a weak type); torch
    would compute with the unrounded value."""
    return float(torch.tensor(value, dtype=dtype))


# -- recomputation (--remat) --------------------------------------------------

class _Run:
    """A ``checkpointed`` call: whether its forward is being recomputed,
    and the generator states its Dropouts drew from in the first run."""

    def __init__(self):
        self.replaying = False
        self.draws: dict[int, list[torch.Tensor]] = {}


# the checkpointed call whose forward runs now in this thread: set by its
# checkpoint's context managers, in the thread that runs each of its runs
_RUN: contextvars.ContextVar[_Run | None] = contextvars.ContextVar(
    "checkpointed_run", default=None)


@contextlib.contextmanager
def _in_run(run: _Run, replaying: bool):
    run.replaying = replaying
    token = _RUN.set(run)
    try:
        yield
    finally:
        _RUN.reset(token)


def recomputing() -> bool:
    """Whether a ``checkpointed`` forward is being recomputed now (in the
    backward pass). The layers that write in their forward read it:
    BatchNorm leaves its statistics and SNConv2d its ``u``, ``v`` as the
    first run left them, and Dropout draws its first run's mask again."""
    run = _RUN.get()
    return run is not None and run.replaying


def checkpointed(module: nn.Module, *args):
    """``module(*args)`` under non-reentrant ``torch.utils.checkpoint``:
    its activations are freed after the forward and recomputed in the
    backward pass (the JAX package's ``nn.remat``,
    tcvom_tpu/models/registry.py:38-58). The recomputation reads the
    parameters the first run read (under the bf16 recipe their bf16
    casts, which are gone from the module by then) and, through
    :func:`recomputing`, writes no state. Without gradient it is the
    plain call."""
    if not torch.is_grad_enabled():
        return module(*args)
    params = dict(module.named_parameters())
    run = _Run()
    return torch.utils.checkpoint.checkpoint(
        lambda *a: torch.func.functional_call(module, params, a), *args,
        use_reentrant=False,
        context_fn=lambda: (_in_run(run, False), _in_run(run, True)))


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


def _like(p: torch.Tensor | None, x: torch.Tensor) -> torch.Tensor | None:
    """Parameter ``p`` in ``x``'s dtype (itself when it is already, without
    the cost of a ``to`` call on the host)."""
    return p if p is None or p.dtype == x.dtype else p.to(x.dtype)


def _banded_conv(x: torch.Tensor, weight: torch.Tensor,
                 bias: torch.Tensor | None, bands: space.Bands,
                 stride: tuple[int, int], padding: tuple[int, int],
                 dilation: tuple[int, int] = (1, 1),
                 groups: int = 1) -> torch.Tensor:
    """``F.conv2d(x, weight, bias, stride, padding, dilation, groups)`` of
    this rank's band of a band-split ``x`` (``parallel.space``): the rows
    its band of the output reads, halos from the other bands included,
    with no padding on H."""
    x = bands.window(x, weight.shape[-2], stride[0], dilation[0], padding[0])
    return F.conv2d(x, weight, bias, stride, (0, padding[1]), dilation,
                    groups)


def _banded_conv_transpose(x: torch.Tensor, weight: torch.Tensor,
                           bands: space.Bands, stride: int,
                           padding: int) -> torch.Tensor:
    """``F.conv_transpose2d(x, weight, None, 2, 1)`` (kernel 4) of this
    rank's band of a band-split ``x``: the band with one row above and one
    below (the other bands' rows, zero outside the frame, which adds
    nothing to a transposed conv), transposed with no padding on H, and
    its output cropped to the band's ``2h`` rows: rows ``[3, 3 + 2h)``
    (output row ``o`` of the padded call is global row ``o + 2 lo - 3``)."""
    if (weight.shape[-2], stride, padding) != (4, 2, 1):
        raise ValueError(f"band mode transposes (kernel, stride, padding) = "
                         f"(4, 2, 1) only, not ({weight.shape[-2]}, "
                         f"{stride}, {padding})")
    h = x.shape[-2]
    lo, hi, _ = bands.span(h)
    x = bands.rows(x, lo - 1, hi + 1)
    y = F.conv_transpose2d(x, weight, None, stride, (0, padding))
    return y[..., 3:3 + 2 * h, :]


class Conv2d(nn.Conv2d):
    """``nn.Conv2d`` whose weight and bias are cast to the input's dtype
    (the JAX package's ``nn.Conv`` promotes them alike). Band-aware
    (``parallel.space``)."""

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        weight, bias = _like(self.weight, x), _like(self.bias, x)
        bands = space.current()
        if bands is not None:
            return _banded_conv(x, weight, bias, bands, self.stride,
                                self.padding, self.dilation, self.groups)
        return self._conv_forward(x, weight, bias)


class WSConv2d(nn.Conv2d):
    """Weight-standardized conv (FBA; reference models/FBA/layers_WS.py).
    The standardized weight, in the parameter's dtype, is cast to the
    input's (tcvom_tpu/models/layers.py:251). Band-aware
    (``parallel.space``)."""

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        weight = ws_standardize(self.weight).to(x.dtype)
        bias = _like(self.bias, x)
        bands = space.current()
        if bands is not None:
            return _banded_conv(x, weight, bias, bands, self.stride,
                                self.padding, self.dilation, self.groups)
        return F.conv2d(x, weight, bias, self.stride, self.padding,
                        self.dilation, self.groups)


class GroupNorm(nn.GroupNorm):
    """``nn.GroupNorm`` whose affine is cast to the input's dtype. PyTorch
    keeps the statistics in f32 for bf16 inputs, as the JAX package's
    ``_GroupNorm`` does.

    ``act`` (None, ``"relu"`` or ``"leaky_relu"``) is the activation that
    follows the norm, and ``forward``'s ``residual`` is added before it:
    ``act(norm(x) + residual)``. On the card, with no gradient needed and
    whole tensors, the hand-written kernels do all three
    (``ops/group_norm_kernel.py``), and raise for what they do not take
    (f64); on the CPU, under a gradient and in band mode they run as
    separate ops.

    In band mode (``parallel.space``) each (sample, group) mean and
    variance is over every band: the sums and counts of this rank's band
    summed over the bands, the mean first and then the centred squares
    (two passes, for f32 at one-process accuracy), in at least f32."""

    def __init__(self, num_groups: int, num_channels: int, eps: float = 1e-5,
                 affine: bool = True, act: str | None = None):
        if act not in group_norm_kernel.ACTS:
            raise ValueError(f"act must be one of "
                             f"{list(group_norm_kernel.ACTS)}, got {act!r}")
        super().__init__(num_groups, num_channels, eps, affine)
        self.act = act

    def forward(self, x: torch.Tensor,
                residual: torch.Tensor | None = None) -> torch.Tensor:
        weight, bias = _like(self.weight, x), _like(self.bias, x)
        bands = space.current()
        if bands is None and not group_norm_kernel.runs_plain(
                x, weight, bias, residual):
            # as PyTorch's own CUDA GroupNorm does: a channels-last input
            # (the stem's convolution of the permuted frame) is made
            # contiguous
            return group_norm_kernel.group_norm_cuda(
                x.contiguous(), self.num_groups, weight, bias, self.eps,
                self.act, None if residual is None else residual.contiguous())
        y = (self._banded(x, bands) if bands is not None else
             F.group_norm(x, self.num_groups, weight, bias, self.eps))
        return group_norm_kernel.epilogue(y, self.act, residual)

    def _banded(self, x: torch.Tensor, bands: space.Bands) -> torch.Tensor:
        xf = at_least_f32(x).reshape(x.shape[0], self.num_groups, -1)
        count = xf.new_full(xf.shape[:2] + (1,), xf.shape[-1])
        sums = bands.sum_over_bands(torch.cat([xf.sum(-1, keepdim=True), count], -1))
        count = sums[..., 1:]
        xc = xf - sums[..., :1] / count
        var = bands.sum_over_bands(xc.square().sum(-1, keepdim=True)) / count
        y = (xc * torch.rsqrt(var + self.eps)).reshape(x.shape)
        shape = (1, -1) + (1,) * (x.dim() - 2)
        y = (y * self.weight.to(y.dtype).view(shape)
             + self.bias.to(y.dtype).view(shape))
        return y.to(x.dtype)


def GroupNorm32(channels: int, act: str | None = None) -> GroupNorm:
    """GroupNorm(32, eps 1e-5) (FBA's ``norm``, models/FBA/layers_WS.py:26),
    followed by ``act``."""
    return GroupNorm(32, channels, eps=1e-5, act=act)


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
    variance and runs on the card only.

    Under the bf16 recipe (bf16 weight and bias, f32 input) training
    normalizes with the f32 input's statistics and the affine cast to
    f32, and the running statistics move in JAX's order
    (tcvom_tpu/models/layers.py:111-117; flax alike): flax's momentum
    (0.9, torch's ``1 - momentum``; a weak Python float, so rounded to
    bf16) times the old value rounded to bf16, in bf16, plus ``(1 -
    0.9) * batch`` in f32, stored in f32.
    In eval mode (a frozen backbone) it is flax's ``_normalize`` on the
    statistics rounded to bf16: ``(x - mean) * (rsqrt(var + eps) *
    scale) + bias``, the bracket in bf16. While a ``checkpointed``
    forward is recomputed the statistics are left as they are (the
    synchronized form still does its all-reduces, alike on every
    rank)."""

    def __init__(self, channels: int):
        super().__init__(channels, eps=1e-5, momentum=0.1)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if not self.training or self.momentum is None:
            if self.weight.dtype != x.dtype and not self.training:
                return self._eval_cast(x)
            return super().forward(x)
        if parallel.world() > 1:
            return self._synced(x)
        mean = torch.zeros_like(self.running_mean)
        var = torch.zeros_like(self.running_var)
        y = F.batch_norm(x, mean, var, _like(self.weight, x),
                         _like(self.bias, x), True, 1.0, self.eps)
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
        scale = _like(self.weight, x) * torch.rsqrt(var + self.eps)
        self._update(mean.detach(), var.detach())
        return (xc * scale[None, :, None, None]
                + _like(self.bias, x)[None, :, None, None])

    def _eval_cast(self, x: torch.Tensor) -> torch.Tensor:
        """Eval mode under the bf16 recipe (flax's ``_normalize``)."""
        dt = self.weight.dtype
        mean, var = (b.to(dt)[None, :, None, None]
                     for b in (self.running_mean, self.running_var))
        mul = torch.rsqrt(var + weak(self.eps, dt)) * self.weight[
            None, :, None, None]
        return (x - mean) * mul + self.bias[None, :, None, None]

    @torch.no_grad()
    def _update(self, mean: torch.Tensor, biased_var: torch.Tensor) -> None:
        if recomputing():
            return
        self.num_batches_tracked.add_(1)
        dt = self.weight.dtype
        if dt == self.running_mean.dtype:
            self.running_mean.lerp_(mean, self.momentum)
            self.running_var.lerp_(biased_var, self.momentum)
            return
        keep = torch.tensor(1.0 - self.momentum, dtype=dt,
                            device=self.running_mean.device)
        for buf, new in ((self.running_mean, mean),
                         (self.running_var, biased_var)):
            buf.copy_(keep * buf.to(dt) + self.momentum * new)


class Dropout(nn.Dropout):
    """``nn.Dropout`` whose training mask is drawn from ``generator`` when
    one is set (the trainer sets one, seeded from its own: a step is then
    reproducible from the trainer's seed), else from torch's global RNG.
    Elements are zeroed with probability ``p`` and the rest scaled by
    ``1 / (1 - p)``; eval mode is the identity. Under a process group of
    more than one rank the mask is drawn for every rank's rows (the
    generator is seeded alike on each) and the rank keeps its own, so
    that a step of the ranks is the one-process step on their global
    batch.

    Under ``checkpointed`` the first run keeps the generator's state
    before its draw, and the recomputation draws from a copy at that
    state: the same mask, and the generator stands where one plain
    forward leaves it (``checkpoint``'s ``preserve_rng_state`` covers
    only torch's default generators)."""

    generator: torch.Generator | None = None

    def _source(self) -> torch.Generator:
        """The generator of this draw (see the class docstring)."""
        run = _RUN.get()
        if run is None:
            return self.generator
        states = run.draws.setdefault(id(self), [])
        if not run.replaying:
            states.append(self.generator.get_state())
            return self.generator
        replay = torch.Generator(self.generator.device)
        replay.set_state(states.pop(0))
        return replay

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if not self.training or self.generator is None:
            return super().forward(x)
        n, gen = parallel.world(), self._source()
        if n == 1:
            keep = torch.empty_like(x).bernoulli_(1.0 - self.p,
                                                  generator=gen)
        else:
            keep = x.new_empty((x.shape[0] * n,) + x.shape[1:]).bernoulli_(
                1.0 - self.p, generator=gen)
            keep = keep[parallel.shard_slice(keep.shape[0])]
        return x * keep / (1.0 - self.p)


def conv_bn_relu6(cin: int, cout: int, kernel: int) -> nn.Sequential:
    """conv (no bias, stride 1, same padding) + BatchNorm + ReLU6
    (``min(max(x, 0), 6)``), the reference's ``conv_bn``
    (models/Index/hlconv.py:36-41): keys ``.0`` and ``.1``."""
    return nn.Sequential(
        Conv2d(cin, cout, kernel, padding=kernel // 2, bias=False),
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
    of ``u`` and ``v`` have it. While a ``checkpointed`` forward is
    recomputed there is no power iteration: sigma is taken from the
    ``u``, ``v`` the first run left.

    Sigma and the normalized weight are computed in at least f32 and the
    weight cast to the input's dtype. The JAX package's bf16 stream casts
    ``u``, ``v`` and the kernel to bf16 and computes sigma in bf16
    (tcvom_tpu/infer/predict.py:159); here a model cast to bf16 holds
    bf16 ``u``, ``v`` and ``weight_bar`` too, but sigma is not rounded.
    Under the bf16 training recipe (a bf16 ``weight_bar`` before an f32
    input) the power iteration, sigma and ``weight_bar / sigma`` run in
    bf16 on ``u``, ``v`` rounded to bf16, as JAX's do there (its state
    and kernel are cast to bf16, ``SNConv`` :305-316); the new ``u``,
    ``v`` are stored in the f32 buffers.

    The transposed conv is ``F.conv_transpose2d`` on the IOHW weight, the
    JAX package's ``conv_transpose_torch``.

    Band-aware (``parallel.space``), with the weight and sigma of the
    whole frame: the conv takes its halo rows from the other bands, the
    transposed conv (GCA's (4, 2, 1) only) one row from each side."""

    def __init__(self, in_channels: int, out_channels: int, kernel_size: int,
                 stride: int = 1, padding: int = 0, transpose: bool = False):
        super().__init__()
        k = kernel_size
        shape = ((in_channels, out_channels, k, k) if transpose
                 else (out_channels, in_channels, k, k))
        self.module = _SNParams(shape)
        self.stride, self.padding, self.transpose = stride, padding, transpose

    def _dtype(self, x: torch.Tensor | None = None) -> torch.dtype:
        """The dtype of the power iteration and sigma: the weight's under
        the bf16 recipe (``x`` of another dtype), else at least f32."""
        dt = self.module.weight_bar.dtype
        if x is not None and x.dtype != dt:
            return dt
        return torch.promote_types(dt, torch.float32)

    def _wmat(self, dtype: torch.dtype) -> torch.Tensor:
        w = self.module.weight_bar.to(dtype)
        return w.reshape(w.shape[0], -1)

    @torch.no_grad()
    def power_iteration(self, dtype: torch.dtype | None = None) -> None:
        """One power-iteration step on the stored ``u``, ``v``, in
        ``dtype`` (default: at least f32)."""
        dtype = dtype or self._dtype()
        wmat = self._wmat(dtype).detach()
        m = self.module
        v = l2n(wmat.t() @ m.weight_u.to(dtype))
        u = l2n(wmat @ v)
        m.weight_u.copy_(u)
        m.weight_v.copy_(v)

    def sigma(self, dtype: torch.dtype | None = None) -> torch.Tensor:
        dtype = dtype or self._dtype()
        m = self.module
        u, v = (t.to(dtype).detach() for t in (m.weight_u, m.weight_v))
        return u @ (self._wmat(dtype) @ v)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        dt = self._dtype(x)
        if self.training and not recomputing():
            self.power_iteration(dt)
        w = (self.module.weight_bar.to(dt) / self.sigma(dt)).to(x.dtype)
        bands = space.current()
        if self.transpose:
            if bands is not None:
                return _banded_conv_transpose(x, w, bands, self.stride,
                                              self.padding)
            return F.conv_transpose2d(x, w, None, self.stride, self.padding)
        if bands is not None:
            return _banded_conv(x, w, None, bands, (self.stride,) * 2,
                                (self.padding,) * 2)
        return F.conv2d(x, w, None, self.stride, self.padding)
