"""Plain PyTorch pieces of the matting eval path that the reference models
share: the arithmetic policy, the layers, the eval preprocessing with FBA's
trimap encoding, the FAM window attention, the paste and the uint8
quantization.

Tensors are NCHW inside the networks; frames and trimaps come in as the
program takes them, uint8 ``[N, H, W, 3]`` (BGR) and ``[N, H, W, 1]``.
Nothing here imports the program under test.
"""
from __future__ import annotations

import contextlib
import math

import torch
import torch.nn.functional as F

IMG_SCALE = 1.0 / 255.0
IMG_MEAN = (0.485, 0.456, 0.406)
IMG_STD = (0.229, 0.224, 0.225)
FP8_MAX = 448.0                 # the largest finite float8_e4m3fn


class Arith:
    """How the reference computes: the dtype of the network's activations
    and weights, and the rounding applied to every operand of a
    convolution and of a matrix product (``operand``, the identity by
    default). Preprocessing, statistics, softmaxes and the FBA fusion run
    in at least f32 whatever the dtype."""

    def __init__(self, dtype: torch.dtype = torch.float32, operand=None):
        self.dtype = dtype
        self.operand = operand

    def op(self, t: torch.Tensor) -> torch.Tensor:
        t = t.to(self.dtype)
        return t if self.operand is None else self.operand(t)

    @property
    def wide(self) -> torch.dtype:
        return torch.promote_types(self.dtype, torch.float32)


def fp8_operand(t: torch.Tensor) -> torch.Tensor:
    """``t`` rounded to float8 e4m3 with one scale for the whole tensor
    (its absolute maximum onto 448), returned in ``t``'s dtype: an fp8
    product's operand, emulated."""
    amax = t.detach().abs().amax().float().clamp_min(1e-30)
    scale = FP8_MAX / amax
    q = (t.float() * scale).to(torch.float8_e4m3fn).float()
    return (q / scale).to(t.dtype)


EXACT = Arith(torch.float32)
FP8 = Arith(torch.bfloat16, fp8_operand)


def conv(ar: Arith, x, w, b=None, stride=1, padding=0, dilation=1):
    return F.conv2d(ar.op(x), ar.op(w), None if b is None else b.to(ar.dtype),
                    stride, padding, dilation)


def conv_transpose(ar: Arith, x, w, stride, padding):
    """Transposed conv of an IOHW weight, no bias."""
    return F.conv_transpose2d(ar.op(x), ar.op(w), None, stride, padding)


def matmul(ar: Arith, a, b):
    """Batched ``a @ b`` of the rounded operands, summed in at least f32."""
    return torch.bmm(ar.op(a).to(ar.wide), ar.op(b).to(ar.wide))


_NORMS: list = [None]


@contextlib.contextmanager
def recording_norms():
    """Inside, each :func:`group_norm` appends to the list this yields its
    input's elements, bytes an element and whether it adds a residual."""
    _NORMS[0] = []
    try:
        yield _NORMS[0]
    finally:
        _NORMS[0] = None


def group_norm(ar: Arith, x, weight, bias, groups: int = 32, eps=1e-5,
               residual=None):
    """GroupNorm, then ``residual`` added where one is given (a residual
    block's last norm)."""
    x = x.to(ar.dtype)
    if _NORMS[0] is not None:
        _NORMS[0].append((x.numel(), x.element_size(), residual is not None))
    y = F.group_norm(x, groups, weight.to(ar.dtype), bias.to(ar.dtype), eps)
    return y if residual is None else y + residual


@contextlib.contextmanager
def exact_math():
    """TF32 off for cuBLAS and cuDNN inside (the reference's f32 is f32)."""
    old = (torch.backends.cuda.matmul.allow_tf32,
           torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = old


_CALIBRATING = [False]


@contextlib.contextmanager
def calibrating():
    """Inside, each :func:`batch_norm` first writes its input's batch
    statistics (mean, biased variance) into the state dict as its running
    statistics, as one training-mode pass would leave them."""
    _CALIBRATING[0] = True
    try:
        yield
    finally:
        _CALIBRATING[0] = False


def batch_norm(ar: Arith, x, sd: dict, name: str, eps=1e-5):
    """Eval-mode BatchNorm from the running statistics."""
    if _CALIBRATING[0]:
        var, mean = torch.var_mean(x.float(), dim=(0, 2, 3), correction=0)
        sd[name + ".running_mean"].copy_(mean)
        sd[name + ".running_var"].copy_(var)
    return F.batch_norm(x.to(ar.dtype), sd[name + ".running_mean"].to(ar.dtype),
                        sd[name + ".running_var"].to(ar.dtype),
                        sd[name + ".weight"].to(ar.dtype),
                        sd[name + ".bias"].to(ar.dtype), False, 0.0, eps)


def resize_bilinear(x, size):
    return F.interpolate(x, size=tuple(size), mode="bilinear",
                         align_corners=False)


def resize_nearest(x, size):
    """``src = floor(dst * in / out)``."""
    return F.interpolate(x, size=tuple(size), mode="nearest")


# -- preprocessing ------------------------------------------------------------

def edt_squared(seed: torch.Tensor) -> torch.Tensor:
    """Exact squared Euclidean distance to the nearest True pixel of
    ``seed`` (bool ``[..., H, W]``), f32; inf where there is none. Column
    distances from the nearest seed above and below, then for each row the
    lower envelope ``min_d g2[j + d] + d^2``, over offsets until no output
    can still fall."""
    h, w = seed.shape[-2:]
    dev = seed.device
    rows = torch.arange(h, device=dev).view(h, 1).expand(seed.shape)
    far = 4 * (h + w)
    above = torch.where(seed, rows, -far).cummax(dim=-2).values
    below = torch.where(seed, rows, 2 * far).flip(-2).cummin(
        dim=-2).values.flip(-2)
    g = torch.minimum(rows - above, below - rows).float()
    g2 = torch.where(g >= far, torch.inf, g * g)
    g2 = g2.reshape(-1, w)
    acc = g2.clone()
    live = torch.isfinite(g2).any(-1)
    pad = F.pad(g2, (w, w), value=torch.inf)
    for d in range(1, w):
        if d % 16 == 1:
            top = acc[live].max() if bool(live.any()) else torch.tensor(0.0)
            if d * d >= top.item():
                break
        shifted = torch.minimum(pad[:, w - d:2 * w - d], pad[:, w + d:2 * w + d])
        torch.minimum(acc, shifted + float(d * d), out=acc)
    return acc.reshape(seed.shape)


def trimap_transform(trimap2: torch.Tensor, length: float = 320.0):
    """FBA's 6-channel Gaussian distance encoding of the binary (bg, fg)
    maps ``[..., H, W, 2]``: ``exp(-d2 / (2 (s L)^2))`` for s in (0.02,
    0.08, 0.16), per input channel."""
    d2 = edt_squared((trimap2 >= 0.5).movedim(-1, 0))
    outs = [torch.exp(-d2[k] / (2.0 * (s * length) ** 2))
            for k in range(2) for s in (0.02, 0.08, 0.16)]
    return torch.stack(outs, dim=-1)


def preprocess(img_u8: torch.Tensor, tri_u8: torch.Tensor,
               trimap_channels: int) -> dict:
    """The eval preprocessing in f32, channels last: the RGB image scaled
    to [0, 1] (``scaled``) and normalized (``imgs``), the trimap encoding
    (``tris``: 3-channel one-hot, or FBA's 8 channels), the unknown mask
    ``trimask`` (0 < trimap < 255)."""
    scale = torch.tensor(IMG_SCALE, dtype=torch.float32)
    scaled = img_u8.float().flip(-1) * scale
    mean = torch.tensor(IMG_MEAN, device=img_u8.device)
    std = torch.tensor(IMG_STD, device=img_u8.device)
    imgs = (scaled - mean) / std
    s = tri_u8.float() * scale
    trimask = ((s > 0) & (s < 1)).float()
    if trimap_channels == 3:
        cls = torch.where(trimask > 0.5, 1.0, 2.0 * s).long()
        tris = F.one_hot(cls[..., 0], 3).float()
    elif trimap_channels == 8:
        tri2 = torch.cat([(s == 0.0).float(), (s == 1.0).float()], dim=-1)
        tris = torch.cat([trimap_transform(tri2), tri2], dim=-1)
    else:
        raise ValueError(f"no eval encoding of {trimap_channels} channels")
    return dict(scaled=scaled, imgs=imgs, tris=tris, trimask=trimask)


def nchw(t: torch.Tensor) -> torch.Tensor:
    return t.permute(0, 3, 1, 2)


# -- FAM ----------------------------------------------------------------------

def fam_attention(ar: Arith, q, k, mask, window: int):
    """Masked window attention, NCHW: each pixel of ``q`` against the keys
    of ``k`` in the ``window`` x ``window`` neighbourhood (out of frame:
    zero keys, logit 0, kept in the softmax); the result is the softmax
    weighted sum of those keys, zero where ``mask`` is 0."""
    n, c, h, w = q.shape
    r = window // 2
    qf = ar.op(q).to(ar.wide)
    kp = F.pad(ar.op(k).to(ar.wide), (r, r, r, r))
    shifts = [(dy, dx) for dy in range(window) for dx in range(window)]
    logits = torch.stack([(qf * kp[:, :, dy:dy + h, dx:dx + w]).sum(1)
                          for dy, dx in shifts], 1) / math.sqrt(c)
    att = ar.op(torch.softmax(logits, dim=1)).to(ar.wide)
    out = torch.zeros_like(qf)
    for p, (dy, dx) in enumerate(shifts):
        out += att[:, p:p + 1] * kp[:, :, dy:dy + h, dx:dx + w]
    return out * mask.to(ar.wide)


def fam_aggregate(ar: Arith, sd: dict, window: int, q, v, k_prev, k_next,
                  trimask):
    """The FAM output: ``v`` plus both neighbours' attentions, over the
    unknown mask at the features' grid."""
    small = (resize_nearest(trimask, q.shape[-2:]) > 0.5).float()
    return (v.to(ar.wide) + fam_attention(ar, q, k_prev, small, window)
            + fam_attention(ar, q, k_next, small, window))


def fam_projections(ar: Arith, sd: dict, feat):
    """The FAM's q, k, v 3x3 convs of the OS-8 features."""
    p = "decoder.fam."
    return tuple(conv(ar, feat, sd[f"{p}{n}_conv.weight"],
                      sd[f"{p}{n}_conv.bias"], padding=1)
                 for n in ("query", "key", "value"))


# -- paste and quantize -----------------------------------------------------------

def paste_quantize(alpha: torch.Tensor, tri_u8: torch.Tensor) -> torch.Tensor:
    """uint8 ``[N, H, W]`` mattes: ``floor(clamp(alpha) * 255)`` in the
    trimap's unknown pixels, the trimap itself elsewhere."""
    s = tri_u8[..., 0].float() * torch.tensor(IMG_SCALE, dtype=torch.float32)
    known = torch.floor(torch.clamp(s, 0.0, 1.0) * 255.0).to(torch.uint8)
    a8 = torch.floor(torch.clamp(alpha[:, 0].float(), 0.0, 1.0)
                     * 255.0).to(torch.uint8)
    return torch.where((s > 0.0) & (s < 1.0), a8, known)
