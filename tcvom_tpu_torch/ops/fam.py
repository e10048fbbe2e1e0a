"""TAM/FAM windowed cross-frame attention (port of tcvom_tpu/ops/fam.py).

  logits[b, y, x, p] = <q[b,y,x,:], k[b, y+dy(p), x+dx(p), :]> / sqrt(C)
  att = softmax_p(logits)
  out[b, y, x, :] = mask[b,y,x] * sum_p att[p] * k[b, y+dy, x+dx, :]

Neighbours outside the frame are zero vectors, so their logit is exactly 0
and they stay in the softmax (F.unfold's zero padding). The weighted sum is
of k, not of a value tensor. Patch index p is row-major over (dy, dx).
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from tcvom_tpu_torch.ops import fam_kernel
from tcvom_tpu_torch.parallel import space


def _shifts(window: int):
    r = window // 2
    for dy in range(-r, r + 1):
        for dx in range(-r, r + 1):
            yield dy, dx


def fam_attention_ref(q: torch.Tensor, k: torch.Tensor, mask: torch.Tensor,
                      window: int) -> tuple[torch.Tensor, torch.Tensor]:
    """Plain dense masked attention. q, k: ``[B, H, W, C]``; mask:
    ``[B, H, W, 1]`` in {0, 1}. Returns ``(out [B, H, W, C], logits
    [B, H, W, window^2])``, both zeroed outside the mask and in q's dtype.
    Computed in f32 (f64 for f64 inputs), as the kernel accumulates."""
    b, h, w, c = q.shape
    r = window // 2
    scale = 1.0 / math.sqrt(c)
    wide = torch.promote_types(q.dtype, torch.float32)
    qf, m = q.to(wide), mask.to(wide)
    kp = F.pad(k.to(wide), (0, 0, r, r, r, r))
    shifted = [kp[:, r + dy:r + dy + h, r + dx:r + dx + w]
               for dy, dx in _shifts(window)]
    logits = torch.stack([(qf * ks).sum(-1) * scale for ks in shifted], -1)
    att = torch.softmax(logits, dim=-1)
    out = torch.zeros_like(qf)
    for p, ks in enumerate(shifted):
        out += att[..., p:p + 1] * ks
    return (out * m).to(q.dtype), (logits * m).to(q.dtype)


class FamAttention(torch.autograd.Function):
    """Differentiable FAM with both outputs: the forward is ``forward`` (by
    default the logits-writing CUDA kernel,
    :func:`~tcvom_tpu_torch.ops.fam_kernel.fam_window_logits`); the
    backward is the VJP of :func:`fam_attention_ref`, recomputed, with both
    cotangents (d_out, d_logits), as the JAX package's ``custom_vjp`` does
    (tcvom_tpu/ops/fam_pallas.py::_bwd). The mask gets no gradient.

    ``FamAttention.apply(q, k, mask, window[, forward])``; a test passes
    ``forward=fam_attention_ref`` to run the backward without a card."""

    @staticmethod
    def forward(ctx, q, k, mask, window, forward=None):
        fwd = forward or fam_kernel.fam_window_logits
        out, logits = fwd(q, k, mask, window)
        ctx.save_for_backward(q, k, mask)
        ctx.window = window
        return out, logits

    @staticmethod
    def backward(ctx, d_out, d_logits):
        q, k, mask = ctx.saved_tensors
        with torch.enable_grad():
            q_, k_ = q.detach().requires_grad_(), k.detach().requires_grad_()
            out, logits = fam_attention_ref(q_, k_, mask, ctx.window)
            dq, dk = torch.autograd.grad((out, logits), (q_, k_),
                                         (d_out, d_logits))
        return dq, dk, None, None, None


def fam_attention(q: torch.Tensor, k: torch.Tensor, mask: torch.Tensor,
                  window: int, need_logits: bool = False
                  ) -> tuple[torch.Tensor, torch.Tensor | None]:
    """Dispatch: the plain version for CPU tensors; on the card the
    logits-writing kernel through :class:`FamAttention` when the logits are
    needed or a gradient must flow to q or k, else the inference kernel
    (``csrc/fam_window.cu`` for both). Returns ``(out, logits)``; logits is
    None unless ``need_logits``.

    In band mode (``parallel.space``; ``[B, h, W, .]`` this rank's band)
    the kernel, which reads keys outside its array as logit 0, is given
    the band and ``window // 2`` more rows below it and ``window // 2``
    rounded up to even above it (on its inner sides): k's are the
    neighbouring band's real rows, q's and the mask's zeros (their outputs
    are cropped); at the frame's edges nothing is added, and the kernel's
    own zero keys apply. The even top keeps each row's parity, which sets
    the order of its sums in the kernel's tiles of two rows a warp
    (``csrc/fam_window.cu``). The output and logits are cropped back to
    the band: bit for bit the rows of the call on the whole frame."""
    bands = space.current()
    if bands is None:
        return _dispatch(q, k, mask, window, need_logits)
    r, h = window // 2, q.shape[1]
    lo, hi, height = bands.span(h)
    above = r + r % 2
    top, bottom = above * (lo > 0), r * (hi < height)
    k = bands.rows(k.movedim(1, 2), lo - above, hi + r).movedim(2, 1)
    k = k[:, above - top:above + h + bottom].contiguous()
    q, mask = (F.pad(t, (0, 0, 0, 0, top, bottom)) for t in (q, mask))
    out, logits = _dispatch(q, k, mask, window, need_logits)
    return (out[:, top:top + h],
            None if logits is None else logits[:, top:top + h])


def _dispatch(q: torch.Tensor, k: torch.Tensor, mask: torch.Tensor,
              window: int, need_logits: bool
              ) -> tuple[torch.Tensor, torch.Tensor | None]:
    """:func:`fam_attention` on whole frames."""
    if q.device.type == "cpu":
        out, logits = fam_attention_ref(q, k, mask, window)
        return out, (logits if need_logits else None)
    if need_logits or (torch.is_grad_enabled()
                       and (q.requires_grad or k.requires_grad)):
        out, logits = FamAttention.apply(q, k, mask, window)
        return out, (logits if need_logits else None)
    return fam_kernel.fam_window(q, k, mask, window), None
