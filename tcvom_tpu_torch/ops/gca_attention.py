"""Guided contextual attention core (port of tcvom_tpu/ops/gca_attention.py).

The JAX package computes it as two batched einsums that XLA lowers to
matmuls; here they are two ``torch.bmm`` calls:

  corr[b, p, n] = <win_p(f_b), patch_n(f_b) / max(||patch_n||, 1e-4)>
                  (``[B, hw, 9*Cf] x [B, 9*Cf, N]``)
  out = overlap_add(att @ alpha_patches) / 4
                  (``[B, 16*Ca, N] x [B, N, hw]``, att = softmax_n(corr))

with N = hw: the 3x3 window of f at each position is the same tensor as
the patch bank (reflect padding 1 on both sides). Tensors are NCHW; the
patches are ``F.unfold``'s ``[B, C*k*k, N]``, channel-major, and the
overlap-add is ``F.fold`` (the JAX package's ``overlap_add_stride2_k4``).

Precision. The patch norms, the scales ``s_un`` and ``s_kn``, the scaled
and masked logits and the softmax are in at least f32, as the JAX
package's ``preferred_element_type=f32`` asks. The correlation's inputs
are the guidance features and the normalized bank in the features' dtype
(bf16 in the bf16 stream); the reconstruction's are alpha's patches and
the softmax weights rounded to alpha's dtype. Both products accumulate in
f32 and return f32 (:func:`_bmm_f32`). (In the JAX package the
reconstruction's einsum promotes its bf16 patches to the f32 weights'
type; a TPU runs such an f32 matmul at its default precision as one bf16
pass.)

The self-correlation mask is not built: ``-1e4 * mm[n]`` is added on the
correlation's diagonal, the same function without the JAX package's
``[hw, N]`` one-hot (266 MB at 1088x1920).
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from tcvom_tpu_torch.models.layers import at_least_f32


def extract_patches_reflect(x: torch.Tensor, kernel: int,
                            stride: int) -> torch.Tensor:
    """The reference's ``extract_patches`` (models/GCA/ops.py:231-238):
    reflect pad ``[B, C, H, W]`` with left = (k-s+1)//2, right = (k-s)//2,
    then ``kernel``x``kernel`` patches at ``stride``. Returns
    ``[B, C*k*k, N]`` (``F.unfold``'s order: channel, then row-major
    position in the patch), N = (H/stride)*(W/stride), row-major."""
    left, right = (kernel - stride + 1) // 2, (kernel - stride) // 2
    xp = F.pad(x, (left, right, left, right), mode="reflect")
    return F.unfold(xp, kernel, stride=stride)


def overlap_add_stride2_k4(z: torch.Tensor, hw: tuple[int, int]
                           ) -> torch.Tensor:
    """``conv_transpose2d(stride=2, kernel=4, padding=1)`` as an overlap-add
    of per-position 4x4 contributions ``z`` ``[B, C*16, h*w]`` (``F.fold``'s
    layout, channel-major) on the grid ``hw`` = (h, w): ``[B, C, 2h, 2w]``,
    ``out[2a] = z[a, u=1] + z[a-1, u=3]``, ``out[2a+1] = z[a, u=2] +
    z[a+1, u=0]``, likewise along w."""
    h, w = hw
    return F.fold(z, (2 * h, 2 * w), 4, stride=2, padding=1)


def _bmm_f32(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """``a @ b`` accumulated and returned in at least f32, the inputs in
    their own dtype: cuBLAS's f32 output of a bf16 product on the card;
    elsewhere the inputs are widened first (each product of two bf16
    values is exact in f32, so only the summation order differs)."""
    if a.dtype in (torch.float32, torch.float64):
        return torch.bmm(a, b)
    if a.is_cuda:
        return torch.bmm(a, b, out_dtype=torch.float32)
    return torch.bmm(a.float(), b.float())


def guided_attention_core(f_down: torch.Tensor, alpha: torch.Tensor,
                          unknown_down: torch.Tensor,
                          softmax_scale: float = 1.0,
                          has_unknown: bool = True) -> torch.Tensor:
    """The correlate -> softmax -> reconstruct pipeline.

    ``f_down`` ``[B, Cf, h, w]``: guidance features at half alpha's
    resolution; ``alpha`` ``[B, Ca, 2h, 2w]``: the features to reconstruct
    from; ``unknown_down`` ``[B, 1, h, w]``: the unknown region at the
    guidance resolution (read only with ``has_unknown``). Returns the
    reconstruction ``[B, Ca, 2h, 2w]`` in f32 (f64 for f64 inputs)."""
    b, _, h, w = f_down.shape
    x = extract_patches_reflect(f_down, 3, 1)                 # [B, 9Cf, N]
    norm = torch.linalg.vector_norm(at_least_f32(x), dim=1, keepdim=True)
    bank = (at_least_f32(x) / norm.clamp_min(1e-4)).to(x.dtype)
    corr = _bmm_f32(x.transpose(1, 2), bank)                  # [B, hw, N]

    if has_unknown:
        # per-patch unknown-ness and the global scales (ops.py:135-156)
        unk = at_least_f32(unknown_down)
        um = unk.mean(dim=(1, 2, 3))                                 # [B]
        km = 1.0 - um
        s_un = torch.sqrt(um / km.clamp_min(1e-12)).clamp(0.1, 10.0)
        s_kn = torch.sqrt(km / um.clamp_min(1e-12)).clamp(0.1, 10.0)
        mm = (extract_patches_reflect(unk, 3, 1).mean(dim=1) > 0
              ).to(corr.dtype)                                      # [B, N]
        scale = s_un[:, None] * mm + s_kn[:, None] * (1.0 - mm)
    else:
        mm = corr.new_ones((b, h * w))
        scale = torch.full_like(mm, softmax_scale)
    corr.mul_(scale[:, None, :])
    # the self-correlation mask, on the unknown patches only
    corr.diagonal(dim1=1, dim2=2).add_(mm, alpha=-1e4)
    att = torch.softmax(corr, dim=-1)
    del corr

    apat = extract_patches_reflect(alpha, 4, 2)              # [B, 16Ca, N]
    z = _bmm_f32(apat, att.to(alpha.dtype).transpose(1, 2))  # [B, 16Ca, hw]
    return overlap_add_stride2_k4(z, (h, w)) / 4.0
